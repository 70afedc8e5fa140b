// The C entry point every kernel library shares: the message of a CUDA
// error code that one of its launch functions returned.  Each library is
// one translation unit, so each holds one copy.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
