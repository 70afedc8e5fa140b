// Weighted parity encoding  P = G diag(w) X  for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/encode/encode.py::encode_parity
//   (body _kernel, pallas_call at line 79),
// the one-time client encoding of CFL (paper Eq. 9): each client's
// private generator G (C, L) times its Eq.-17-weighted data with the
// labels riding along as the last column of X (L, D).
//
// What bounds it on this card: operations.  At the paper's shapes
// (C = 2016, L = 300, D = 501) one call is 2*C*L*D = 0.61 GFLOP against
// 7.5 MB of operands: about 80 flops per byte, well above the float32
// balance point.  It must stay in full float32 (the reference holds the
// encode at 2e-4 * max|ref|; TF32 keeps about three digits), so the
// bound is the card's float32 rate outside the tensor cores.
//
// What the design does about it:
//   * A shared-memory-tiled float32 GEMM: each 256-thread CTA computes a
//     64 x 64 output tile, each thread a 4 x 4 register block, walking
//     L in steps of 16 with both operand tiles staged in shared memory,
//     so every loaded element feeds 64 fused multiply-adds.  The next
//     step's tiles are loaded into registers while the current step's
//     products run, so the loads' latency overlaps the arithmetic.
//   * The diagonal weighting is applied as the X tile is loaded
//     (w[k] * x[k, n] goes straight into shared memory), so diag(w) X
//     never exists in device memory: the one thing the TPU kernel fuses.
//   * Ragged edges in C, L and D are masked in the loads and the store;
//     nothing is padded on the host.  Each output is one fma chain over
//     L in increasing order, so results are deterministic.
//
// A simple kernel that is right comes first: no wgmma (float32 has no
// full-precision tensor-core path), no TMA, no multi-stage pipeline.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_api.cuh"

namespace {

constexpr int kBM = 64;   // output rows per CTA (C axis)
constexpr int kBN = 64;   // output columns per CTA (D axis)
constexpr int kBK = 16;   // contraction step (L axis)
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 4;    // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kGLoads = kBM * kBK / kThreads;        // G elements per thread
constexpr int kXLoads = kBK * kBN / kThreads;        // X elements per thread

// Load step k0's G tile and (w * X) tile into per-thread registers;
// element t of thread tid is flat index tid + t * kThreads of the tile.
// Neighbouring threads read neighbouring addresses along a row.
__device__ __forceinline__ void load_tiles(
    const float* __restrict__ g, const float* __restrict__ w,
    const float* __restrict__ x, int c, int l, int d, int row0, int col0,
    int k0, int tid, float (&g_reg)[kGLoads], float (&x_reg)[kXLoads]) {
#pragma unroll
  for (int t = 0; t < kGLoads; ++t) {
    const int i = tid + t * kThreads;
    const int gr = row0 + i / kBK, gk = k0 + i % kBK;
    g_reg[t] = (gr < c && gk < l) ? g[static_cast<int64_t>(gr) * l + gk] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < kXLoads; ++t) {
    const int i = tid + t * kThreads;
    const int gk = k0 + i / kBN, gn = col0 + i % kBN;
    x_reg[t] = (gk < l && gn < d)
                   ? w[gk] * x[static_cast<int64_t>(gk) * d + gn] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ g, const float* __restrict__ w,
              const float* __restrict__ x, float* __restrict__ out,
              int c, int l, int d) {
  __shared__ float s_g[kBK][kBM + 1];  // G tile, transposed; +1 avoids bank conflicts
  __shared__ float s_x[kBK][kBN];      // (w * X) tile

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float g_reg[kGLoads], x_reg[kXLoads];
  load_tiles(g, w, x, c, l, d, row0, col0, 0, tid, g_reg, x_reg);
  for (int k0 = 0; k0 < l; k0 += kBK) {
#pragma unroll
    for (int t = 0; t < kGLoads; ++t) {
      const int i = tid + t * kThreads;
      s_g[i % kBK][i / kBK] = g_reg[t];
    }
#pragma unroll
    for (int t = 0; t < kXLoads; ++t) {
      const int i = tid + t * kThreads;
      s_x[i / kBN][i % kBN] = x_reg[t];
    }
    __syncthreads();
    if (k0 + kBK < l)  // the next step's loads overlap this step's products
      load_tiles(g, w, x, c, l, d, row0, col0, k0 + kBK, tid, g_reg, x_reg);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = s_g[k][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = s_x[k][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= c) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = col0 + tx * kTN + j;
      if (n < d) out[static_cast<int64_t>(r) * d + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// g (c, l), w (l,), x (l, d), out (c, d): float32, contiguous, on the
// device of `stream`.  c, l, d > 0.
int enc_encode_parity(const float* g, const float* w, const float* x,
                      float* out, int c, int l, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kBN - 1) / kBN, (c + kBM - 1) / kBM);
  encode_kernel<<<grid, kThreads, 0, s>>>(g, w, x, out, c, l, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
