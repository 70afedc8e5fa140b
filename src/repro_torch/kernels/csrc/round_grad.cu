// Masked round gradient  g = X^T (w * (X beta - y))  for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/round_grad/round_grad.py::masked_round_gradient
//   (body _masked_kernel -> _accumulate, pallas_call at line 94),
// the per-epoch hot loop of every strategy on the fused gradient path.
//
// What bounds it on this card: bytes.  The work is 4*M*D flops over an
// (M, D) float32 matrix read once, about 1 flop per byte, far below the
// H100's ~20 flops/byte balance point for float32 outside the tensor
// cores.  At the paper's shapes (M = 5632 packed or 7200 rows, D = 500)
// X is 11.3 / 14.4 MB; the least time is those bytes over 3.35 TB/s.
//
// What the design does about it:
//   * X is read from device memory exactly once.  Each CTA owns a
//     contiguous range of kRowsPerCta rows and walks it in tiles of
//     kTileRows rows.  A tile (contiguous in row-major X) is staged in
//     shared memory with coalesced loads; each warp forms one row's
//     residual with a warp-level dot over D; then every thread adds
//     w*r*x for its own columns of the tile into the CTA's D-wide partial
//     (also in shared memory), so the second use of the tile never goes
//     back to device memory.  The (M,) residual never exists in memory.
//   * Hopper runs CTAs concurrently and in no order, while the TPU grid
//     accumulated sequentially.  Instead of atomics, each CTA writes its
//     (D,) partial to a (n_ctas, D) scratch and a second launch sums the
//     partials in a fixed order: for each column, warp k of the reducing
//     CTA sums partials k, k+8, k+16, ... in turn, then the eight warp
//     sums are added in warp order.  Both partitions depend only on M and
//     D, so two launches on the same inputs are bit-identical.
//   * Many small CTAs (16 rows each, several resident per SM) keep enough
//     loads in flight to cover memory latency without a software
//     pipeline, and the reduce spreads each column over eight warps so no
//     thread walks a long chain of dependent loads.
//   * Ragged edges (M not a multiple of the tile) are masked in the
//     kernel; nothing is padded on the host.  w == nullptr means w = 1.
//
// A simple kernel that is right comes first: no cp.async/TMA pipeline.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_api.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kWarps;   // one row per warp per tile
constexpr int kRowsPerCta = 16;     // two tiles per CTA
constexpr int kReduceCols = 32;     // columns per reducing CTA, one per lane
constexpr int kReduceWarps = 8;     // partial slices per reducing CTA

__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ w, const float* __restrict__ beta,
               float* __restrict__ partials, int m, int d) {
  extern __shared__ float smem[];
  float* s_beta = smem;             // (d,)
  float* s_acc = s_beta + d;        // (d,) this CTA's partial
  float* s_tile = s_acc + d;        // (kTileRows, d)
  __shared__ float s_coef[kTileRows];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int c = tid; c < d; c += kThreads) {
    s_beta[c] = beta[c];
    s_acc[c] = 0.f;
  }
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerCta;
  const int64_t row_end = min(static_cast<int64_t>(m), row0 + kRowsPerCta);

  for (int64_t t0 = row0; t0 < row_end; t0 += kTileRows) {
    const int rows = static_cast<int>(min(static_cast<int64_t>(kTileRows),
                                          row_end - t0));
    __syncthreads();  // the previous tile is consumed; s_beta is ready
    const float* src = x + t0 * d;
    const int n = rows * d;
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads) s_tile[i] = src[i];
    __syncthreads();

    if (warp < rows) {
      const float* xr = s_tile + warp * d;
      float dot = 0.f;
      for (int c = lane; c < d; c += 32) dot = fmaf(xr[c], s_beta[c], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const int64_t r = t0 + warp;
        const float wt = (w != nullptr) ? w[r] : 1.f;
        s_coef[warp] = (dot - y[r]) * wt;
      }
    }
    __syncthreads();

    // each thread owns columns tid, tid + kThreads, ...: no races
    for (int c = tid; c < d; c += kThreads) {
      float acc = s_acc[c];
      for (int r = 0; r < rows; ++r) acc = fmaf(s_coef[r], s_tile[r * d + c], acc);
      s_acc[c] = acc;
    }
  }
  float* dst = partials + static_cast<int64_t>(blockIdx.x) * d;
  for (int c = tid; c < d; c += kThreads) dst[c] = s_acc[c];
}

// out[c] = sum over k = 0..7 in order of (sum over p = k, k+8, ... in
// order of partials[p, c]): a fixed order that depends only on n_parts.
__global__ void __launch_bounds__(kReduceCols * kReduceWarps)
reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
              int n_parts, int d) {
  __shared__ float s_sum[kReduceWarps][kReduceCols];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * kReduceCols + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int p = warp; p < n_parts; p += kReduceWarps)
      s += partials[static_cast<int64_t>(p) * d + c];
  }
  s_sum[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceWarps; ++k) t += s_sum[k][lane];
    out[c] = t;
  }
}

}  // namespace

extern "C" {

// Rows of the (n_ctas, D) partials scratch the caller allocates.
int rg_num_ctas(int m) { return (m + kRowsPerCta - 1) / kRowsPerCta; }

// Largest D whose shared-memory footprint fits one CTA (227 KB).
int rg_max_d() { return (232448 / static_cast<int>(sizeof(float))) / (2 + kTileRows); }

// x (m, d), y (m,), w (m,) or nullptr, beta (d,), partials (n_ctas, d),
// out (d,): all float32, contiguous, on the device of `stream`.
int rg_masked_round_gradient(const float* x, const float* y, const float* w,
                             const float* beta, float* partials, float* out,
                             int m, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ctas = rg_num_ctas(m);
  if (n_ctas > 0) {
    const size_t smem = static_cast<size_t>(2 + kTileRows) * d * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    partial_kernel<<<n_ctas, kThreads, smem, s>>>(x, y, w, beta, partials, m, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  reduce_kernel<<<(d + kReduceCols - 1) / kReduceCols,
                  kReduceCols * kReduceWarps, 0, s>>>(partials, out, n_ctas, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
