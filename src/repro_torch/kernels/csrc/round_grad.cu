// Round gradients g = X^T (w * (X beta - y)) for NVIDIA Hopper (sm_90a):
// the flat, coded (two-stream) and tier-masked variants.
//
// Replaces the Pallas TPU kernels of
//   src/repro/kernels/round_grad/round_grad.py:
//     masked_round_gradient       (_masked_kernel, pallas_call at line 94),
//     coded_round_gradient        (_coded_kernel,  pallas_call at line 154),
//     tier_masked_round_gradient  (_tier_kernel,   pallas_call at line 209),
// the per-epoch hot loop of every strategy on the fused gradient path:
// the flat one for UncodedFL/CodedFL, the coded one for StochasticCodedFL
// at sample_frac < 1 (systematic and parity rows in one launch), the
// tiered one for HierarchicalCFL (T tier partials from one pass over X).
//
// What bounds them on this card: bytes.  The work is about 4*M*D flops
// (4*M*D*T for T tiers) over an (M, D) float32 matrix read once, about
// one flop per byte (T at most a few), far below the H100's ~20 flops per
// byte balance point for float32 outside the tensor cores.  At the
// paper's shapes (M = 5632 packed or 7200 rows, plus 2016 parity rows
// for the coded variant, D = 500) the least time is those bytes over
// 3.35 TB/s.
//
// What the design does about it:
//   * X is read from device memory exactly once (once per chunk of tiers
//     when T tiers' partials do not fit shared memory together).  Each
//     CTA owns a contiguous range of kRowsPerCta rows and walks it in
//     tiles of kTileRows rows.  A tile (contiguous in row-major X) is
//     staged in shared memory with coalesced loads; each warp forms one
//     row's residual with a warp-level dot over D; then every thread adds
//     coef*x for its own columns of the tile into the CTA's D-wide
//     partials (one per tier, in shared memory), so the tile is reused
//     from shared memory for every tier.  The (M,) residual never exists
//     in memory.
//   * Hopper runs CTAs concurrently and in no order, while the TPU grid
//     accumulated sequentially.  Instead of atomics, each CTA writes its
//     (D,) partials to a (T, n_ctas, D) scratch and a second launch sums
//     each tier's partials in a fixed order: for each column, warp k of
//     the reducing CTA sums partials k, k+8, k+16, ... in turn, then the
//     eight warp sums are added in warp order.  Both partitions depend
//     only on the shapes, so two launches on the same inputs are
//     bit-identical.
//   * One device body (`accumulate_rows`) serves all three variants with
//     the same CTA row ranges and the same reduce.  The flat gradient IS
//     the tier kernel's one-tier instance with no mask (mask value 1.0f),
//     and the tier kernel at T = 1 launches that same instance, so with
//     an all-ones mask it computes coef * 1.0f, which is exact: the
//     single-tier hierarchy is bit-equal to the flat path by
//     construction.  The one-tier instance fixes its tier count at compile
//     time; every other tier count is taken at run time.
//   * The coded variant launches CTAs over the concatenated row range:
//     the first ceil(M / kRowsPerCta) own systematic rows, the rest
//     parity rows, so no CTA straddles the two blocks; both blocks'
//     partials are summed by the one fixed-order reduce.
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
constexpr int kSmemBytes = 232448;  // the most one CTA may use (227 KB)

int ctas_for(int rows) { return (rows + kRowsPerCta - 1) / kRowsPerCta; }

// Dynamic shared memory of one CTA with `nt` tier partials of width d:
// beta (d), the partials (nt*d), the tile (kTileRows*d), the row
// coefficients (nt*kTileRows).
size_t smem_bytes(int d, int nt) {
  return (static_cast<size_t>(1 + nt + kTileRows) * d +
          static_cast<size_t>(nt) * kTileRows) * sizeof(float);
}

// Adds rows [row0, row_end) of (x, y, w) into `nt` partials, the t-th
// scaled by row mask masks[t * mask_stride + row] (masks == nullptr: one
// partial, mask 1.0f), and writes partial t to dst + t * dst_stride.
// kNt > 0 fixes the tier count at compile time (nt == kNt), so the one-
// tier loops unroll; kNt == 0 takes nt at run time.  The
// arithmetic of each tier is the same in every instance.
template <int kNt>
__device__ __forceinline__ void accumulate_rows(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ masks,
    int64_t mask_stride, int nt, const float* __restrict__ beta,
    int64_t row0, int64_t row_end, int d, float* __restrict__ dst,
    int64_t dst_stride) {
  if (kNt > 0) nt = kNt;
  extern __shared__ float smem[];
  float* s_beta = smem;                       // (d,)
  float* s_acc = s_beta + d;                  // (nt, d) this CTA's partials
  float* s_tile = s_acc + nt * d;             // (kTileRows, d)
  float* s_coef = s_tile + kTileRows * d;     // (nt, kTileRows)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // each thread owns columns tid, tid + kThreads, ... of every partial
  for (int c = tid; c < d; c += kThreads) {
    s_beta[c] = beta[c];
    for (int t = 0; t < nt; ++t) s_acc[t * d + c] = 0.f;
  }

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
      if (lane < nt) {
        const int64_t r = t0 + warp;
        const float coef = (dot - y[r]) * ((w != nullptr) ? w[r] : 1.f);
        // lanes split the tiers; each writes coef * mask (exact at 1.0f)
        for (int t = lane; t < nt; t += 32) {
          const float mk =
              (masks != nullptr) ? masks[t * mask_stride + r] : 1.f;
          s_coef[t * kTileRows + warp] = coef * mk;
        }
      }
    }
    __syncthreads();

    // the tile is re-read from shared memory for each tier
    for (int c = tid; c < d; c += kThreads) {
      for (int t = 0; t < nt; ++t) {
        const float* coef = s_coef + t * kTileRows;
        float acc = s_acc[t * d + c];
        for (int r = 0; r < rows; ++r)
          acc = fmaf(coef[r], s_tile[r * d + c], acc);
        s_acc[t * d + c] = acc;
      }
    }
  }
  for (int c = tid; c < d; c += kThreads)
    for (int t = 0; t < nt; ++t) dst[t * dst_stride + c] = s_acc[t * d + c];
}

// Flat and tiered: CTA b owns rows [b * kRowsPerCta, ...) of x and writes
// tier t's partial to partials[(t * n_ctas + b) * d].
template <int kNt>
__global__ void __launch_bounds__(kThreads)
tier_partial_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ w,
                    const float* __restrict__ masks, int nt,
                    const float* __restrict__ beta,
                    float* __restrict__ partials, int m, int d) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerCta;
  const int64_t row_end = min(static_cast<int64_t>(m), row0 + kRowsPerCta);
  accumulate_rows<kNt>(x, y, w, masks, m, nt, beta, row0, row_end, d,
                       partials + static_cast<int64_t>(blockIdx.x) * d,
                       static_cast<int64_t>(gridDim.x) * d);
}

// Coded: CTAs [0, n_sys) own systematic rows, the rest parity rows; CTA b
// writes its partial to partials[b * d].
__global__ void __launch_bounds__(kThreads)
coded_partial_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ w, int m,
                     const float* __restrict__ xp,
                     const float* __restrict__ yp,
                     const float* __restrict__ wp, int c,
                     const float* __restrict__ beta,
                     float* __restrict__ partials, int d) {
  const int n_sys = (m + kRowsPerCta - 1) / kRowsPerCta;
  const int b = blockIdx.x;
  const bool sys = b < n_sys;
  const int rows = sys ? m : c;
  const int64_t row0 = static_cast<int64_t>(sys ? b : b - n_sys) * kRowsPerCta;
  const int64_t row_end = min(static_cast<int64_t>(rows), row0 + kRowsPerCta);
  accumulate_rows<1>(sys ? x : xp, sys ? y : yp, sys ? w : wp, nullptr, 0,
                     1, beta, row0, row_end, d,
                     partials + static_cast<int64_t>(b) * d, 0);
}

// out[t, c] = sum over k = 0..7 in order of (sum over p = k, k+8, ... in
// order of partials[t, p, c]): a fixed order that depends only on n_parts.
__global__ void __launch_bounds__(kReduceCols * kReduceWarps)
reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
              int n_parts, int d) {
  __shared__ float s_sum[kReduceWarps][kReduceCols];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * kReduceCols + lane;
  partials += static_cast<int64_t>(blockIdx.y) * n_parts * d;
  out += static_cast<int64_t>(blockIdx.y) * d;
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kNt>
cudaError_t launch_tiers(const float* x, const float* y, const float* w,
                         const float* masks, int nt, const float* beta,
                         float* partials, int m, int d, int n_ctas,
                         cudaStream_t s) {
  const size_t smem = smem_bytes(d, nt);
  cudaError_t e = allow_smem(tier_partial_kernel<kNt>, smem);
  if (e != cudaSuccess) return e;
  tier_partial_kernel<kNt><<<n_ctas, kThreads, smem, s>>>(
      x, y, w, masks, nt, beta, partials, m, d);
  return cudaGetLastError();
}

cudaError_t reduce(const float* partials, float* out, int n_parts, int d,
                   int nt, cudaStream_t s) {
  dim3 grid((d + kReduceCols - 1) / kReduceCols, nt);
  reduce_kernel<<<grid, kReduceCols * kReduceWarps, 0, s>>>(partials, out,
                                                             n_parts, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the (n_ctas, D) partials scratch of the flat and tiered
// variants (per tier); the coded variant needs rg_num_ctas(m) +
// rg_num_ctas(c).
int rg_num_ctas(int m) { return ctas_for(m); }

// Largest D whose one-partial shared-memory footprint fits one CTA.
int rg_max_d() {
  return (kSmemBytes / static_cast<int>(sizeof(float)) - kTileRows) /
         (2 + kTileRows);
}

// Most tier partials of width d one CTA holds at once; more tiers run in
// chunks of this many, each chunk a pass over X.
int rg_max_tiers(int d) {
  return (kSmemBytes / static_cast<int>(sizeof(float)) -
          (1 + kTileRows) * d) / (d + kTileRows);
}

// x (m, d), y (m,), w (m,) or nullptr, masks (nt, m) or nullptr (one
// partial, mask 1), beta (d,), partials (nt, rg_num_ctas(m), d), out
// (nt, d): all float32, contiguous, on the device of `stream`.
int rg_tier_round_gradient(const float* x, const float* y, const float* w,
                           const float* masks, int nt, const float* beta,
                           float* partials, float* out, int m, int d,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ctas = ctas_for(m);
  if (n_ctas > 0) {
    const int chunk = (masks == nullptr) ? 1 : rg_max_tiers(d);
    if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
    for (int t0 = 0; t0 < nt; t0 += chunk) {
      const int k = nt - t0 < chunk ? nt - t0 : chunk;
      const float* mk =
          masks == nullptr ? nullptr : masks + static_cast<int64_t>(t0) * m;
      float* dst = partials + static_cast<int64_t>(t0) * n_ctas * d;
      // one tier: kernel 1's instance; more: the run-time tier count
      const cudaError_t e =
          k == 1 ? launch_tiers<1>(x, y, w, mk, k, beta, dst, m, d, n_ctas, s)
                 : launch_tiers<0>(x, y, w, mk, k, beta, dst, m, d, n_ctas, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  return static_cast<int>(reduce(partials, out, n_ctas, d, nt, s));
}

// The flat masked round gradient: the tier variant at one tier, no mask.
int rg_masked_round_gradient(const float* x, const float* y, const float* w,
                             const float* beta, float* partials, float* out,
                             int m, int d, void* stream) {
  return rg_tier_round_gradient(x, y, w, nullptr, 1, beta, partials, out, m,
                                d, stream);
}

// x (m, d), y/w (m,) (w may be nullptr), xp (c, d), yp/wp (c,), beta
// (d,), partials (rg_num_ctas(m) + rg_num_ctas(c), d), out (d,).
int rg_coded_round_gradient(const float* x, const float* y, const float* w,
                            int m, const float* xp, const float* yp,
                            const float* wp, int c, const float* beta,
                            float* partials, float* out, int d,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ctas = ctas_for(m) + ctas_for(c);
  if (n_ctas > 0) {
    const size_t smem = smem_bytes(d, 1);
    cudaError_t e = allow_smem(coded_partial_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    coded_partial_kernel<<<n_ctas, kThreads, smem, s>>>(
        x, y, w, m, xp, yp, wp, c, beta, partials, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(reduce(partials, out, n_ctas, d, 1, s));
}

}  // extern "C"
