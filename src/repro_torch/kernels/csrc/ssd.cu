// Mamba2 SSD intra-chunk step for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/ssd.py::ssd_chunk
//   (body _kernel, pallas_call at line 69),
// the heavy half of the chunked SSD scan (repro.models.ssm.ssd_chunked)
// that every prefill of a Mamba2 layer runs.  For each (batch, chunk,
// head) it computes, with cum the inclusive prefix sum of da over the
// chunk,
//   y[q, p]     = sum_{t <= q} (C_q . B_t) * exp(cum_q - cum_t) * dt_t x_t[p]
//   state[p, n] = sum_q exp(cum_{Q-1} - cum_q) * dt_q x_q[p] * B_q[n].
// The inter-chunk recurrence stays outside, in the model.
//
// What bounds it on this card: operations.  At the serving shape of
// mamba2-1.3b (Q = 256, P = 64, N = 128) the causal half is about
// Q^2/2 * 2 (N + P) + 2 Q P N = 16.8 MFLOP per (chunk, head) against
// about 0.17 MB of its operands and results: some 100 flops per byte,
// far above the float32 balance point, so the least time is the flops
// over the card's float32 rate outside the tensor cores.  It stays full
// float32 (the reference holds it at rtol 1e-4; TF32 keeps ~3 digits).
//
// What the design does about it:
//   * The Pallas block keeps Q (2N + P + Q) floats on chip, ~590 KB at
//     the serving shape: more than the 227 KB one CTA may have.  Here one
//     256-thread CTA owns one (b, chunk, head) and walks 64 x 64 tiles:
//     for each tile of query rows, the t tiles at or below the diagonal
//     only (the Pallas kernel multiplies the full Q x Q), the score tile
//     C B^T from 16-wide slices of N staged k-major in shared memory,
//     then the decay, the causal mask and the product with the
//     dt-weighted x tile, each thread holding a 4 x 4 register block of
//     the output.  The state is a second tiled product over q with the
//     decay to the chunk end folded into the staged x tile.
//   * B and C are read per group (index h / (H / G)), so the per-head
//     copies the reference makes with jnp.repeat are never formed.
//   * The prefix sum of da is taken in float64 and rounded once to
//     float32: at the model's own inputs |cum| reaches ~3e3 within a
//     chunk, where a float32 prefix sum carries ~1e-3 relative error in
//     exp(cum_q - cum_t) that depends on the order of the additions.
//     In float64 the order does not show after the rounding, so the
//     kernel and the plain version (torch.cumsum in float64, rounded to
//     float32) compute the same decays.  One warp does it: each lane
//     sums a contiguous segment, a shuffle scan adds the segments in lane
//     order, each lane re-walks its segment.
//   * Plain float32 FMA, every sum in a fixed order, so two launches on
//     the same inputs are bit-identical.  Ragged Q, P and N are masked in
//     the loads and the stores; nothing is padded on the host.
//
// A simple kernel that is right comes first: no wgmma (float32 has no
// full-precision tensor-core path), no TMA, no multi-stage pipeline.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_api.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;           // rows / columns of every tile
constexpr int kNK = 16;          // slice of N per step of C B^T
constexpr int kLdK = kT + 1;     // row stride of the k-major C and B tiles
constexpr int kLdS = kT + 16;    // row stride of the score tile
// shared floats of the y phase (C, B, scores, x); the state phase needs
// 2 kT^2 of them, fewer
constexpr int kScratch = 2 * kNK * kLdK + kT * kLdS + kT * kT;
constexpr int kMaxSmemBytes = 232448;  // what one Hopper CTA may have
// cum, dt and the decay to the chunk end take 3 floats per padded row
constexpr int kMaxQ =
    (kMaxSmemBytes / 4 - kScratch) / 3 / kT * kT;

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ xc, const float* __restrict__ dtc,
                 const float* __restrict__ da, const float* __restrict__ bc,
                 const float* __restrict__ cc, float* __restrict__ y,
                 float* __restrict__ states, int nc, int Q, int H, int P,
                 int G, int N) {
  extern __shared__ float smem[];
  const int qpad = (Q + kT - 1) / kT * kT;
  float* cum_s = smem;             // (qpad,) prefix sums of da
  float* dt_s = cum_s + qpad;      // (qpad,) dt
  float* dec_s = dt_s + qpad;      // (qpad,) exp(cum_{Q-1} - cum_q)
  float* work = dec_s + qpad;      // kScratch floats

  const int h = blockIdx.x;
  const int64_t chunk = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // row q of this (b, chunk, head): x/y at x_base + q * ldx, dt/da at
  // s_base + q * H, B/C at g_base + q * ldg
  const int64_t ldx = static_cast<int64_t>(H) * P;
  const int64_t ldg = static_cast<int64_t>(G) * N;
  const int64_t x_base = chunk * Q * ldx + static_cast<int64_t>(h) * P;
  const int64_t s_base = chunk * Q * H + h;
  const int64_t g_base = chunk * Q * ldg + static_cast<int64_t>(g) * N;
  const float* xh = xc + x_base;
  const float* bg = bc + g_base;
  const float* cg = cc + g_base;

  // ---- prologue: dt, the prefix sums of da (float64), the out-decay ----
  for (int q = tid; q < qpad; q += kThreads) {
    dt_s[q] = q < Q ? dtc[s_base + q * static_cast<int64_t>(H)] : 0.f;
    if (q >= Q) cum_s[q] = 0.f;
  }
  if (tid < 32) {
    const int seg = (Q + 31) / 32;
    const int lo = min(tid * seg, Q), hi = min(lo + seg, Q);
    double part = 0.0;
    for (int q = lo; q < hi; ++q)
      part += static_cast<double>(da[s_base + q * static_cast<int64_t>(H)]);
    double incl = part;  // inclusive scan of the lane sums, in lane order
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    double run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) run = 0.0;
    for (int q = lo; q < hi; ++q) {
      run += static_cast<double>(da[s_base + q * static_cast<int64_t>(H)]);
      cum_s[q] = static_cast<float>(run);
    }
  }
  __syncthreads();
  const float cum_last = cum_s[Q - 1];
  for (int q = tid; q < qpad; q += kThreads)
    dec_s[q] = q < Q ? expf(cum_last - cum_s[q]) : 0.f;
  __syncthreads();

  // ---- y: causal tiles of (C B^T * decay) (dt x) -------------------------
  float* ct = work;                // [kNK][kLdK] C rows q, k-major
  float* bt = ct + kNK * kLdK;     // [kNK][kLdK] B rows t, k-major
  float* st = bt + kNK * kLdK;     // [kT][kLdS] decayed, masked scores
  float* xt = st + kT * kLdS;      // [kT][kT]   dt-weighted x rows t
  for (int q0 = 0; q0 < Q; q0 += kT) {
    for (int p0 = 0; p0 < P; p0 += kT) {
      float acc[4][4] = {};
      for (int t0 = 0; t0 <= q0; t0 += kT) {
        float s[4][4] = {};
        for (int n0 = 0; n0 < N; n0 += kNK) {
          for (int e = tid; e < kT * kNK; e += kThreads) {
            const int r = e / kNK, k = e % kNK, n = n0 + k;
            const int qr = q0 + r, tr = t0 + r;
            ct[k * kLdK + r] = (qr < Q && n < N) ? cg[qr * ldg + n] : 0.f;
            bt[k * kLdK + r] = (tr < Q && n < N) ? bg[tr * ldg + n] : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int k = 0; k < kNK; ++k) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = ct[k * kLdK + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = bt[k * kLdK + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + tx + 16 * j;
            st[(ty + 16 * i) * kLdS + tx + 16 * j] =
                (t <= q && q < Q) ? s[i][j] * expf(cum_s[q] - cum_s[t])
                                  : 0.f;
          }
        }
        for (int e = tid; e < kT * kT; e += kThreads) {
          const int r = e / kT, p = p0 + e % kT;
          const int t = t0 + r;
          xt[e] = (t < Q && p < P) ? xh[t * ldx + p] * dt_s[t] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int t = 0; t < kT; ++t) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = st[(ty + 16 * i) * kLdS + t];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = xt[t * kT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + tx + 16 * j;
          if (p < P) y[x_base + q * ldx + p] = acc[i][j];
        }
      }
    }
  }

  // ---- state: (dec * dt x)^T B over the chunk -----------------------------
  float* xs = work;                // [kT][kT] rows q, columns p
  float* bs = work + kT * kT;      // [kT][kT] rows q, columns n
  float* out = states + (chunk * H + h) * static_cast<int64_t>(P) * N;
  for (int p0 = 0; p0 < P; p0 += kT) {
    for (int n0 = 0; n0 < N; n0 += kT) {
      float acc[4][4] = {};
      for (int q0 = 0; q0 < Q; q0 += kT) {
        for (int e = tid; e < kT * kT; e += kThreads) {
          const int r = e / kT, col = e % kT;
          const int q = q0 + r, p = p0 + col, n = n0 + col;
          xs[e] = (q < Q && p < P) ? xh[q * ldx + p] * dt_s[q] * dec_s[q]
                                   : 0.f;
          bs[e] = (q < Q && n < N) ? bg[q * ldg + n] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int r = 0; r < kT; ++r) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xs[r * kT + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = bs[r * kT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty + 16 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx + 16 * j;
          if (n < N) out[static_cast<int64_t>(p) * N + n] = acc[i][j];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// xc (B, nc, Q, H, P), dtc and da (B, nc, Q, H), bc and cc (B, nc, Q, G,
// N) with G dividing H; y (B, nc, Q, H, P), states (B, nc, H, P, N).  All
// float32, contiguous, on the device of `stream`; every extent > 0,
// Q <= kMaxQ (15552, what shared memory holds), nc and B <= 65535;
// otherwise it returns cudaErrorInvalidValue.
int ssd_chunk_launch(const float* xc, const float* dtc, const float* da,
                     const float* bc, const float* cc, float* y,
                     float* states, int B, int nc, int Q, int H, int P,
                     int G, int N, void* stream) {
  if (B <= 0 || nc <= 0 || Q <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 ||
      Q > kMaxQ || H % G != 0 || nc > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qpad = (Q + kT - 1) / kT * kT;
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(qpad) +
                                       kScratch);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_chunk_kernel<<<dim3(H, nc, B), kThreads, smem, s>>>(
      xc, dtc, da, bc, cc, y, states, nc, Q, H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
