// Weighted parity encoding  P = G diag(w) X  for NVIDIA Hopper (sm_90a):
// G given (encode_kernel) or regenerated from a key inside the kernel
// (encode_prng_kernel).
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
//
// The in-kernel-generator variant, which replaces encode_parity_prng,
// has its own note below, above encode_prng_kernel.

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


// ---------------------------------------------------------------------------
// P = G diag(w) X with G regenerated from a threefry key inside the kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/encode/encode.py::encode_parity_prng
//   (body from _make_prng_kernel, pallas_call at line 235),
// the fleet layer's encode (repro.fleet.encode_fleet_tiered): no client's
// (C, L) generator ever exists in memory; each G tile is hashed from the
// client's key where it is used.  Entry (r, k) of G is word r * L + k of
// the size-C*L threefry2x32 stream in the legacy split-half counter
// pairing (repro_torch/kernels/encode/prng.py is the plain generator):
// Rademacher entries are bit-equal to it, normal entries go through
// Giles' float32 erfinv (XLA's), evaluated in the same float32 operations
// with every product and sum rounded on its own (__fmul_rn, __fadd_rn:
// no contraction into fma) and log1pf.
//
// What bounds it on this card: operations, two kinds.  The product is
// 2*C*L*D float32 flops (0.61 GFLOP at C = 2016, L = 300, D = 501: 9.05 us
// at 67 TFLOP/s).  Each generator entry costs one threefry2x32 hash, about
// 80 integer operations (20 rounds of add, funnel-shift, xor and five key
// injections, plus the counter pairing), and for normal entries about 25
// float operations more; C*L = 604,800 hashes are 48 M integer operations,
// 2.9 us at the card's 16.7 T INT32 op/s (64 lanes per SM x 132 SMs x
// 1.98 GHz), if each entry is hashed once.  The bytes (X, w, P: 4.6 MB)
// take 1.4 us.
//
// What the design does about it:
//   * Each 256-thread CTA owns kBC = 16 output rows by up to kBD = 512
//     columns, so one CTA covers the whole D = 501 of the paper's shapes
//     and every generator entry is hashed exactly once per launch: the
//     regeneration factor is ceil(D / 512), 1 for D <= 512.  (The Pallas
//     grid regenerates each tile once per d-block; a 64-wide column tile
//     would hash each entry 8 times and let the hash outweigh the
//     products.)  C = 2016 gives 126 CTAs, one wave on 132 SMs.
//   * The CTA walks L in steps of kBL = 16: each thread hashes one G
//     entry of the (16 x 16) tile, scales it by w[k], and loads 32
//     elements of the (16 x 512) X tile, all into registers while the
//     previous step's products run, then stores them to shared memory.
//     diag(w) goes on the G side, one multiply per hashed entry: X is
//     read straight into registers, so its 32 loads stay independent and
//     in flight together (a multiply per X element at load time, as
//     encode_kernel fuses it, serialized them under this kernel's
//     register pressure).  Each thread accumulates an 8 x 4 register
//     block (rows read as two broadcast float4, columns strided by 128
//     so a warp reads 32 neighbouring floats): 32 fma per 6 shared
//     loads.
//   * Entries past L (or rows past C) are 0 and the X tile is 0 past L,
//     so the ragged edges add exactly 0; nothing is padded on the host.
//     (G diag(w)) X rounds each product as g*w, then times x, where the
//     plain version forms w*x first: the two differ by rounding, held to
//     the reference's 2e-4 * max|ref|; at w = 1 the kernel returns G
//     exactly for X = I.
//     The flat index is 32-bit, as in the reference; the wrapper raises
//     when C * L reaches 2^31.
//   * accumulate != 0 adds the tile into `out` (out + P, one rounding),
//     so a fleet encode is one launch per client into the composite, in
//     client order, as the reference's scan accumulates.

namespace prng {

constexpr int kBC = 16;    // output rows per CTA (C axis)
constexpr int kBD = 512;   // output columns per CTA (D axis)
constexpr int kBL = 16;    // contraction step (L axis)
constexpr int kThreads = 256;
constexpr int kTM = 8;                   // rows per thread
constexpr int kTN = 4;                   // columns per thread
constexpr int kColThreads = kBD / kTN;   // 128: column stride of a thread
constexpr int kXLoads = kBL * kBD / kThreads;  // 32 X elements per thread
static_assert(kBC * kBL == kThreads, "one generator entry per thread");
static_assert((kBC / kTM) * kColThreads == kThreads, "thread layout");

constexpr int kNormal = 0;      // generator kinds, as ops.py codes them
constexpr int kBernoulli = 1;

// Giles' float32 erfinv coefficients (XLA's ErfInv32), highest power first
__constant__ float kWLt5[9] = {2.81022636e-08f, 3.43273939e-07f,
                               -3.5233877e-06f, -4.39150654e-06f,
                               0.00021858087f, -0.00125372503f,
                               -0.00417768164f, 0.246640727f, 1.50140941f};
__constant__ float kWGe5[9] = {-0.000200214257f, 0.000100950558f,
                               0.00134934322f, -0.00367342844f,
                               0.00573950773f, -0.0076224613f,
                               0.00943887047f, 1.00167406f, 2.83297682f};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// threefry2x32 with 20 rounds: jax._src.prng.threefry2x32's rotations,
// key schedule and constants.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND
  return make_uint2(x0, x1);
}

// Word idx of the size-`size` stream in the legacy split-half pairing:
// word 0 of hash(j, j + half) for idx < half, word 1 above (half =
// ceil(size / 2); an odd size pairs the last low counter with 0).
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint32_t idx, uint32_t size) {
  const uint32_t half = (size + 1u) / 2u;
  const bool hi = idx >= half;
  const uint32_t j = hi ? idx - half : idx;
  uint32_t cnt1 = j + half;
  if ((size & 1u) && cnt1 == size) cnt1 = 0u;
  const uint2 out = threefry2x32(k0, k1, j, cnt1);
  return hi ? out.y : out.x;
}

// Giles' float32 erfinv for |x| < 1, each operation rounded on its own.
__device__ __forceinline__ float erfinv_f32(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? kWLt5[0] : kWGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __fadd_rn(lt ? kWLt5[i] : kWGe5[i], __fmul_rn(p, w));
  return __fmul_rn(p, x);
}

// uint32 bits -> generator entry: jax.random's mantissa fill in [1, 2),
// then +-1 (Rademacher) or sqrt(2) * erfinv over [nextafter(-1, 0), 1).
__device__ __forceinline__ float bits_to_generator(uint32_t bits, int kind) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  if (kind == kBernoulli) return fmaxf(0.0f, f) < 0.5f ? 1.0f : -1.0f;
  constexpr float kLo = -0.99999994f;  // nextafter(-1, 0)
  const float u = fmaxf(kLo, __fadd_rn(__fmul_rn(f, 1.0f - kLo), kLo));
  return __fmul_rn(1.41421356f, erfinv_f32(u));
}

// Step `step`'s generator entry (row g_row, column step + g_col), scaled
// by w, and X tile elements into registers; element t of thread tid is
// flat index tid + t * kThreads of the (kBL, kBD) tile.
__device__ __forceinline__ void load_step(
    uint32_t k0, uint32_t k1, const float* __restrict__ w,
    const float* __restrict__ x, int c, int l, int d, int col0, int g_row,
    int g_col, int step, int kind, int tid, float& g_reg,
    float (&x_reg)[kXLoads]) {
#pragma unroll
  for (int t = 0; t < kXLoads; ++t) {
    const int i = tid + t * kThreads;
    const int gk = step + i / kBD, gn = col0 + i % kBD;
    x_reg[t] = (gk < l && gn < d) ? x[static_cast<int64_t>(gk) * d + gn]
                                  : 0.f;
  }
  const int gk = step + g_col;
  g_reg = 0.f;
  if (g_row < c && gk < l) {
    const uint32_t size = static_cast<uint32_t>(c) * static_cast<uint32_t>(l);
    const uint32_t idx = static_cast<uint32_t>(g_row) *
                             static_cast<uint32_t>(l) + static_cast<uint32_t>(gk);
    g_reg = bits_to_generator(bits_at(k0, k1, idx, size), kind) * w[gk];
  }
}

__global__ void __launch_bounds__(kThreads)
encode_prng_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ w,
                   const float* __restrict__ x, float* __restrict__ out,
                   int c, int l, int d, int kind, int accumulate) {
  __shared__ __align__(16) float s_g[kBL][kBC];  // G diag(w) tile, transposed
  __shared__ float s_x[kBL][kBD];                // X tile

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  const int row0 = blockIdx.x * kBC;
  const int col0 = blockIdx.y * kBD;
  const int g_row = row0 + tid / kBL;  // this thread's generator entry
  const int g_col = tid % kBL;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float g_reg, x_reg[kXLoads];
  load_step(k0, k1, w, x, c, l, d, col0, g_row, g_col, 0, kind, tid, g_reg,
            x_reg);
  for (int step = 0; step < l; step += kBL) {
    s_g[g_col][tid / kBL] = g_reg;
#pragma unroll
    for (int t = 0; t < kXLoads; ++t) {
      const int i = tid + t * kThreads;
      s_x[i / kBD][i % kBD] = x_reg[t];
    }
    __syncthreads();
    if (step + kBL < l)  // the next step's hashes and loads overlap this one
      load_step(k0, k1, w, x, c, l, d, col0, g_row, g_col, step + kBL, kind,
                tid, g_reg, x_reg);
#pragma unroll
    for (int k = 0; k < kBL; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_g[k][ty * kTM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s_g[k][ty * kTM + 4]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = s_x[k][tx + j * kColThreads];
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
      const int n = col0 + tx + j * kColThreads;
      if (n >= d) continue;
      float* dst = out + static_cast<int64_t>(r) * d + n;
      *dst = accumulate ? *dst + acc[i][j] : acc[i][j];
    }
  }
}

}  // namespace prng

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

// key (k0, k1); w (l,), x (l, d), out (c, d): float32, contiguous, on
// the device of `stream`; kind 0 normal, 1 Rademacher; accumulate != 0
// adds into out.  c, d > 0 and c * l < 2^31.
int enc_encode_parity_prng(uint32_t k0, uint32_t k1, const float* w,
                           const float* x, float* out, int c, int l, int d,
                           int kind, int accumulate, void* stream) {
  if (kind != prng::kNormal && kind != prng::kBernoulli)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + prng::kBC - 1) / prng::kBC,
                  (d + prng::kBD - 1) / prng::kBD);
  prng::encode_prng_kernel<<<grid, prng::kThreads, 0, s>>>(
      k0, k1, w, x, out, c, l, d, kind, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
