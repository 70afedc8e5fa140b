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
// What bounds it on this card: operations, and the shared memory that
// feeds them.  At the paper's shapes (C = 2016, L = 300, D = 501) one
// call is 2*C*L*D = 0.61 GFLOP against 7.1 MB of operands, about 86 flops
// per byte.  The reference holds the encode to 2e-4 * max|ref|, which one
// TF32 product per float32 product misses, so the products go through
// the tensor cores as 3xTF32 (`mma_tf32.cuh`): each float32 operand split
// into two TF32 words, three m16n8k8 products per float32 product, 3 x
// 0.61 GFLOP at the card's 495 TFLOP/s TF32 rate, 3.7 us (on the float32
// FMA pipes, 9.0 us).  mma.sync reaches about 310 TFLOP/s, and its
// fragments come from shared memory: with 128 x 64 output tiles of
// 32 x 32 warp tiles, big and small words, that is 128 KB a step of 32
// along L for every SM, beside the staging's 96 KB (copies in, split
// words out).  Each CTA also brings its tiles from L2: G is read by 8
// column tiles and X by 16 row tiles, 29 MB in all.
//
// What the design does about it:
//   * Each 256-thread CTA computes a 128 x 64 output tile (8 warps, 4 x 2,
//     each a 32 x 32 tile: 2 x 4 m16n8k8 accumulators), walking L in steps
//     of 32.  At C = 2016, D = 501 that is 16 x 8 = 128 CTAs, one wave on
//     132 SMs.
//   * Every operand element is split once, when it is staged.  A ring of
//     three raw stages takes G's (128 x 32) and X's (32 x 64) tiles and
//     w's 32 entries by cp.async, up to three steps ahead of the products
//     (16-byte copies for G when L % 4 == 0 and G is 16-byte aligned, as
//     at L = 300; X's rows, at D = 501, are not, so X takes 4-byte copies
//     unless D % 4 == 0 and X is aligned: an instance chosen at launch,
//     as kernel 8 chooses its copy width).  Each step, the CTA forms
//     w[k] * x[k, n] in float32 (rounded on its own), splits it and G's
//     elements into (big, small) TF32 words and stores them into
//     double-buffered split tiles; a thread reads all its raw values
//     before it stores a word, so the loads do not wait on the stores.
//     The fragments then load ready-made words: the inner loop does no
//     rounding and no split.  diag(w) X never exists in device memory.
//   * The split tiles' rows are padded (G: 36 words, X: 72) so that the
//     A and B fragment loads of `mma_tf32.cuh`'s map hit 32 distinct
//     banks.
//   * One barrier a step: the products of step s, the split of step s + 1
//     and the copies of step s + 3 use different buffers.
//   * The output tile goes out through shared memory, each warp writing
//     whole row segments (the fragments' own layout would write half
//     sectors).
//   * Ragged edges in C, L and D are zero-filled in the copies (zeros
//     split to zeros and add exactly nothing) and masked in the store;
//     nothing is padded on the host.  Each output is one fixed chain over
//     L in increasing steps of 8 (small.big, big.small, big.big), so
//     relaunches are bit-identical.
//   * Accuracy: the split leaves out at most ~12 u |g||wx| a product (u =
//     2^-24), each tensor-core product truncates its float32 sum (~2 u of
//     the partial sum, three per 8 terms), and w x rounds once: within
//     (0.75 L + 19) u (|G| |diag(w) X|), inside the stated bound of
//     ops.float64_reference_and_bound, 1.01 (L + 20) u (|G| |diag(w) X|).
//
// The in-kernel-generator variant, which replaces encode_parity_prng,
// has its own note below, above encode_prng_kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_api.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kBM = 128;   // output rows per CTA (C axis)
constexpr int kBN = 64;    // output columns per CTA (D axis)
constexpr int kBK = 32;    // contraction step (L axis)
constexpr int kWarpsM = 4, kWarpsN = 2;  // the CTA's warps over its tile
constexpr int kStages = 3;               // raw stages in flight
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;       // a warp's rows
constexpr int kWN = kBN / kWarpsN;       // a warp's columns
constexpr int kMT = kWM / 16;            // m16 tiles a warp
constexpr int kNT = kWN / 8;             // n8 tiles a warp
constexpr int kAStride = kBK + 4;        // split G rows: 4g + t distinct banks
constexpr int kBStride = kBN + 8;        // split X rows: 8t + g distinct banks
constexpr int kATile = kBM * kAStride;   // words of one split G tile
constexpr int kBTile = kBK * kBStride;   // words of one split X tile
constexpr int kOStride = kBN + 8;        // the output tile's rows (float2)
constexpr int kSplitWords = 2 * kATile + 2 * kBTile;  // big and small
constexpr int kRawFloats = kBM * kBK + kBK * kBN + kBK;  // G, X, w
constexpr int kSmemBytes = (kStages * kRawFloats + 2 * kSplitWords) * 4;
constexpr int kGPer = kBM * kBK / kThreads;  // elements a thread splits
constexpr int kXPer = kBK * kBN / kThreads;
static_assert(kWM % 16 == 0 && kWN % 8 == 0 && kBK % 8 == 0, "mma tiles");
static_assert(kThreads % kBK == 0 && kThreads % kBN == 0,
              "a thread splits one column of each tile");
static_assert(kStages >= 2 && kRawFloats % 4 == 0, "ring");
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
static_assert(kBM * kOStride <= 2 * kSplitWords, "output tile");
static_assert(kBM * kBN % kThreads == 0, "whole output rows a pass");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy kVec floats (16 or 4 bytes) from global to shared memory; with
// `read` false nothing is read and the destination is zero-filled.
template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool read) {
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(read ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(read ? 4 : 0)
                 : "memory");
  }
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// Copy the (rows x cols) tile at (r0, c0) of the row-major (nr, nc)
// matrix src into dst (row stride cols), zero-filling past the edges;
// kVec floats a copy (nc % kVec == 0 and src 16-byte aligned for 4).
template <int kVec, int kRows, int kCols>
__device__ __forceinline__ void copy_tile(float* dst,
                                          const float* __restrict__ src,
                                          int nr, int nc, int r0, int c0) {
  constexpr int kCopies = kRows * kCols / kVec;
  static_assert(kCopies % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < kCopies / kThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = e / (kCols / kVec), c = (e % (kCols / kVec)) * kVec;
    const bool in = r0 + r < nr && c0 + c < nc;
    cp_async<kVec>(dst + r * kCols + c,
                   in ? src + static_cast<int64_t>(r0 + r) * nc + c0 + c
                      : src, in);
  }
}

// Start step k0's copies into a raw stage (G tile, X tile, w) as one
// commit group.
template <bool kVecG, bool kVecX>
__device__ __forceinline__ void issue_step(
    float* raw, const float* __restrict__ g, const float* __restrict__ w,
    const float* __restrict__ x, int c, int l, int d, int row0, int col0,
    int k0) {
  copy_tile<kVecG ? 4 : 1, kBM, kBK>(raw, g, c, l, row0, k0);
  copy_tile<kVecX ? 4 : 1, kBK, kBN>(raw + kBM * kBK, x, l, d, k0, col0);
  const int k = static_cast<int>(threadIdx.x);
  if (k < kBK) {
    const bool in = k0 + k < l;
    cp_async<1>(raw + kBM * kBK + kBK * kBN + k, in ? w + k0 + k : w, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Split a landed raw stage into big and small TF32 words: G as it is,
// X as w[k] * x[k, n] rounded once to float32.  Every raw value is read
// into registers before the first split word is stored, so the loads do
// not wait on the stores (both are shared memory, one array).
__device__ __forceinline__ void split_step(const float* __restrict__ raw,
                                           uint32_t* __restrict__ split) {
  const float* rg = raw;
  const float* rx = raw + kBM * kBK;
  const float* rw = rx + kBK * kBN;
  uint32_t* a_big = split;
  uint32_t* a_small = a_big + kATile;
  uint32_t* b_big = a_small + kATile;
  uint32_t* b_small = b_big + kBTile;
  const int tid = threadIdx.x;
  float gv[kGPer], xv[kXPer], wv[kXPer];
#pragma unroll
  for (int i = 0; i < kGPer; ++i) gv[i] = rg[tid + i * kThreads];
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int f = tid + i * kThreads;
    xv[i] = rx[f];
    wv[i] = rw[f / kBN];
  }
#pragma unroll
  for (int i = 0; i < kGPer; ++i) {
    const int f = tid + i * kThreads;
    const int at = (f / kBK) * kAStride + f % kBK;
    tf32::split(gv[i], a_big[at], a_small[at]);
  }
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int f = tid + i * kThreads;
    const int bt = (f / kBN) * kBStride + f % kBN;
    // rounded on its own: no fma of the product into the split
    tf32::split(__fmul_rn(wv[i], xv[i]), b_big[bt], b_small[bt]);
  }
}

// The products of one step: for each k8 sub-step below L, every warp's
// kMT x kNT accumulators take small.big, big.small and big.big.
__device__ __forceinline__ void mma_step(const uint32_t* split,
                                         float (&acc)[kMT][kNT][4], int k0,
                                         int l, int wm, int wn) {
  const uint32_t* a_big = split;
  const uint32_t* a_small = a_big + kATile;
  const uint32_t* b_big = a_small + kATile;
  const uint32_t* b_small = b_big + kBTile;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    if (k0 + kk >= l) break;  // past L: all zeros
    uint32_t fa_big[kMT][4], fa_small[kMT][4], fb_big[kNT][2],
        fb_small[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = wm * kWM + mt * 16 + g;
      const int o[4] = {r * kAStride + kk + t, (r + 8) * kAStride + kk + t,
                        r * kAStride + kk + t + 4,
                        (r + 8) * kAStride + kk + t + 4};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fa_big[mt][e] = a_big[o[e]];
        fa_small[mt][e] = a_small[o[e]];
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = wn * kWN + nt * 8 + g;
      const int o[2] = {(kk + t) * kBStride + n, (kk + t + 4) * kBStride + n};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        fb_big[nt][e] = b_big[o[e]];
        fb_small[nt][e] = b_small[o[e]];
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        tf32::mma3(acc[mt][nt], fa_big[mt], fa_small[mt], fb_big[nt],
                   fb_small[nt]);
  }
}

template <bool kVecG, bool kVecX>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ g, const float* __restrict__ w,
              const float* __restrict__ x, float* __restrict__ out,
              int c, int l, int d) {
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;  // kStages x kRawFloats
  uint32_t* split = reinterpret_cast<uint32_t*>(smem + kStages * kRawFloats);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int n_steps = (l + kBK - 1) / kBK;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // steps 0 .. kStages - 1 in flight; step 0 split
  for (int s = 0; s < kStages; ++s) {
    if (s < n_steps)
      issue_step<kVecG, kVecX>(raw + s * kRawFloats, g, w, x, c, l, d, row0,
                               col0, s * kBK);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  split_step(raw, split);

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step s + 1
    __syncthreads();  // every thread's; split s is in; step s - 1's
                      // products are done with the other split buffer
    // step s's raw stage was split: refill it with step s + kStages
    if (s + kStages < n_steps)
      issue_step<kVecG, kVecX>(raw + (s % kStages) * kRawFloats, g, w, x, c,
                               l, d, row0, col0, (s + kStages) * kBK);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    mma_step(split + (s & 1) * kSplitWords, acc, s * kBK, l, wm, wn);
    if (s + 1 < n_steps)  // the next step, into the other split buffer
      split_step(raw + ((s + 1) % kStages) * kRawFloats,
                 split + ((s + 1) & 1) * kSplitWords);
  }

  // the tile goes out through shared memory, a warp a row segment
  __syncthreads();  // every warp's products are done: the tiles are free
  float* s_out = reinterpret_cast<float*>(split);  // (kBM, kOStride)
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int r = wm * kWM + mt * 16 + gq;
      const int n = wn * kWN + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(s_out + r * kOStride + n) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(s_out + (r + 8) * kOStride + n) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int i = 0; i < kBM * kBN / kThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = e / kBN, n = e % kBN;
    if (row0 + r < c && col0 + n < d)
      out[static_cast<int64_t>(row0 + r) * d + col0 + n] =
          s_out[r * kOStride + n];
  }
}

template <bool kVecG, bool kVecX>
cudaError_t launch_encode(const float* g, const float* w, const float* x,
                          float* out, int c, int l, int d, cudaStream_t s) {
  auto kernel = encode_kernel<kVecG, kVecX>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((d + kBN - 1) / kBN, (c + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(g, w, x, out, c, l, d);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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
  // 16-byte copies where a matrix's rows allow them
  const bool vg = l % 4 == 0 && aligned16(g);
  const bool vx = d % 4 == 0 && aligned16(x);
  const cudaError_t e =
      vg ? (vx ? launch_encode<true, true>(g, w, x, out, c, l, d, s)
               : launch_encode<true, false>(g, w, x, out, c, l, d, s))
         : (vx ? launch_encode<false, true>(g, w, x, out, c, l, d, s)
               : launch_encode<false, false>(g, w, x, out, c, l, d, s));
  return static_cast<int>(e);
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
