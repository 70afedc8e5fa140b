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
//     132 SMs.  That is the default tile; the tile (bm, bn, bk) is a
//     template parameter, and the library instantiates the tiles of
//     kTiles (64 or 128 rows by 32, 64 or 128 columns, steps of 32), which
//     the launch picks at run time: the tuner's candidates.  A tile whose
//     three raw stages would not fit the 227 KB of shared memory a CTA may
//     take, (128, 128, 32), runs two.
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

constexpr int kWarpsM = 4, kWarpsN = 2;  // the CTA's warps over its tile
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kSmemLimit = 232448;       // opt-in shared memory of a CTA

// One output tile of encode_kernel: kBM x kBN outputs a CTA (C and D
// axes), steps of kBK along L, and what follows from them.  The tiles the
// library instantiates are listed in kTiles below; the wrapper's default
// is (128, 64, 32).
template <int BM, int BN, int BK>
struct Tile {
  static constexpr int kBM = BM;   // output rows per CTA (C axis)
  static constexpr int kBN = BN;   // output columns per CTA (D axis)
  static constexpr int kBK = BK;   // contraction step (L axis)
  static constexpr int kWM = kBM / kWarpsM;       // a warp's rows
  static constexpr int kWN = kBN / kWarpsN;       // a warp's columns
  static constexpr int kMT = kWM / 16;            // m16 tiles a warp
  static constexpr int kNT = kWN / 8;             // n8 tiles a warp
  static constexpr int kAStride = kBK + 4;  // split G rows: 4g + t banks
  static constexpr int kBStride = kBN + 8;  // split X rows: 8t + g banks
  static constexpr int kATile = kBM * kAStride;   // words of a split G tile
  static constexpr int kBTile = kBK * kBStride;   // words of a split X tile
  static constexpr int kOStride = kBN + 8;        // the output tile's rows
  static constexpr int kSplitWords = 2 * kATile + 2 * kBTile;  // big, small
  static constexpr int kRawFloats = kBM * kBK + kBK * kBN + kBK;  // G, X, w
  // raw stages in flight: three where shared memory holds them, else two
  static constexpr int kStages =
      (3 * kRawFloats + 2 * kSplitWords) * 4 <= kSmemLimit ? 3 : 2;
  static constexpr int kSmemBytes =
      (kStages * kRawFloats + 2 * kSplitWords) * 4;
  static constexpr int kGPer = kBM * kBK / kThreads;  // elements a thread
  static constexpr int kXPer = kBK * kBN / kThreads;  // splits
  static_assert(kWM % 16 == 0 && kWN % 8 == 0 && kBK % 8 == 0, "mma tiles");
  static_assert(kThreads % kBK == 0 && kThreads % kBN == 0,
                "a thread splits one column of each tile");
  static_assert(kRawFloats % 4 == 0, "ring");
  static_assert(kSmemBytes <= kSmemLimit, "shared memory of one CTA");
  static_assert(kBM * kOStride <= 2 * kSplitWords, "output tile");
  static_assert(kBM * kBN % kThreads == 0, "whole output rows a pass");
};

// The instantiated tiles (bm, bn, bk): the candidates of the tuner's
// "encode" family (kernels/encode/ops.py keeps the same list, TILES).
constexpr int kTiles[][3] = {{128, 64, 32}, {64, 64, 32}, {64, 128, 32},
                             {128, 32, 32}, {64, 32, 32}, {128, 128, 32}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

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
template <class T, bool kVecG, bool kVecX>
__device__ __forceinline__ void issue_step(
    float* raw, const float* __restrict__ g, const float* __restrict__ w,
    const float* __restrict__ x, int c, int l, int d, int row0, int col0,
    int k0) {
  copy_tile<kVecG ? 4 : 1, T::kBM, T::kBK>(raw, g, c, l, row0, k0);
  copy_tile<kVecX ? 4 : 1, T::kBK, T::kBN>(raw + T::kBM * T::kBK, x, l, d,
                                           k0, col0);
  const int k = static_cast<int>(threadIdx.x);
  if (k < T::kBK) {
    const bool in = k0 + k < l;
    cp_async<1>(raw + T::kBM * T::kBK + T::kBK * T::kBN + k,
                in ? w + k0 + k : w, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Split a landed raw stage into big and small TF32 words: G as it is,
// X as w[k] * x[k, n] rounded once to float32.  Every raw value is read
// into registers before the first split word is stored, so the loads do
// not wait on the stores (both are shared memory, one array).
template <class T>
__device__ __forceinline__ void split_step(const float* __restrict__ raw,
                                           uint32_t* __restrict__ split) {
  const float* rg = raw;
  const float* rx = raw + T::kBM * T::kBK;
  const float* rw = rx + T::kBK * T::kBN;
  uint32_t* a_big = split;
  uint32_t* a_small = a_big + T::kATile;
  uint32_t* b_big = a_small + T::kATile;
  uint32_t* b_small = b_big + T::kBTile;
  const int tid = threadIdx.x;
  float gv[T::kGPer], xv[T::kXPer], wv[T::kXPer];
#pragma unroll
  for (int i = 0; i < T::kGPer; ++i) gv[i] = rg[tid + i * kThreads];
#pragma unroll
  for (int i = 0; i < T::kXPer; ++i) {
    const int f = tid + i * kThreads;
    xv[i] = rx[f];
    wv[i] = rw[f / T::kBN];
  }
#pragma unroll
  for (int i = 0; i < T::kGPer; ++i) {
    const int f = tid + i * kThreads;
    const int at = (f / T::kBK) * T::kAStride + f % T::kBK;
    tf32::split(gv[i], a_big[at], a_small[at]);
  }
#pragma unroll
  for (int i = 0; i < T::kXPer; ++i) {
    const int f = tid + i * kThreads;
    const int bt = (f / T::kBN) * T::kBStride + f % T::kBN;
    // rounded on its own: no fma of the product into the split
    tf32::split(__fmul_rn(wv[i], xv[i]), b_big[bt], b_small[bt]);
  }
}

// The products of one step: for each k8 sub-step below L, every warp's
// kMT x kNT accumulators take small.big, big.small and big.big.
template <class T>
__device__ __forceinline__ void mma_step(const uint32_t* split,
                                         float (&acc)[T::kMT][T::kNT][4],
                                         int k0, int l, int wm, int wn) {
  const uint32_t* a_big = split;
  const uint32_t* a_small = a_big + T::kATile;
  const uint32_t* b_big = a_small + T::kATile;
  const uint32_t* b_small = b_big + T::kBTile;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < T::kBK; kk += 8) {
    if (k0 + kk >= l) break;  // past L: all zeros
    uint32_t fa_big[T::kMT][4], fa_small[T::kMT][4], fb_big[T::kNT][2],
        fb_small[T::kNT][2];
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt) {
      const int r = wm * T::kWM + mt * 16 + g;
      const int o[4] = {r * T::kAStride + kk + t,
                        (r + 8) * T::kAStride + kk + t,
                        r * T::kAStride + kk + t + 4,
                        (r + 8) * T::kAStride + kk + t + 4};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fa_big[mt][e] = a_big[o[e]];
        fa_small[mt][e] = a_small[o[e]];
      }
    }
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) {
      const int n = wn * T::kWN + nt * 8 + g;
      const int o[2] = {(kk + t) * T::kBStride + n,
                        (kk + t + 4) * T::kBStride + n};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        fb_big[nt][e] = b_big[o[e]];
        fb_small[nt][e] = b_small[o[e]];
      }
    }
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt)
        tf32::mma3(acc[mt][nt], fa_big[mt], fa_small[mt], fb_big[nt],
                   fb_small[nt]);
  }
}

// One CTA an SM is what the budget is set for (its shared memory holds
// the SM at the default tile): without the minimum, ptxas held the
// (64, 64, 32) 16-byte instance to 80 registers and spilled.
template <int kBM, int kBN, int kBK, bool kVecG, bool kVecX>
__global__ void __launch_bounds__(kThreads, 1)
encode_kernel(const float* __restrict__ g, const float* __restrict__ w,
              const float* __restrict__ x, float* __restrict__ out,
              int c, int l, int d) {
  using T = Tile<kBM, kBN, kBK>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;  // kStages x kRawFloats
  uint32_t* split =
      reinterpret_cast<uint32_t*>(smem + kStages * T::kRawFloats);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int n_steps = (l + kBK - 1) / kBK;

  float acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // steps 0 .. kStages - 1 in flight; step 0 split
  for (int s = 0; s < kStages; ++s) {
    if (s < n_steps)
      issue_step<T, kVecG, kVecX>(raw + s * T::kRawFloats, g, w, x, c, l, d,
                                  row0, col0, s * kBK);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  split_step<T>(raw, split);

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step s + 1
    __syncthreads();  // every thread's; split s is in; step s - 1's
                      // products are done with the other split buffer
    // step s's raw stage was split: refill it with step s + kStages
    if (s + kStages < n_steps)
      issue_step<T, kVecG, kVecX>(raw + (s % kStages) * T::kRawFloats, g, w,
                                  x, c, l, d, row0, col0,
                                  (s + kStages) * kBK);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    mma_step<T>(split + (s & 1) * T::kSplitWords, acc, s * kBK, l, wm, wn);
    if (s + 1 < n_steps)  // the next step, into the other split buffer
      split_step<T>(raw + ((s + 1) % kStages) * T::kRawFloats,
                    split + ((s + 1) & 1) * T::kSplitWords);
  }

  // the tile goes out through shared memory, a warp a row segment
  __syncthreads();  // every warp's products are done: the tiles are free
  float* s_out = reinterpret_cast<float*>(split);  // (kBM, kOStride)
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) {
      const int r = wm * T::kWM + mt * 16 + gq;
      const int n = wn * T::kWN + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(s_out + r * T::kOStride + n) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(s_out + (r + 8) * T::kOStride + n) =
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
          s_out[r * T::kOStride + n];
  }
}

template <int kBM, int kBN, int kBK, bool kVecG, bool kVecX>
cudaError_t launch_instance(const float* g, const float* w, const float* x,
                            float* out, int c, int l, int d,
                            cudaStream_t s) {
  auto kernel = encode_kernel<kBM, kBN, kBK, kVecG, kVecX>;
  constexpr int kBytes = Tile<kBM, kBN, kBK>::kSmemBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((d + kBN - 1) / kBN, (c + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kBytes, s>>>(g, w, x, out, c, l, d);
  return cudaGetLastError();
}

// 16-byte copies where a matrix's rows allow them (vg: G's, vx: X's)
template <int kBM, int kBN, int kBK>
cudaError_t launch_encode(const float* g, const float* w, const float* x,
                          float* out, int c, int l, int d, bool vg, bool vx,
                          cudaStream_t s) {
  return vg ? (vx ? launch_instance<kBM, kBN, kBK, true, true>(
                        g, w, x, out, c, l, d, s)
                  : launch_instance<kBM, kBN, kBK, true, false>(
                        g, w, x, out, c, l, d, s))
            : (vx ? launch_instance<kBM, kBN, kBK, false, true>(
                        g, w, x, out, c, l, d, s)
                  : launch_instance<kBM, kBN, kBK, false, false>(
                        g, w, x, out, c, l, d, s));
}

// The instance of tile kTiles[I], or of the next one.
template <int I>
cudaError_t launch_tile(int bm, int bn, int bk, const float* g,
                        const float* w, const float* x, float* out, int c,
                        int l, int d, bool vg, bool vx, cudaStream_t s) {
  if constexpr (I == kNumTiles) {
    return cudaErrorInvalidValue;  // not an instantiated tile
  } else {
    constexpr int kBM = kTiles[I][0], kBN = kTiles[I][1], kBK = kTiles[I][2];
    if (bm == kBM && bn == kBN && bk == kBK)
      return launch_encode<kBM, kBN, kBK>(g, w, x, out, c, l, d, vg, vx, s);
    return launch_tile<I + 1>(bm, bn, bk, g, w, x, out, c, l, d, vg, vx, s);
  }
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
// What bounds it on this card: operations, two kinds on separate pipes.
// The product is kernel 2's: 2*C*L*D flops, three TF32 tensor-core
// products per float32 product (3xTF32, as encode_kernel), 3 x 0.61 GFLOP
// at C = 2016, L = 300, D = 501: 3.7 us at 495 TFLOP/s (9.05 us on the
// float32 FMA pipes).  Each generator entry costs one threefry2x32 hash,
// about 80 integer operations (20 rounds of add, funnel-shift and xor,
// five key injections, the counter pairing), and for normal entries about
// 25 float operations more; C*L = 604,800 hashes are 48 M integer
// operations, 2.9 us at the card's 16.7 T INT32 op/s, if each entry is
// hashed once.  The bytes (X, w, P: 4.6 MB) take 1.4 us.  What the
// earlier designs of this kernel lost time to, beyond these: a CTA that
// covers all of D must read all of X (126 x 601 KB of L2 reads at the
// paper's shapes), one 4-byte copy instruction per X element and lane
// (X's rows are not 16-byte aligned at D = 501), and the hash's long
// chain of dependent operations in the warps that issue the products.
//
// What the design does about it:
//   * A cluster of two CTAs along D covers 32 output rows (two m16
//     tiles) by 512 columns, each CTA 256 of them; at C = 2016, D = 501
//     that is 63 pairs, 126 CTAs, one wave on 132 SMs.  Each CTA hashes
//     one m16 tile of the pair's generator rows and stores its split
//     words into both CTAs' shared memory, so every entry is hashed once
//     per launch (ceil(D / 512) times for wider D), and each X element a
//     CTA loads and splits feeds two m16 tiles.
//   * Hash warps beside 8 product warps (8 of them where X comes in by
//     bulk copies, 4 beside the rings, as registers allow).  A hash
//     thread forms two (four) entries of one lane's A fragment of one k8
//     sub-step: their threefry chains first, side by side, then the
//     generator values (the erfinv with compile-time coefficients and
//     no branch around its square root); it scales each by w[k] (one
//     multiply per entry, rounded on its own), splits it into big and
//     small TF32 words once and stores them in the fragment layout, so
//     a product warp reads a sub-step's fragments as 16-byte loads.  No
//     entry goes to device memory.  The hash warps run up to two (three)
//     steps of 32 along L ahead, on a ring of buffers with an mbarrier
//     pair each.  Full: this CTA's hash threads arrive; the partner's
//     fragments (st.async) and the bulk copies complete bytes on it, so
//     no fence crosses the pair.  Empty: every product warp of the pair
//     arrives.  No barrier spans the CTA or the pair in the loop.
//   * X, where it is 16-byte aligned and D <= 512: a step's 32 rows lie
//     whole and contiguous in memory, 16-byte aligned at every step, so
//     each CTA copies 16 of them into both CTAs' buffer with one
//     multicast bulk copy (the last floats past a multiple of 4 one by
//     one): a copy instruction per CTA and step instead of one per
//     element, and X read from L2 once per pair (38 MB).  Elsewhere
//     (misaligned X, wider D) each product warp streams its 32 columns
//     through its own ring by 4-byte cp.async, a step ahead, a sub-step's
//     rows at a time behind that sub-step's fragment loads.
//   * Each product warp owns 32 columns (4 n8 tiles by 2 m16 tiles) and
//     splits each X element it reads once; the products are 3xTF32
//     mma.sync.m16n8k8 (`mma_tf32.cuh`), one fixed chain over L in steps
//     of 8 (small.big, big.small, big.big, issued term by term across the
//     warp's 8 tiles), so relaunches are bit-identical.
//   * The output tile goes out through shared memory, each warp writing
//     whole row segments of its 32 columns.
//   * Entries past L (or rows past C) are 0 and X is 0 past L (zero-
//     filled copies, or zeroed rows of the last bulk step), so the ragged
//     edges add exactly 0; columns past D are computed and not stored;
//     nothing is padded on the host.  (G diag(w)) X rounds each g * w,
//     then splits it, where the plain version forms w * x first: the two
//     differ by rounding, within the float64 bound of
//     ops.float64_reference_and_bound, 1.01 (L + 20) u (|G| |diag(w) X|),
//     and the reference's 2e-4 * max|ref|.  At X = I and w = 1 the kernel
//     returns big + small of each normal entry (exact in the
//     accumulator), within 2^-22 |g| of G, and each Rademacher entry
//     exactly (+-1 splits with small = 0).
//     The flat index is 32-bit, as in the reference; the wrapper raises
//     when C * L reaches 2^31.
//   * accumulate != 0 adds the tile into `out` (out + P, one rounding),
//     so a fleet encode is one launch per client into the composite, in
//     client order, as the reference's scan accumulates.

namespace prng {

constexpr int kPair = 2;         // CTAs of a cluster, along D
constexpr int kBC = 32;          // output rows per CTA: two m16 tiles
constexpr int kBD = 256;         // output columns per CTA
constexpr int kMmaWarps = 8;     // X and the products, 32 columns each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kWN = kBD / kMmaWarps;  // a product warp's columns
constexpr int kNT = kWN / 8;          // its n8 tiles
constexpr int kLaneCols = kWN / 32;   // columns a lane copies and stores
constexpr int kMT = kBC / 16;         // m16 tiles, one hashed by each CTA
constexpr int kBL = 32;               // step along L
constexpr int kSub = kBL / 8;         // k8 sub-steps a step
constexpr int kStages = 3;            // X steps in a warp's ring
constexpr int kXStride = kWN + 8;     // ring rows: 8t + g distinct banks
constexpr int kXStage = kBL * kXStride;  // floats of one step in a ring
constexpr int kAWords = kSub * 32 * 4;   // a step's big (or small) words
constexpr int kATile = kMT * 2 * kAWords;  // a step's A fragments
// The two instances' shared memory.  kBulk: a ring of kBufs<true>
// buffers, each a step's A tile and its X rows (up to kBulkMaxD columns,
// whole rows, as they lie in memory, and room for the reads past D of
// the last row); otherwise each product warp's X ring, then a ring of
// kBufs<false> A tiles.  Then an mbarrier pair per buffer.
constexpr int kBulkMaxD = 512;
constexpr int kBulkStage = kBL * kBulkMaxD + kPair * kBD;
template <bool kBulk>
constexpr int kBufs = kBulk ? 3 : 4;
template <bool kBulk>
constexpr int kBufFloats = kATile + (kBulk ? kBulkStage : 0);
template <bool kBulk>
constexpr int kRingFloats = kBulk ? 0 : kMmaWarps * kStages * kXStage;
template <bool kBulk>
constexpr int kSmemBytes =
    (kRingFloats<kBulk> + kBufs<kBulk> * kBufFloats<kBulk>) * 4 +
    2 * kBufs<kBulk> * 8;
static_assert(kMT == kPair, "each CTA of the pair hashes one m16 tile");
// the generator's warps, beside the product warps: as many as the
// registers of one CTA an SM allow the instance
template <bool kBulk>
constexpr int kHashWarps = kBulk ? 8 : 4;
template <bool kBulk>
constexpr int kThreads = kMmaThreads + 32 * kHashWarps<kBulk>;
template <bool kBulk>
constexpr int kEntries = kAWords / (32 * kHashWarps<kBulk>);  // a thread's
static_assert((kEntries<true> == 2 || kEntries<true> == 4) &&
                  (kEntries<false> == 2 || kEntries<false> == 4),
              "a hash thread forms half a fragment or a whole one");
static_assert(kBC * kXStride <= kStages * kXStage, "output tile in a ring");
static_assert(kMmaWarps * kBC * kXStride <= kBulkStage,
              "output tiles in a stage");
static_assert(kSmemBytes<true> <= 232448 && kSmemBytes<false> <= 232448,
              "shared memory of one CTA");

constexpr int kNormal = 0;      // generator kinds, as ops.py codes them
constexpr int kBernoulli = 1;

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
// The coefficients are compile-time constants and the square root is
// taken for every entry, so that the entries of a hash thread run side by
// side with no load and no branch between them.
__device__ __forceinline__ float erfinv_f32(float x) {
  // XLA's ErfInv32 coefficients, highest power first
  constexpr float kLt5[9] = {
      2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
      0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f,
      1.50140941f};
  constexpr float kGe5[9] = {
      -0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
      0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f,
      2.83297682f};
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  const float sq = sqrtf(w);
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sq, 3.0f);
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __fadd_rn(lt ? kLt5[i] : kGe5[i], __fmul_rn(p, w));
  return __fmul_rn(p, x);
}

// uint32 bits -> generator entry: jax.random's mantissa fill in [1, 2),
// then +-1 (Rademacher) or sqrt(2) * erfinv over [nextafter(-1, 0), 1).
template <int kKind>
__device__ __forceinline__ float bits_to_generator(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  if constexpr (kKind == kBernoulli) {
    return fmaxf(0.0f, f) < 0.5f ? 1.0f : -1.0f;
  } else {
    constexpr float kLo = -0.99999994f;  // nextafter(-1, 0)
    const float u = fmaxf(kLo, __fadd_rn(__fmul_rn(f, 1.0f - kLo), kLo));
    return __fmul_rn(1.41421356f, erfinv_f32(u));
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of shared::cta address `addr` in CTA `rank`
// of the cluster.
__device__ __forceinline__ uint32_t map_to(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Stores into the partner's shared memory at `addr` that complete their
// bytes on its mbarrier at `bar` (both shared::cluster addresses): the
// barrier's phase carries them, no fence is needed.
__device__ __forceinline__ void st_async(uint32_t addr, uint4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, uint2 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n"
      ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Every thread of the pair meets here: what each wrote to either CTA's
// shared memory before is visible to all after.
__device__ __forceinline__ void pair_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// mbarriers (shared::cta addresses; a partner's through map_to)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.release.cta.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar) : "memory");
}

// Arrive on the partner's barrier at `bar` (shared::cluster): a product
// warp's word that it has read a buffer.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of barrier `bar` completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global `src` to shared `dst` of both CTAs of the pair, each copy
// completing its bytes on the mbarrier at `bar` of its CTA.
__device__ __forceinline__ void bulk_to_pair(uint32_t dst, const float* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar),
      "h"(static_cast<uint16_t>(3u)) : "memory");
}

// Floats of X that half h (rows 16 h .. 16 h + 15) of step q holds.
__device__ __forceinline__ int half_floats(int l, int d, int q, int h) {
  return max(0, min(kBL / 2, l - kBL * q - (kBL / 2) * h)) * d;
}

// Step q's X rows into the stage of both CTAs of the pair (kBulk): this
// CTA's half by one multicast bulk copy (completing on each CTA's `full`
// barrier), its last floats past a multiple of 4 one by one.  `stage` is
// this CTA's, `remote` and `remote_full` the partner's (shared::cluster).
__device__ __forceinline__ void stage_step(float* stage, uint32_t remote,
                                           uint32_t full,
                                           uint32_t remote_full,
                                           const float* __restrict__ x,
                                           int l, int d, int q, int rank) {
  const int f = half_floats(l, d, q, rank), fb = f & ~3;
  const int off = (kBL / 2) * rank * d;  // the half's first float
  const float* src = x + static_cast<int64_t>(kBL * q) * d + off;
  if (fb > 0) bulk_to_pair(smem_addr(stage + off), src, 4u * fb, full);
  for (int i = fb; i < f; ++i) {
    const float v = src[i];
    stage[off + i] = v;
    st_async(remote + 4u * (off + i), v, remote_full);
  }
}

// The bytes that step q brings into a CTA's buffer from elsewhere than
// its own threads' stores: the partner's m16 tile of A fragments and,
// kBulk, both halves' bulk copies and the partner's last floats.
template <bool kBulk>
__device__ __forceinline__ uint32_t step_tx(int l, int d, int q,
                                            int partner) {
  uint32_t bytes = 4u * 2 * kAWords;
  if constexpr (kBulk)
    bytes += 4u * ((half_floats(l, d, q, 0) & ~3) +
                   (half_floats(l, d, q, 1) & ~3) +
                   (half_floats(l, d, q, partner) & 3));
  return bytes;
}

// kE entries of one lane's A fragment of one k8 sub-step, (row, k) its
// a0: elements part * kE .. part * kE + kE - 1 of a0 (row, k), a1
// (row + 8, k), a2 (row, k + 4), a3 (row + 8, k + 4), each G's entry
// times w[k] rounded once (0 past C or L), split, and their big and small
// words stored at word `at` and at + kAWords of this CTA's buffers and,
// through `remote`, of the partner's, completing on its barrier at
// `remote_full`.  All the entries' threefry hashes
// come first, so that they run side by side: the erfinv's branches would
// keep the entries apart.
template <int kKind, int kE>
__device__ __forceinline__ void hash_entries(uint32_t* bufs, int at,
                                             uint32_t remote, uint32_t k0,
                                             uint32_t k1,
                                             const float* __restrict__ w,
                                             int c, int l, uint32_t size,
                                             int row, int k, int part,
                                             uint32_t remote_full) {
  uint32_t bits[kE];
  float wk[kE];
  bool in[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int el = part * kE + e;
    const int r = row + 8 * (el & 1), kk = k + 4 * (el >> 1);
    in[e] = r < c && kk < l;
    wk[e] = in[e] ? w[kk] : 0.f;
    bits[e] = bits_at(k0, k1,
                      static_cast<uint32_t>(r) * static_cast<uint32_t>(l) +
                          static_cast<uint32_t>(kk),
                      size);
  }
  uint32_t big[kE], small[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const float v = __fmul_rn(bits_to_generator<kKind>(bits[e]), wk[e]);
    tf32::split(in[e] ? v : 0.f, big[e], small[e]);
  }
  if constexpr (kE == 4) {
    const uint4 vb = make_uint4(big[0], big[1], big[2], big[3]);
    const uint4 vs = make_uint4(small[0], small[1], small[2], small[3]);
    *reinterpret_cast<uint4*>(bufs + at) = vb;
    *reinterpret_cast<uint4*>(bufs + at + kAWords) = vs;
    st_async(remote + 4u * at, vb, remote_full);
    st_async(remote + 4u * (at + kAWords), vs, remote_full);
  } else {
    const uint2 vb = make_uint2(big[0], big[1]);
    const uint2 vs = make_uint2(small[0], small[1]);
    *reinterpret_cast<uint2*>(bufs + at) = vb;
    *reinterpret_cast<uint2*>(bufs + at + kAWords) = vs;
    st_async(remote + 4u * at, vb, remote_full);
    st_async(remote + 4u * (at + kAWords), vs, remote_full);
  }
}

// Start this lane's copies of X rows k0 .. k0 + 7 at columns n + 32 h
// (zero-filled past L and D) into rows r0 .. r0 + 7 of its warp's ring
// stage.
__device__ __forceinline__ void issue_rows(float* stage,
                                           const float* __restrict__ x,
                                           int l, int d, int k0, int r0,
                                           int n, int lane) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int h = 0; h < kLaneCols; ++h) {
      const bool in = k0 + r < l && n + 32 * h < d;
      cp_async<1>(stage + (r0 + r) * kXStride + lane + 32 * h,
                  in ? x + static_cast<int64_t>(k0 + r) * d + n + 32 * h
                     : x, in);
    }
  }
}

template <int kKind, bool kBulk>
__global__ void __launch_bounds__(kThreads<kBulk>, 1)
encode_prng_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ w,
                   const float* __restrict__ x, float* __restrict__ out,
                   int c, int l, int d, int accumulate) {
  constexpr int kB = kBufs<kBulk>;
  constexpr int kBuf = kBufFloats<kBulk>;
  extern __shared__ __align__(16) float smem[];
  // buffer b: bufs + b * kBuf, its A tile, then (kBulk) its X stage
  float* bufs = smem + kRingFloats<kBulk>;
  // full[b] and empty[b] of each buffer, 8 bytes each
  const uint32_t bars = smem_addr(bufs + kB * kBuf);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kBC;
  const int n_steps = (l + kBL - 1) / kBL;
  const uint32_t size = static_cast<uint32_t>(c) * static_cast<uint32_t>(l);
  const uint32_t rank = cluster_rank();  // blockIdx.y % kPair
  const uint32_t partner = rank ^ 1u;
  const uint32_t remote_bars = map_to(bars, partner);
  if (threadIdx.x == 0) {
    for (int b = 0; b < kB; ++b) {
      // full: this CTA's hash threads, and the bytes from elsewhere
      // (step_tx); empty: every product warp of the pair
      mbar_init(bars + 8 * b, 32 * kHashWarps<kBulk>);
      mbar_init(bars + 8 * (kB + b), 2 * kMmaWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  pair_barrier();  // both CTAs run and their barriers are set

  if (warp >= kMmaWarps) {
    // hash warps: this CTA's m16 tile of the pair's generator rows, each
    // thread one lane's A fragment of one sub-step, into both CTAs'
    // buffers, up to kB steps ahead of the products
    constexpr int kE = kEntries<kBulk>;
    const int p = threadIdx.x - kMmaThreads;
    const int slot = p / (4 / kE), part = p % (4 / kE);  // (sub-step, lane)
    const int row = row0 + 16 * static_cast<int>(rank) + (slot % 32) / 4;
    const int k = 8 * (slot / 32) + slot % 4;
    const int at = static_cast<int>(rank) * 2 * kAWords + 4 * slot + kE * part;
    const uint32_t remote = map_to(smem_addr(bufs), partner);
    for (int q = 0; q < n_steps; ++q) {
      const int b = q % kB, u = q / kB;
      if (u > 0)  // both CTAs' product warps are done with its last use
        mbar_wait(bars + 8 * (kB + b), (u - 1) & 1);
      if (p == 0) {
        mbar_expect_tx(bars + 8 * b,
                       step_tx<kBulk>(l, d, q, static_cast<int>(partner)));
        if constexpr (kBulk)
          stage_step(bufs + b * kBuf + kATile,
                     remote + 4u * (b * kBuf + kATile), bars + 8 * b,
                     remote_bars + 8 * b, x, l, d, q,
                     static_cast<int>(rank));
      }
      hash_entries<kKind, kE>(reinterpret_cast<uint32_t*>(bufs),
                              b * kBuf + at, remote, k0, k1, w, c, l, size,
                              row, q * kBL + k, part, remote_bars + 8 * b);
      mbar_arrive(bars + 8 * b);
    }
    pair_barrier();  // nothing of the pair reaches into this CTA any more
    return;
  }

  const int g = lane / 4, t = lane % 4;
  // this lane's columns: n + 32 h, h < kLaneCols
  const int n = blockIdx.y * kBD + warp * kWN + lane;
  float* ring = smem + warp * kStages * kXStage;  // (not kBulk)
  if constexpr (!kBulk) {
    for (int s = 0; s < kStages - 1; ++s) {
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        issue_rows(ring + s * kXStage, x, l, d, s * kBL + 8 * j, 8 * j, n,
                   lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int q = 0; q < n_steps; ++q) {
    const int b = q % kB;
    // X (k, column o) of the step: the warp's ring stage, row stride
    // kXStride, column o - n + lane; or the buffer's stage, whole rows
    const float* xs;
    int x_stride, x_col;
    if constexpr (kBulk) {
      mbar_wait(bars + 8 * b, (q / kB) & 1);  // A hashed and X landed
      float* stage = bufs + b * kBuf + kATile;
      if (q == n_steps - 1) {  // rows past L: zeros, in this warp's columns
        for (int r = l - kBL * q; r < kBL; ++r)
#pragma unroll
          for (int h = 0; h < kLaneCols; ++h) stage[r * d + n + 32 * h] = 0.f;
        __syncwarp();
      }
      xs = stage;
      x_stride = d;
      x_col = n - lane;
    } else {
      cp_async_wait<kStages - 2>();  // this lane's copies of step q
      __syncwarp();  // every lane's; step q - 1's stage is read
      mbar_wait(bars + 8 * b, (q / kB) & 1);  // both halves of A hashed
      xs = ring + (q % kStages) * kXStage;
      x_stride = kXStride;
      x_col = 0;
    }
    float* next = ring + ((q + kStages - 1) % kStages) * kXStage;
    const uint32_t* a_step = reinterpret_cast<const uint32_t*>(bufs) +
                             b * kBuf;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      uint32_t fa_big[kMT][4], fa_small[kMT][4], fb_big[kNT][2],
          fb_small[kNT][2];
      float xv[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int fa = mt * 2 * kAWords + 4 * (32 * j + lane);
        const uint4 ab = *reinterpret_cast<const uint4*>(a_step + fa);
        const uint4 as =
            *reinterpret_cast<const uint4*>(a_step + fa + kAWords);
        fa_big[mt][0] = ab.x; fa_big[mt][1] = ab.y;
        fa_big[mt][2] = ab.z; fa_big[mt][3] = ab.w;
        fa_small[mt][0] = as.x; fa_small[mt][1] = as.y;
        fa_small[mt][2] = as.z; fa_small[mt][3] = as.w;
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // X (k = t, n = g) and (k = t + 4, n = g) of the sub-step
        const int o = (8 * j + t) * x_stride + x_col + nt * 8 + g;
        xv[nt][0] = xs[o];
        xv[nt][1] = xs[o + 4 * x_stride];
      }
      if constexpr (!kBulk)  // a step ahead's copies, a sub-step's rows
        issue_rows(next, x, l, d, (q + kStages - 1) * kBL + 8 * j, 8 * j,
                   n, lane);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        tf32::split(xv[nt][0], fb_big[nt][0], fb_small[nt][0]);
        tf32::split(xv[nt][1], fb_big[nt][1], fb_small[nt][1]);
      }
      // mma3's order on each tile (small.big, big.small, big.big), term by
      // term across the warp's tiles
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          tf32::mma(acc[mt][nt], fa_small[mt], fb_big[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          tf32::mma(acc[mt][nt], fa_big[mt], fb_small[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          tf32::mma(acc[mt][nt], fa_big[mt], fb_big[nt]);
    }
    if constexpr (!kBulk)
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    __syncwarp();  // every lane's reads of buffer b are done
    if (lane == 0 && q + kB < n_steps) {  // a hash step will reuse it
      mbar_arrive(bars + 8 * (kB + b));
      mbar_arrive_remote(remote_bars + 8 * (kB + b));
    }
  }
  if constexpr (!kBulk) cp_async_wait<0>();
  pair_barrier();  // nothing of the pair reaches into this CTA any more

  // the warp's 32 x 32 tile goes out through shared memory, whole rows
  float* s_out = (kBulk ? bufs + kATile : smem) + warp * kBC * kXStride;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int r = mt * 16 + g;
      *reinterpret_cast<float2*>(s_out + r * kXStride + nt * 8 + 2 * t) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(s_out + (r + 8) * kXStride + nt * 8 +
                                 2 * t) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < kLaneCols; ++h) {
    if (n + 32 * h >= d) break;
#pragma unroll 4
    for (int r = 0; r < kBC; ++r) {
      if (row0 + r < c) {
        float* dst = out + static_cast<int64_t>(row0 + r) * d + n + 32 * h;
        const float v = s_out[r * kXStride + lane + 32 * h];
        *dst = accumulate ? *dst + v : v;
      }
    }
  }
}

template <int kKind, bool kBulk>
cudaError_t launch_prng(uint32_t k0, uint32_t k1, const float* w,
                        const float* x, float* out, int c, int l, int d,
                        int accumulate, cudaStream_t s) {
  auto kernel = encode_prng_kernel<kKind, kBulk>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<kBulk>);
  if (e != cudaSuccess) return e;
  // whole pairs along D: a CTA past D hashes its half of the generator
  // rows (and stages its half of X) for its partner and stores nothing
  const int col_ctas = (d + kBD - 1) / kBD;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c + kBC - 1) / kBC,
                     (col_ctas + kPair - 1) / kPair * kPair);
  cfg.blockDim = dim3(kThreads<kBulk>);
  cfg.dynamicSmemBytes = kSmemBytes<kBulk>;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kPair;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e2 = cudaLaunchKernelEx(&cfg, kernel, k0, k1, w, x, out,
                                            c, l, d, accumulate);
  return e2 != cudaSuccess ? e2 : cudaGetLastError();
}

// Kind and instance: whole rows of X by bulk copies where X is 16-byte
// aligned and D <= kBulkMaxD (every step's rows then start 16-byte
// aligned: 32 rows of D floats are a multiple of 4), else 4-byte copies
// through the product warps' rings.
template <int kKind>
cudaError_t launch_prng(uint32_t k0, uint32_t k1, const float* w,
                        const float* x, float* out, int c, int l, int d,
                        int accumulate, cudaStream_t s) {
  return d <= kBulkMaxD && aligned16(x)
             ? launch_prng<kKind, true>(k0, k1, w, x, out, c, l, d,
                                        accumulate, s)
             : launch_prng<kKind, false>(k0, k1, w, x, out, c, l, d,
                                         accumulate, s);
}

}  // namespace prng

}  // namespace

extern "C" {

// g (c, l), w (l,), x (l, d), out (c, d): float32, contiguous, on the
// device of `stream`.  c, l, d > 0.  (bm, bn, bk): one of the
// instantiated tiles (kTiles), else cudaErrorInvalidValue.
int enc_encode_parity(const float* g, const float* w, const float* x,
                      float* out, int c, int l, int d, int bm, int bn, int bk,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies where a matrix's rows allow them
  const bool vg = l % 4 == 0 && aligned16(g);
  const bool vx = d % 4 == 0 && aligned16(x);
  return static_cast<int>(
      launch_tile<0>(bm, bn, bk, g, w, x, out, c, l, d, vg, vx, s));
}

// key (k0, k1); w (l,), x (l, d), out (c, d): float32, contiguous, on
// the device of `stream`; kind 0 normal, 1 Rademacher; accumulate != 0
// adds into out.  c, d > 0 and c * l < 2^31.
int enc_encode_parity_prng(uint32_t k0, uint32_t k1, const float* w,
                           const float* x, float* out, int c, int l, int d,
                           int kind, int accumulate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (kind == prng::kNormal)
    e = prng::launch_prng<prng::kNormal>(k0, k1, w, x, out, c, l, d,
                                         accumulate, s);
  else if (kind == prng::kBernoulli)
    e = prng::launch_prng<prng::kBernoulli>(k0, k1, w, x, out, c, l, d,
                                            accumulate, s);
  return static_cast<int>(e);
}

}  // extern "C"
