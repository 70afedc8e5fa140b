// Causal softmax attention with an online softmax (flash attention) for
// NVIDIA Hopper (sm_90a), its two products on the TF32 tensor cores in
// float32 precision (3xTF32, `mma_tf32.cuh`).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py::causal_attention
//   (body _kernel, pallas_call at line 92),
// the attention core of every prefill layer of the attention families
// (repro_torch.models.layers.self_attention).  For each batch b, query
// head h and query row i, with g = h / (Hq / Hkv) the key/value head of h,
//   o[b, h, i] = sum_{j <= i} softmax_j(c q_i . k_j) v_j,   c = 1/sqrt(D),
// the softmax over j <= i in float32 with a running max, normaliser and
// accumulator, as the Pallas kernel carries them across its KV grid axis.
//
// What bounds it on this card: operations.  At the serving shape of
// granite-8b (B, Hq, Hkv, S, D) = (1, 32, 8, 2048, 128) the causal half is
// 4 Hq D S (S + 1) / 2 = 34.4 GFLOP against 83.9 MB of q, k, v and o
// (25.0 us at 3.35 TB/s).  Plain TF32 keeps ~3 digits, which the float32
// rounding bound the kernel is held to does not admit; 3xTF32 does (below)
// at three tensor-core products per float32 product, so the least time is
// 3 x 34.4 GFLOP at the dense TF32 rate of 495 TFLOP/s: 0.208 ms (the
// float32 FMA pipes alone: 0.513 ms at 67 TFLOP/s).
//
// What the design does about it:
//   * Both products run on mma.sync m16n8k8 TF32 tensor-core tiles, each
//     operand split into big + small and multiplied three times into one
//     float32 accumulator (`tf32::mma3`).  mma.sync, not wgmma: wgmma
//     takes TF32 operands only K-major from shared memory, so P.V would
//     need V transposed into a swizzled layout and P written out.
//   * One 128-thread CTA owns one (b, h, 64-row query tile), 16 rows per
//     warp (FlashAttention-2's split: no exchange between warps), and
//     streams 64-key K and V tiles, only those at or below the diagonal,
//     heaviest query tiles first.  A warp skips the products of a KV tile
//     that lies wholly above its 16 rows (arithmetically the same: such a
//     tile would add p = 0 and rescale by exp(0) = 1).
//   * Two CTAs an SM (103,424 bytes of shared memory at D = 128 and at
//     most 255 registers a thread each): the barriers of one CTA and its
//     softmax, which leave the tensor cores idle, overlap the other CTA's
//     products.  With one CTA of 8 warps an SM, every warp in the same
//     phase, the softmax's latency stood in the products' way.
//   * Head size 64 (zamba2-1.2b, whisper-tiny) has its own compile-time
//     instance (kNarrowNd column tiles) planned for three CTAs an SM: its
//     loops over D have fixed counts and its accumulators half of D =
//     128's (142 registers a thread, at most 170 allowed; 54,272 bytes
//     of shared memory a CTA), where the run-time-D instance that D = 64
//     took before keeps D = 128's register plan (198) and holds two.  At
//     D = 64 the products are half of D = 128's while each tile's softmax
//     and barriers stay, so the third CTA an SM is what overlaps them.
//     Two m16 row tiles a warp (each K and V split feeding two products)
//     measured no faster at zamba2's shape and slower at whisper-tiny's
//     (`scripts/flash_attn_variants.py`, PERF.md).
//   * Each warp splits the K and V elements of its fragments as it reads
//     them, from raw float32 tiles: a split of every tile once per CTA
//     into shared memory doubles the bytes each fragment load reads and
//     does not fit two CTAs an SM.  rna is two integer operations
//     (cvt.rna compiles to four).
//   * Shared memory: the scaled Q tile and one K and one V tile, raised
//     above the default 48 KB with cudaFuncSetAttribute.  Rows are D
//     rounded up to 8 (the columns past D zero) plus a pad: Q and K rows
//     8 mod 32 words, so that a half-warp's 8-byte fragment loads fall on
//     16 bank pairs, V rows 4 mod 8 words, for 32 banks.
//   * cp.async brings V tile j while tile j's scores are made and K tile
//     j + 1 while its P.V runs (FlashAttention-2's order; two barriers a
//     tile).  The 16-byte cp.async.cg path needs D % 4 == 0 and every base
//     and stride of q, k, v a multiple of 4 floats; any other view (an odd
//     offset, D = 70) takes a 4-byte cp.async.ca instance of the same
//     kernel, chosen at launch.  Rows past S are zero-filled by the copy.
//   * Scores: each warp computes 16 rows x 64 keys (8 n-tiles, 32 float32
//     accumulators a thread); a k-step takes columns (2t, 2t + 1) as its
//     k-indices (t, t + 4), so each A and B fragment pair is one 8-byte
//     load.  Masks only on tiles that cross the diagonal or the end of S.
//   * P never leaves registers: P.V's k-step covers the 8 keys of one
//     score n-tile in the order (2t, 2t + 1) -> (t, t + 4), so a thread's
//     accumulators c0 c2 c1 c3 of S are its A fragment a0 a1 a2 a3 of P,
//     and the B fragment reads V's rows 2t and 2t + 1.  The output is 16 x
//     D a warp (16 n-tiles, 64 float32 accumulators a thread at D = 128).
//   * A row's scores sit in the 4 lanes of a quad: its max is a tree over
//     the lane's 16 values and two __shfl_xor_sync steps a tile; each lane
//     sums its own probabilities (a tree) and the quad adds the four sums
//     once, at the end, in a fixed order.
//   * Masked scores are -1e30 (the reference's NEG_INF), never -inf, and a
//     masked entry's probability is 0 outright, so a row whose running max
//     is still -1e30 never forms exp(-1e30 - -1e30) = 1 for it.
//   * Query head h reads key/value head h / (Hq / Hkv); operands are read
//     in place through their batch, head and row strides (the last
//     dimension contiguous) and the output written through q's; q is
//     multiplied by c on load; expf in full precision (no
//     --use_fast_math); every sum in a fixed order, so two launches on the
//     same inputs are bit-identical.  Any S, D <= 128.
//
// Short sequences (short_attn_kernel).  The coded-head probe runs
// granite-8b's backbone on 768 sequences of 32 tokens: (B, Hq, Hkv, S, D)
// = (768, 32, 8, 32, 128).  There the kernel above is bound by neither
// bytes (1.007 GB of q, k, v and o, 300 us at 3.35 TB/s) nor operations
// (6.64 GFLOP, ~40 us at the 3xTF32 rate) but by latency and waste: a CTA
// per (b, query head, 64-row tile) is 24,576 CTAs whose tiles are half
// empty (S = 32: two of four warps hold no row and sit through every
// barrier), half of each live warp's score n-tiles and P.V k-steps lie
// past S, each key/value head's K and V are read once for each of its four
// query heads, and V is only asked for after K has landed.  So:
//   * A work item is one key/value head's query group (b, kv): its
//     rep = Hq / Hkv heads x S rows all read the same K and V, and only
//     each row's causal limit differs.  The group's rep S rows are packed
//     into one stack, packed row pm being head kv rep + pm / S at position
//     pm % S, and cut into chunks of 64 rows, one CTA of four warps each
//     (16 rows a warp, as above): every warp tile is full but the last of
//     a group, a tile may hold rows of two heads, and the CTAs of a group
//     are launched next to each other, so its K and V come from device
//     memory about once (a later chunk finds them in L2).  Grid (Hkv x
//     chunks, B): the probe's 12,288 CTAs of full tiles.
//   * S <= 64: one key tile of 32 keys (S <= 32, 4 score n-tiles) or 64
//     (8), fixed at compile time with the column tiles (D = 128 or D = 64);
//     no online rescaling (one tile: the running max starts at -1e30).
//   * K, the chunk's Q rows and V are all in flight at once, three
//     cp.async commit groups in that order; the scores wait for K and Q,
//     P.V for V.  Q is scaled as its fragments are read (__fmul_rn, the
//     same rounding as the stored c q above).  With Q by plain loads
//     issued after V's copy, the scores waited behind V as well: the
//     probe's shape took 714 us, and at S = 64 the short instance was
//     slower than the one above (556 against 480 us; cold, on an H100,
//     `scripts/flash_attn_variants.py --parent`).
//   * What overlaps one CTA's copies is the products of the other CTAs
//     on its SM: at D = 128 and S <= 32, 136 registers a thread and
//     69,120 bytes of shared memory a CTA hold three (two at S <= 64); at
//     D = 64 more.
//   * Taken at S <= 64 with 16-byte copies and D in 121..128 or 57..64,
//     for every rep: at each such shape measured it was the faster (at
//     rep = 1 a tile of S <= 32 is still half empty, but the n-tiles past
//     32 keys are gone); everything else takes the instances above,
//     unchanged.
// Each packed row runs the k-steps, mask, max and sum trees and P.V of
// the instance above on its single key tile, leaving out only n-tiles
// and k-steps whose keys are all past S (a max is exact, a masked
// probability is 0 and its products add 0), so the short instances'
// results are the D = 128 and D = 64 instances' bit for bit.
//
// The split's error.  A product term leaves out at most about 12 u |a||b|
// (u = 2^-24); each MMA adds to its accumulator with an error of at most
// about 2 u of the partial sum (tensor cores truncate inside an MMA: Fasi,
// Higham, Mikaitis and Pranesh, PeerJ CS 2021).  A score's first-order
// worst case is therefore (12 + 0.75 D + 2) u c |q||k| against the
// (D + 4) u c |q||k| of `kernels.flash_attn.ref.float64_reference_and_
// bound`: inside it for D >= 40; at D = 8, 16 and 32 the bound is tighter
// than the split's own worst case and holds by the errors' cancellation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_api.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBq = 16 * kWarps;  // query rows of a CTA, 16 per warp
constexpr int kBk = 64;           // keys of a K/V tile
constexpr int kSt = kBk / 8;      // score n-tiles a warp holds
constexpr int kMaxNd = 16;        // 8-wide column tiles of D <= 128
constexpr int kNarrowNd = 8;      // those of D in 57..64 (head size 64)
constexpr int kShortMaxS = 64;    // the short instances' longest sequence
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;  // element strides of batch, head and row; d is 1
};

// Row strides (floats) of the shared tiles, D rounded up to 8 nd plus a
// pad.  Q and K: 8 mod 32, so that a half-warp's 8-byte fragment loads
// (rows g, columns 2t and 2t + 1) fall on 16 distinct bank pairs.  V:
// 4 mod 8, so that its B fragment (rows 2t, column g) falls on 32 banks.
__host__ __device__ constexpr int qk_stride(int nd) {
  return 8 * nd + (40 - 8 * nd % 32) % 32;
}
__host__ __device__ constexpr int v_stride(int nd) { return 8 * nd + 4; }

__host__ __device__ constexpr size_t smem_bytes(int nd) {
  return sizeof(float) *
         ((kBq + kBk) * qk_stride(nd) + kBk * v_stride(nd));
}

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes (kVec) or 4 from global to shared memory; with `read`
// false nothing is read and the destination is zero-filled.
template <bool kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool read) {
  if constexpr (kVec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(read ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(read ? 4 : 0));
  }
}

// Start the copy of `rows` (<= kRows) rows of D floats at `src` (row
// stride `ss`) into a kRows-row shared tile as one commit group; rows past
// `rows` are zero-filled.
template <bool kVec, int kRows = kBk>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int64_t ss, int rows, int D,
                                          int ld) {
  constexpr int w = kVec ? 4 : 1;
  const int per_row = D / w;
  for (int e = threadIdx.x; e < kRows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * w;
    const bool in = r < rows;
    cp_async<kVec>(dst + r * ld + c, src + (in ? r * ss + c : 0), in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies, then for every thread's: the tile is in
// shared memory for the whole CTA.
__device__ __forceinline__ void tile_landed() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Row max and row sum over a quad's 2 kN values of one row (kN score
// n-tiles), in a fixed tree order.  With kN = 4 the trees are those of
// kN = 8 with the upper four n-tiles left out: a max is exact, and those
// tiles' probabilities are 0, which adds nothing (x + 0 = x).
template <int kN>
__device__ __forceinline__ float row_max(const float (&s)[kN][4], int e) {
  float x[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) x[j] = fmaxf(s[j][e], s[j][e + 1]);
#pragma unroll
  for (int w = kN / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) x[j] = fmaxf(x[j], x[j + w]);
  return x[0];
}

template <int kN>
__device__ __forceinline__ float row_sum(const float (&s)[kN][4], int e) {
  float x[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) x[j] = s[j][e] + s[j][e + 1];
#pragma unroll
  for (int w = kN / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) x[j] = x[j] + x[j + w];
  return x[0];
}

// kNd: the 8-wide column tiles of D, fixed at compile time (kMaxNd: D in
// 121..128; kNarrowNd: D in 57..64), or 0 for a count read at run time.
template <bool kVec, int kNd>
__global__ void __launch_bounds__(kThreads, kNd == kNarrowNd ? 3 : 2)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  Strides sq, Strides sk, Strides sv, Strides so, int S,
                  int D, int rep, float scale) {
  const int nd = kNd ? kNd : (D + 7) / 8;
  const int ld = qk_stride(nd), ldv = v_stride(nd);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBq][ld] scaled Q rows
  float* ks = qs + kBq * ld;                    // [kBk][ld] K rows
  float* vs = ks + kBk * ld;                    // [kBk][ldv] V rows

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const float* qh = q + b * sq.b + h * sq.h;
  const float* kh = k + b * sk.b + (h / rep) * sk.h;
  const float* vh = v + b * sv.b + (h / rep) * sv.h;
  float* oh = o + b * so.b + h * so.h;

  // keys at or below the diagonal of the tile's last row
  const int n_kv = (min(q0 + kBq, S) + kBk - 1) / kBk;
  copy_tile<kVec>(ks, kh, sk.s, min(kBk, S), D, ld);

  // columns D .. 8 nd - 1 of the K and V tiles stay zero
  const int pad = 8 * nd - D;
  for (int e = tid; e < kBk * pad; e += kThreads) {
    const int r = e / pad, c = D + e - r * pad;
    ks[r * ld + c] = 0.f;
    vs[r * ldv + c] = 0.f;
  }
  // the scaled Q tile, zero past S and past D
  for (int e = tid; e < kBq * 2 * nd; e += kThreads) {
    const int r = e / (2 * nd), c = (e - r * 2 * nd) * 4, qr = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qr < S) {
      const float* src = qh + qr * sq.s + c;
      if constexpr (kVec) {
        if (c < D) x = *reinterpret_cast<const float4*>(src);
      } else {
        x.x = c < D ? src[0] : 0.f;
        x.y = c + 1 < D ? src[1] : 0.f;
        x.z = c + 2 < D ? src[2] : 0.f;
        x.w = c + 3 < D ? src[3] : 0.f;
      }
    }
    *reinterpret_cast<float4*>(qs + r * ld + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  const int r0 = q0 + 16 * warp;  // the warp's first row
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kMaxNd][4];
#pragma unroll
  for (int j = 0; j < kMaxNd; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int t0 = it * kBk;
    // K tile it in place (and Q, at it = 0); every warp is past P.V of
    // tile it - 1, so V tile it may land while the scores are made
    tile_landed();
    copy_tile<kVec>(vs, vh + t0 * sv.s, sv.s, min(kBk, S - t0), D, ldv);
    // a warp whose 16 rows all lie above the tile keeps no key of it
    const bool active = r0 < S && r0 + 15 >= t0;

    // s = (c Q) K^T over this warp's 16 rows and the tile's 64 keys;
    // k-step kk takes columns 8 kk + (2t, 2t + 1) as (t, t + 4)
    float s[kSt][4];
#pragma unroll
    for (int j = 0; j < kSt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if (active) {
#pragma unroll 2
      for (int kk = 0; kk < nd; ++kk) {
        const float* qa = qs + (16 * warp + g) * ld + 8 * kk + 2 * t;
        const float2 q_g = *reinterpret_cast<const float2*>(qa);
        const float2 q_g8 = *reinterpret_cast<const float2*>(qa + 8 * ld);
        uint32_t a_big[4], a_small[4];
        tf32::split(q_g.x, a_big[0], a_small[0]);
        tf32::split(q_g8.x, a_big[1], a_small[1]);
        tf32::split(q_g.y, a_big[2], a_small[2]);
        tf32::split(q_g8.y, a_big[3], a_small[3]);
#pragma unroll
        for (int j = 0; j < kSt; ++j) {
          const float2 kb = *reinterpret_cast<const float2*>(
              ks + (8 * j + g) * ld + 8 * kk + 2 * t);
          uint32_t b_big[2], b_small[2];
          tf32::split(kb.x, b_big[0], b_small[0]);
          tf32::split(kb.y, b_big[1], b_small[1]);
          tf32::mma3(s[j], a_big, a_small, b_big, b_small);
        }
      }

      // element (j, e) is row r0 + g + 8 (e / 2), key t0 + 8 j + 2 t + e % 2
      const bool masked = t0 + kBk - 1 > r0 || t0 + kBk > S;
      if (masked) {
#pragma unroll
        for (int j = 0; j < kSt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t0 + 8 * j + 2 * t + (e & 1);
            if (key > r0 + g + 8 * (e >> 1) || key >= S) s[j][e] = kNegInf;
          }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(m[i], row_max(s, 2 * i));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = expf(m[i] - mx);
        m[i] = mx;
      }
#pragma unroll
      for (int j = 0; j < kSt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]);
      if (masked) {  // a masked probability is 0 outright
#pragma unroll
        for (int j = 0; j < kSt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t0 + 8 * j + 2 * t + (e & 1);
            if (key > r0 + g + 8 * (e >> 1) || key >= S) s[j][e] = 0.f;
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + row_sum(s, 2 * i);
#pragma unroll
      for (int j = 0; j < kMaxNd; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    }

    // V tile it in place; every warp is past the scores of K tile it, so
    // K tile it + 1 may land while P.V runs
    tile_landed();
    if (it + 1 < n_kv)
      copy_tile<kVec>(ks, kh + (t0 + kBk) * sk.s, sk.s,
                      min(kBk, S - t0 - kBk), D, ld);
    if (!active) continue;

    // acc += P V; k-step kk takes keys 8 kk + (2t, 2t + 1) as (t, t + 4)
#pragma unroll
    for (int kk = 0; kk < kSt; ++kk) {
      uint32_t a_big[4], a_small[4];
      tf32::split(s[kk][0], a_big[0], a_small[0]);
      tf32::split(s[kk][2], a_big[1], a_small[1]);
      tf32::split(s[kk][1], a_big[2], a_small[2]);
      tf32::split(s[kk][3], a_big[3], a_small[3]);
      const float* vb = vs + (8 * kk + 2 * t) * ldv + g;
#pragma unroll
      for (int j = 0; j < kMaxNd; ++j) {
        if (j < nd) {
          uint32_t b_big[2], b_small[2];
          tf32::split(vb[8 * j], b_big[0], b_small[0]);
          tf32::split(vb[ldv + 8 * j], b_big[1], b_small[1]);
          tf32::mma3(acc[j], a_big, a_small, b_big, b_small);
        }
      }
    }
  }

  // the quad's four partial sums of each row, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = r0 + g + 8 * i;
    if (qr >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = oh + qr * so.s;
#pragma unroll
    for (int j = 0; j < kMaxNd; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (j < nd && d < D) orow[d] = acc[j][2 * i + e] / den;
      }
  }
}

template <bool kVec, int kNd>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int Hq, int S, int D, int rep, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale,
                   cudaStream_t st) {
  const size_t smem = smem_bytes((D + 7) / 8);
  auto* kernel = flash_attn_kernel<kVec, kNd>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)  // room for two CTAs an SM
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int n_qt = (S + kBq - 1) / kBq;
  kernel<<<dim3(n_qt, Hq, B), kThreads, smem, st>>>(q, k, v, o, sq, sk, sv,
                                                    so, S, D, rep, scale);
  return cudaGetLastError();
}

// The short-sequence instance: S <= 8 kKt keys, one key/value head's
// query group packed into the rows of a CTA (see the header).  kNd as
// flash_attn_kernel's compile-time instances (kMaxNd or kNarrowNd); kKt
// the score n-tiles of the one key tile (4: S <= 32, 8: S <= 64).  The
// grid is (Hkv x chunks, B); chunk c of key/value head kv holds packed rows
// kBq c .. kBq c + kBq - 1 of the group's rep S rows, packed row pm being
// query head kv rep + pm / S at position pm % S.
template <int kNd, int kKt>
__global__ void __launch_bounds__(kThreads, kNd == kNarrowNd ? 3 : 2)
short_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  Strides sq, Strides sk, Strides sv, Strides so, int S,
                  int D, int rep, float scale) {
  constexpr int nd = kNd, keys = 8 * kKt;
  constexpr int ld = qk_stride(nd), ldv = v_stride(nd);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBq][ld] Q rows
  float* ks = qs + kBq * ld;                    // [keys][ld] K rows
  float* vs = ks + keys * ld;                   // [keys][ldv] V rows

  const int M = rep * S;  // the group's packed rows
  const int n_chunks = (M + kBq - 1) / kBq;
  const int kv = blockIdx.x / n_chunks, b = blockIdx.y;
  const int m0 = (blockIdx.x - kv * n_chunks) * kBq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // K, the chunk's Q rows and V in flight together, three commit groups
  // in that order: the scores wait for the first two only.  Q rows past
  // the group's M are zero-filled; Q is scaled as its fragments are read.
  copy_tile<true, keys>(ks, k + b * sk.b + kv * sk.h, sk.s, S, D, ld);
  const float* qb = q + b * sq.b;
  const int per_row = D / 4;
  for (int e = tid; e < kBq * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * 4, pm = m0 + r;
    const bool in = pm < M;
    const int h = kv * rep + pm / S, i = pm - (pm / S) * S;
    cp_async<true>(qs + r * ld + c, in ? qb + h * sq.h + i * sq.s + c : qb,
                   in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  copy_tile<true, keys>(vs, v + b * sv.b + kv * sv.h, sv.s, S, D, ldv);
  // columns D .. 8 nd - 1 of the Q, K and V tiles stay zero
  const int pad = 8 * nd - D;
  for (int e = tid; e < (kBq + keys) * pad; e += kThreads) {
    const int r = e / pad, c = D + e - r * pad;
    qs[r * ld + c] = 0.f;  // the K tile follows Q's rows
    if (r < keys) vs[r * ldv + c] = 0.f;
  }

  // K and Q in place (V may still be in flight)
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  const int r0 = m0 + 16 * warp;  // the warp's first packed row
  const bool active = r0 < M;
  // the positions of this thread's two rows (0 for a row past M: it keeps
  // key 0 and is not stored)
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pm = r0 + g + 8 * i;
    pos[i] = pm < M ? pm % S : 0;
  }

  // s = (c Q) K^T over this warp's 16 rows and the tile's keys; k-step kk
  // takes columns 8 kk + (2t, 2t + 1) as (t, t + 4)
  float s[kKt][4];
#pragma unroll
  for (int j = 0; j < kKt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  float l[2] = {0.f, 0.f};
  if (active) {
#pragma unroll 2
    for (int kk = 0; kk < nd; ++kk) {
      const float* qa = qs + (16 * warp + g) * ld + 8 * kk + 2 * t;
      const float2 q_g = *reinterpret_cast<const float2*>(qa);
      const float2 q_g8 = *reinterpret_cast<const float2*>(qa + 8 * ld);
      // c q rounded once, as the other instances store it (__fmul_rn: no
      // contraction into the split's subtraction)
      uint32_t a_big[4], a_small[4];
      tf32::split(__fmul_rn(q_g.x, scale), a_big[0], a_small[0]);
      tf32::split(__fmul_rn(q_g8.x, scale), a_big[1], a_small[1]);
      tf32::split(__fmul_rn(q_g.y, scale), a_big[2], a_small[2]);
      tf32::split(__fmul_rn(q_g8.y, scale), a_big[3], a_small[3]);
#pragma unroll
      for (int j = 0; j < kKt; ++j) {
        const float2 kb = *reinterpret_cast<const float2*>(
            ks + (8 * j + g) * ld + 8 * kk + 2 * t);
        uint32_t b_big[2], b_small[2];
        tf32::split(kb.x, b_big[0], b_small[0]);
        tf32::split(kb.y, b_big[1], b_small[1]);
        tf32::mma3(s[j], a_big, a_small, b_big, b_small);
      }
    }

    // element (j, e) is position pos[e / 2], key 8 j + 2 t + e % 2 (a key
    // past S lies past every position); one key tile, so the running max
    // starts at -1e30 and no sum is rescaled
#pragma unroll
    for (int j = 0; j < kKt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        if (key > pos[e >> 1]) s[j][e] = kNegInf;
      }
    float m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(kNegInf, row_max(s, 2 * i));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      m[i] = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    }
#pragma unroll
    for (int j = 0; j < kKt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        s[j][e] = key > pos[e >> 1]
                      ? 0.f  // a masked probability is 0 outright
                      : expf(s[j][e] - m[e >> 1]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = row_sum(s, 2 * i);
  }

  // V in place
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (!active) return;

  // acc = P V; k-step kk takes keys 8 kk + (2t, 2t + 1) as (t, t + 4)
  float acc[nd][4];
#pragma unroll
  for (int j = 0; j < nd; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKt; ++kk) {
    uint32_t a_big[4], a_small[4];
    tf32::split(s[kk][0], a_big[0], a_small[0]);
    tf32::split(s[kk][2], a_big[1], a_small[1]);
    tf32::split(s[kk][1], a_big[2], a_small[2]);
    tf32::split(s[kk][3], a_big[3], a_small[3]);
    const float* vb = vs + (8 * kk + 2 * t) * ldv + g;
#pragma unroll
    for (int j = 0; j < nd; ++j) {
      uint32_t b_big[2], b_small[2];
      tf32::split(vb[8 * j], b_big[0], b_small[0]);
      tf32::split(vb[ldv + 8 * j], b_big[1], b_small[1]);
      tf32::mma3(acc[j], a_big, a_small, b_big, b_small);
    }
  }

  // the quad's four partial sums of each row, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pm = r0 + g + 8 * i;
    if (pm >= M) continue;
    const int h = kv * rep + pm / S;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + b * so.b + h * so.h + pos[i] * so.s;
#pragma unroll
    for (int j = 0; j < nd; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < D) orow[d] = acc[j][2 * i + e] / den;
      }
  }
}

__host__ __device__ constexpr size_t short_smem_bytes(int nd, int kt) {
  return sizeof(float) *
         ((kBq + 8 * kt) * qk_stride(nd) + 8 * kt * v_stride(nd));
}

template <int kNd, int kKt>
cudaError_t launch_short(const float* q, const float* k, const float* v,
                         float* o, int B, int Hkv, int S, int D, int rep,
                         Strides sq, Strides sk, Strides sv, Strides so,
                         float scale, cudaStream_t st) {
  constexpr size_t smem = short_smem_bytes(kNd, kKt);
  auto* kernel = short_attn_kernel<kNd, kKt>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int n_chunks = (rep * S + kBq - 1) / kBq;
  kernel<<<dim3(Hkv * n_chunks, B), kThreads, smem, st>>>(
      q, k, v, o, sq, sk, sv, so, S, D, rep, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The instance a call takes: 1 the D = 128 one (nd = kMaxNd), 2 the
// head-size-64 one (nd = kNarrowNd), both with 16-byte copies (vec);
// 0 the run-time-D instance (any other D, or a view that takes 4-byte
// copies); at S <= kShortMaxS with 16-byte copies and nd = kMaxNd or
// kNarrowNd the short instances, 3 and 4 (D = 128 at S <= 32 and at
// 33..64), 5 and 6 (D = 64 the same).  The compile-time instances compute
// what the run-time one computes, in the same order: their results are
// its bit for bit.
int instance(int D, bool vec, int S) {
  const int nd = (D + 7) / 8;
  if (!vec || (nd != kMaxNd && nd != kNarrowNd)) return 0;
  if (S <= kShortMaxS) return (nd == kMaxNd ? 3 : 5) + (S > 32 ? 1 : 0);
  return nd == kMaxNd ? 1 : 2;
}

}  // namespace

extern "C" {

// q (B, Hq, S, D), k and v (B, Hkv, S, D), o (B, Hq, S, D): float32 on the
// device of `stream`, each addressed by its batch, head and row strides
// (in elements; the last dimension contiguous).  Hkv divides Hq; every
// extent > 0, D <= 128, B and Hq <= 65535; otherwise it returns
// cudaErrorInvalidValue.  `scale` multiplies q (1/sqrt(D) in float32).
// Where `chosen` is not null, the instance launched is written there (the
// codes of flash_attn_instance).
int flash_attn_launch(const float* q, const float* k, const float* v,
                      float* o, int B, int Hq, int Hkv, int S, int D,
                      long long q_b, long long q_h, long long q_s,
                      long long k_b, long long k_h, long long k_s,
                      long long v_b, long long v_h, long long v_s,
                      long long o_b, long long o_h, long long o_s,
                      float scale, void* stream, int* chosen) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || D <= 0 ||
      D > 8 * kMaxNd || Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_b, q_h, q_s}, sk{k_b, k_h, k_s}, sv{v_b, v_h, v_s},
      so{o_b, o_h, o_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = Hq / Hkv;
  // 16-byte copies: whole 4-float chunks, every row start 16-byte aligned
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) &&
                   ((q_b | q_h | q_s | k_b | k_h | k_s | v_b | v_h | v_s) &
                    3) == 0;
  const int inst = instance(D, vec, S);
  if (chosen != nullptr) *chosen = inst;
  cudaError_t e;
  if (inst == 1)
    e = launch<true, kMaxNd>(q, k, v, o, B, Hq, S, D, rep, sq, sk, sv, so,
                             scale, st);
  else if (inst == 2)
    e = launch<true, kNarrowNd>(q, k, v, o, B, Hq, S, D, rep, sq, sk, sv,
                                so, scale, st);
  else if (inst == 3)
    e = launch_short<kMaxNd, 4>(q, k, v, o, B, Hkv, S, D, rep, sq, sk, sv,
                                so, scale, st);
  else if (inst == 4)
    e = launch_short<kMaxNd, 8>(q, k, v, o, B, Hkv, S, D, rep, sq, sk, sv,
                                so, scale, st);
  else if (inst == 5)
    e = launch_short<kNarrowNd, 4>(q, k, v, o, B, Hkv, S, D, rep, sq, sk,
                                   sv, so, scale, st);
  else if (inst == 6)
    e = launch_short<kNarrowNd, 8>(q, k, v, o, B, Hkv, S, D, rep, sq, sk,
                                   sv, so, scale, st);
  else if (vec)
    e = launch<true, 0>(q, k, v, o, B, Hq, S, D, rep, sq, sk, sv, so, scale,
                        st);
  else
    e = launch<false, 0>(q, k, v, o, B, Hq, S, D, rep, sq, sk, sv, so, scale,
                         st);
  return static_cast<int>(e);
}

// The dynamic shared memory (bytes) of one CTA of the kernel at head size
// D, or -1 for a D that flash_attn_launch refuses.
int flash_attn_smem_bytes(int D) {
  return D > 0 && D <= 8 * kMaxNd ? static_cast<int>(smem_bytes((D + 7) / 8))
                                  : -1;
}

// The instance flash_attn_launch takes at head size D and S rows, with
// 16-byte copies (vec != 0) or 4-byte ones: 0 the run-time-D one, 1
// D = 128's, 2 D = 64's, 3-6 the short ones (D = 128 at S <= 32 and
// S <= 64, D = 64 the same).  The number of query heads a key/value head
// does not enter: at every one measured the rule's choice was the faster.
int flash_attn_instance(int D, int vec, int S) {
  return instance(D, vec != 0, S);
}

}  // extern "C"
