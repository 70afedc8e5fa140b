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

// Start the copy of `rows` (<= kBk) rows of D floats at `src` (row stride
// `ss`) into a kBk-row shared tile as one commit group; rows past `rows`
// are zero-filled.
template <bool kVec>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int64_t ss, int rows, int D,
                                          int ld) {
  constexpr int w = kVec ? 4 : 1;
  const int per_row = D / w;
  for (int e = threadIdx.x; e < kBk * per_row; e += kThreads) {
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

// Row max and row sum over a quad's 16 values of one row, in a fixed tree
// order.
__device__ __forceinline__ float max16(const float (&s)[kSt][4], int e) {
  float x[kSt];
#pragma unroll
  for (int j = 0; j < kSt; ++j) x[j] = fmaxf(s[j][e], s[j][e + 1]);
#pragma unroll
  for (int w = kSt / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) x[j] = fmaxf(x[j], x[j + w]);
  return x[0];
}

__device__ __forceinline__ float sum16(const float (&s)[kSt][4], int e) {
  float x[kSt];
#pragma unroll
  for (int j = 0; j < kSt; ++j) x[j] = s[j][e] + s[j][e + 1];
#pragma unroll
  for (int w = kSt / 2; w > 0; w /= 2)
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
        float mx = fmaxf(m[i], max16(s, 2 * i));
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
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum16(s, 2 * i);
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The instance a call takes: 1 the D = 128 one (nd = kMaxNd), 2 the
// head-size-64 one (nd = kNarrowNd), both with 16-byte copies (vec);
// 0 the run-time-D instance (any other D, or a view that takes 4-byte
// copies).  The compile-time instances compute what the run-time one
// computes, in the same order: their results are its bit for bit.
int instance(int D, bool vec) {
  const int nd = (D + 7) / 8;
  if (!vec) return 0;
  return nd == kMaxNd ? 1 : nd == kNarrowNd ? 2 : 0;
}

}  // namespace

extern "C" {

// q (B, Hq, S, D), k and v (B, Hkv, S, D), o (B, Hq, S, D): float32 on the
// device of `stream`, each addressed by its batch, head and row strides
// (in elements; the last dimension contiguous).  Hkv divides Hq; every
// extent > 0, D <= 128, B and Hq <= 65535; otherwise it returns
// cudaErrorInvalidValue.  `scale` multiplies q (1/sqrt(D) in float32).
int flash_attn_launch(const float* q, const float* k, const float* v,
                      float* o, int B, int Hq, int Hkv, int S, int D,
                      long long q_b, long long q_h, long long q_s,
                      long long k_b, long long k_h, long long k_s,
                      long long v_b, long long v_h, long long v_s,
                      long long o_b, long long o_h, long long o_s,
                      float scale, void* stream) {
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
  const int inst = instance(D, vec);
  cudaError_t e;
  if (inst == 1)
    e = launch<true, kMaxNd>(q, k, v, o, B, Hq, S, D, rep, sq, sk, sv, so,
                             scale, st);
  else if (inst == 2)
    e = launch<true, kNarrowNd>(q, k, v, o, B, Hq, S, D, rep, sq, sk, sv,
                                so, scale, st);
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

// The instance flash_attn_launch takes at head size D with 16-byte copies
// (vec != 0) or 4-byte ones: 1 D = 128's, 2 D = 64's, 0 the run-time-D
// one.
int flash_attn_instance(int D, int vec) { return instance(D, vec != 0); }

}  // extern "C"
