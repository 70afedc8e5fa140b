// Causal softmax attention with an online softmax (flash attention) for
// NVIDIA Hopper (sm_90a).
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
// 4 Hq D S (S + 1) / 2 = 34.4 GFLOP against 83.9 MB of q, k, v and o: some
// 400 flops per byte, so the least time is the flops over the card's
// float32 rate outside the tensor cores (0.513 ms at 67 TFLOP/s).  It
// stays full float32 (the model holds its logits at rtol 1e-4 against the
// reference; TF32 keeps ~3 digits).
//
// What the design does about it:
//   * The Pallas grid runs (B*H, S/512, S/512) in order on one core and
//     keeps a 512-row block in VMEM.  Here one 256-thread CTA owns one
//     (b, h, 64-row query tile) and streams 64-row K and V tiles through
//     shared memory, only those at or below the diagonal: tiles strictly
//     above it are never loaded (the Pallas kernel still prefetches them).
//     The heaviest query tiles are scheduled first.
//   * Shared memory holds the scaled Q tile and the K tile d-major
//     ([D][65]), the V tile ([64][D]) and the probability tile ([64][65]):
//     113 KB at D = 128, above the 48 KB a launch gets by default, so the
//     launch raises the limit with cudaFuncSetAttribute first.
//   * Each thread holds a 4 x 4 register block of the score tile and a
//     4 x (D/16) block of the output; the 16 threads of a row group are a
//     half-warp, so the row max and the row sum are shuffle reductions in
//     a fixed order.  The running max, normaliser and accumulator stay in
//     registers across the KV tiles.
//   * Masked scores are -1e30 (the reference's NEG_INF), never -inf, and a
//     masked entry's probability is 0 outright, so a row whose running max
//     is still -1e30 never forms exp(-1e30 - -1e30) = 1 for it.
//   * Query head h reads key/value head h / (Hq / Hkv): the grouping of
//     the model's grouped-query einsum; the repeated K and V of the
//     reference's plain version are never formed.
//   * Operands are addressed through their batch, head and row strides
//     (the last dimension contiguous), so the model's (B, S, H, D)
//     projections are read in place, with no transpose.
//   * q is multiplied by c on load, as the model scales q before the
//     product; expf in full precision (no --use_fast_math); every sum in
//     a fixed order, so two launches on the same inputs are bit-identical.
//     Any S: the ragged tail is masked in the loads and the stores.
//
// A simple kernel that is right comes first: no wgmma (float32 has no
// full-precision tensor-core path), no TMA, no multi-stage pipeline.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_api.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;            // query rows and key rows of a tile
constexpr int kMaxD = 128;
constexpr int kLd = kT + 1;       // row stride of the d-major and P tiles
constexpr int kColGroups = kMaxD / 16;  // output columns per thread
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;  // element strides of batch, head and row; d is 1
};

__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  Strides sq, Strides sk, Strides sv, Strides so, int S,
                  int D, int rep, float scale) {
  extern __shared__ float smem[];
  float* qt = smem;                // [D][kLd]  scaled Q rows, d-major
  float* kt = qt + D * kLd;        // [D][kLd]  K rows, d-major
  float* vs = kt + D * kLd;        // [kT][D]   V rows
  float* ps = vs + kT * D;         // [kT][kLd] probabilities

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / rep;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const float* qh = q + b * sq.b + h * sq.h;
  const float* kh = k + b * sk.b + g * sk.h;
  const float* vh = v + b * sv.b + g * sv.h;
  float* oh = o + b * so.b + h * so.h;

  for (int e = tid; e < kT * D; e += kThreads) {
    const int r = e / D, d = e % D, qr = q0 + r;
    qt[d * kLd + r] = qr < S ? qh[qr * sq.s + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][kColGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kColGroups; ++c) acc[i][c] = 0.f;
  }

  // keys at or below the diagonal of the tile's last row
  const int t_end = min(q0 + kT, S);
  for (int t0 = 0; t0 < t_end; t0 += kT) {
    __syncthreads();  // the last tile's V and P are read (and Q stored)
    for (int e = tid; e < kT * D; e += kThreads) {
      const int r = e / D, d = e % D, tr = t0 + r;
      const bool in = tr < S;
      kt[d * kLd + r] = in ? kh[tr * sk.s + d] : 0.f;
      vs[e] = in ? vh[tr * sv.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[d * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kt[d * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        ok[j] = t <= qr && t < S;
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kLd + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kColGroups; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int t_n = min(kT, S - t0);
    for (int t = 0; t < t_n; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kLd + t];
#pragma unroll
      for (int c = 0; c < kColGroups; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float vv = vs[t * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kColGroups; ++c) {
      const int d = tx + 16 * c;
      if (d < D) oh[qr * so.s + d] = acc[i][c] / den;
    }
  }
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
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || D <= 0 || D > kMaxD ||
      Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(D) * kLd +
                       static_cast<size_t>(kT) * D + kT * kLd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Strides sq{q_b, q_h, q_s}, sk{k_b, k_h, k_s}, sv{v_b, v_h, v_s},
      so{o_b, o_h, o_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_qt = (S + kT - 1) / kT;
  flash_attn_kernel<<<dim3(n_qt, Hq, B), kThreads, smem, st>>>(
      q, k, v, o, sq, sk, sv, so, S, D, Hq / Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
