// Mamba2 SSD intra-chunk step for NVIDIA Hopper (sm_90a), its three
// products on the TF32 tensor cores in float32 precision (3xTF32,
// `mma_tf32.cuh`).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/ssd.py::ssd_chunk
//   (body _kernel, pallas_call at line 69),
// the heavy half of the chunked SSD scan (repro.models.ssm.ssd_chunked)
// that every prefill of a Mamba2 layer runs.  For each (batch, chunk,
// head h of group g), with cum the inclusive prefix sum of da over the
// chunk,
//   S[q, t]     = C_q . B_t                         (depends on g only)
//   y[q, p]     = sum_{t <= q} S[q, t] exp(cum_q - cum_t) dt_t x_t[p]
//   state[p, n] = sum_q exp(cum_{Q-1} - cum_q) dt_q x_q[p] B_q[n].
// The inter-chunk recurrence stays outside, in the model.
//
// What bounds it on this card: operations.  At the serving shape of
// mamba2-1.3b, (B, nc, Q, H, P, N, G) = (1, 8, 256, 64, 64, 128, 1), the
// least work takes the scores once per (chunk, group): B nc (G Q(Q+1)/2
// 2N + H (Q(Q+1)/2 2P + 2 Q P N)) = 4.37 GFLOP against 87 MB of operands
// and results.  The reference's rtol 1e-4 and the float64 rounding bound
// of `kernels.ssd.ref.float64_reference_and_bound` rule out plain TF32,
// so every product is three TF32 tensor-core products: 3 x 4.37 GFLOP at
// 495 TFLOP/s, 26.5 us (on the float32 FMA pipes 65 us).
//
// What the design does about it:
//   * Two kinds of 256-thread CTA in one launch.  A y CTA owns (batch,
//     chunk, 64-row query tile, up to kHB = 8 heads of one group): it forms
//     its rows of C B^T over the key tiles at or below the diagonal once,
//     into shared memory, and then, head after head, applies that head's
//     decay and the causal mask and multiplies with that head's dt x.  The
//     scores are built G nc (Q/64) (H/G/8) times, not H nc (Q/64) times:
//     at the serving shape 8x fewer than once per head.  A state CTA owns
//     (batch, chunk, a block of whole heads of one group stacked to at
//     most 128 rows of (head, p), 128 columns of N): the stacked product
//     (dec dt x)^T B, B staged once for all its heads, x read once per
//     head.  The CTAs are ordered heaviest first: y tiles by descending
//     query tile, then the state CTAs, then the first query tile; the
//     block index runs over the chunks fastest, so the order holds across
//     the grid.  At the serving shape: 256 y CTAs and 256 state CTAs, one
//     CTA (8 warps) an SM.
//   * Every product is mma.sync m16n8k8 TF32 in three passes (small.big,
//     big.small, big.big into one float32 accumulator, `tf32::mma3`'s
//     order).  mma.sync, not wgmma: wgmma takes TF32 operands only
//     K-major from shared memory, and the decayed scores are formed in
//     registers, per head.  The passes are issued term by term across a
//     warp's tiles (`mma3_tiles`) and nothing is predicated around them:
//     tiles past P, N or Q hold zeros and add exact zeros, and the stores
//     mask: guards around them put each tile's three dependent HMMAs
//     in a row through one temporary register (seen in the SASS), which
//     left the tensor cores waiting.
//   * Each CTA walks one sequence of steps through one pipeline: a ring of
//     kStages raw stages that cp.async fills up to three steps ahead, and
//     two split tiles.  A step's staged operands (C and B slices for a
//     score step, a 64 x 64 x tile for a y step, 16 rows of x and of B
//     for a state step) are split into (big, small) TF32 words once, when
//     they leave the raw stage (x times dt, and for the state also times
//     the decay to the chunk end, each rounded once, as the plain version
//     rounds them); the fragments then load ready-made words, one 16-byte
//     load for two k-values.  One barrier a step.
//   * y: warp w takes rows 16 (w % 4) .. + 15 and the k-steps of 8 keys
//     of parity w / 4 in every key tile; per k-step it loads its scores
//     (two 8-byte loads), multiplies them by exp(cum_q - cum_t), splits
//     them in registers and issues the products with the head's dt x
//     tile.  The causal mask is on the exponent (-inf where t > q, so the
//     decay is 0 and no branch skips an expf); the score tile is zeroed
//     first, so what a warp skips above its rows is a finite 0.  On the
//     diagonal tile a warp stops at its last row.  At the end of a head
//     the odd-parity warps hand their sums through shared memory to the
//     even ones, which add them (always in that order) and store y.
//   * The tables (below) are made while the CTA's first copies are in
//     flight; each lane loads its segment of da and dt at once.
//   * The prefix sum of da is taken in float64 and rounded once to
//     float32, so the kernel and the plain version (torch.cumsum in
//     float64, rounded) compute the same decays: at the model's own inputs
//     |cum| reaches ~3e3 within a chunk, where a float32 prefix sum carries
//     ~1e-3 relative error that depends on the order of the additions.
//     One warp a head: each lane sums a contiguous segment, a shuffle scan
//     adds the segments in lane order, each lane re-walks its segment.
//   * expf in full precision (no --use_fast_math); every sum in a fixed
//     order and no atomics, so two launches on the same inputs are
//     bit-identical.  Ragged Q, P and N and a head block that does not
//     divide H/G are masked in the copies (zero-filled), the products and
//     the stores; nothing is padded on the host.  The 16-byte cp.async
//     instance needs P and N multiples of 4 and x, B and C 16-byte
//     aligned; any other call takes the 4-byte instance.
//   * The limit: a y CTA holds its 64 rows of scores for the whole chunk
//     and the decays and dt of its heads, so Q <= kMaxQ = 256 (what one
//     CTA's 227 KB of shared memory hold beside the pipeline);
//     ssd_chunk_launch refuses a longer chunk.
//
// The split's error.  A product term leaves out at most about 12 u |a||b|
// (u = 2^-24) and each MMA truncates its float32 sum (~2 u of the partial
// sum).  An output of y therefore carries, per term, about (14 + 0.75 N) u
// from the scores, u from the decay, 12 u from the split of the decayed
// score and 0.75 Q u + 2 u from the sum over t, against the (N + Q + 5) u
// per term of `kernels.ssd.ref.float64_reference_and_bound`: inside it
// for N + Q >= 100; at smaller chunks the bound holds by the errors'
// cancellation (`tests/test_torch_ssd_tf32.py` emulates this arithmetic
// on the CPU and prints the share).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_api.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;     // query rows of a y CTA; keys of a key tile
constexpr int kHB = 8;     // heads of a y CTA, all of one group
constexpr int kNC = 16;    // columns of N a score step stages
constexpr int kSK = 16;    // rows q a state step stages
constexpr int kSM = 128;   // stacked (head, p) rows of a state CTA
constexpr int kSN = 128;   // columns of N of a state CTA
constexpr int kHS = 8;     // heads of a state CTA at most
constexpr int kStages = 3;                // raw stages in flight
constexpr int kRaw = kT * kT;             // floats of a raw stage
constexpr int kTab = kHB > kHS ? kHB : kHS;  // heads of the tables
// Split tiles hold uint4 {big, small, big, small} of two consecutive
// k-values; their row strides (in uint4) put a quarter warp's fragment
// loads on 32 distinct banks.
constexpr int kLdX = kT + 2;       // y: x by key pair, p columns (2 mod 8)
constexpr int kLdC = kNC / 2 + 4;  // scores: C and B rows, n pairs (4 mod 8)
constexpr int kLdS = kSM + 2;      // state: by q pair, m or n columns
constexpr int kSplitX = kT / 2 * kLdX;
constexpr int kSplitC = 2 * kT * kLdC;
constexpr int kSplitS = 2 * (kSK / 2) * kLdS;
constexpr int kSplit = kSplitX > kSplitC
                           ? (kSplitX > kSplitS ? kSplitX : kSplitS)
                           : (kSplitC > kSplitS ? kSplitC : kSplitS);
constexpr int kXchg = 4 * 16 * kT;  // floats: odd-parity warps' y sums
constexpr int kMaxSmemBytes = 232448;  // what one Hopper CTA may have
static_assert(kRaw >= 2 * kT * kNC && kRaw >= kSK * (kSM + kSN),
              "every step's copies fit a raw stage");
static_assert(kSM == kSN, "the state's A and B split tiles share kLdS");
static_assert(kWarps == 8 && kHB <= kWarps && kHS <= kWarps,
              "one warp scans one head of the tables");

// Shared memory of one CTA for a chunk padded to qpad rows: raw stages,
// two split tiles, two tables (cum and dt, or dt and the decay to the
// chunk end) of kTab heads, the y CTA's scores (rows padded to 8 mod 32
// words) and its exchange of partial sums.
__host__ __device__ constexpr size_t smem_bytes(int qpad) {
  return sizeof(float) * (kStages * kRaw + 2 * 4 * kSplit +
                          2 * kTab * qpad + kT * (qpad + 8) + kXchg);
}

constexpr int kMaxQ = 256;  // the longest chunk: mamba2's serving chunk
static_assert(smem_bytes(kMaxQ) <= kMaxSmemBytes,
              "a chunk of kMaxQ rows fits one CTA's shared memory");
constexpr int kSeg = (kMaxQ + 31) / 32;  // rows of a lane's scan segment

struct Params {
  const float* x;   // (B, nc, Q, H, P)
  const float* dt;  // (B, nc, Q, H)
  const float* da;  // (B, nc, Q, H)
  const float* b;   // (B, nc, Q, G, N)
  const float* c;   // (B, nc, Q, G, N)
  float* y;         // (B, nc, Q, H, P)
  float* st;        // (B, nc, H, P, N)
  int nbc, Q, H, P, G, N, rep, qpad;
  int64_t hp, gn;   // H P and G N, the row strides
  int nqt, nhb, ny_qt, n_nc, npb;  // y CTAs
  int pm, npbs, hs, nmb, nnb, n_state;  // state CTAs
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes (kVec) or 4 from global to shared memory; with `read`
// false nothing is read and the destination is zero-filled.
template <bool kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool read) {
  if constexpr (kVec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(read ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(read ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// Start the copy of a (kRows x kCols) tile into dst (row stride kCols)
// from src (row stride ld): rows < nr and columns < nc are read, the rest
// zero-filled.  src is the tile's first element, always in bounds.
template <bool kVec, int kRows, int kCols>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int64_t ld, int nr, int nc) {
  constexpr int w = kVec ? 4 : 1;
  constexpr int kCopies = kRows * kCols / w;
  static_assert(kCopies % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < kCopies / kThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = e / (kCols / w), c = (e % (kCols / w)) * w;
    const bool in = r < nr && c < nc;
    cp_async<kVec>(dst + r * kCols + c, in ? src + r * ld + c : src, in);
  }
}

// {big(a), small(a), big(b), small(b)}: a and b split into TF32 words.
__device__ __forceinline__ uint4 split2(float a, float b) {
  uint4 u;
  tf32::split(a, u.x, u.y);
  tf32::split(b, u.z, u.w);
  return u;
}

// c[i][j] += a[i] b[j] in float32 precision for kM A fragments (each from
// two split words: rows g and g + 8, each {k = t, k = t + 4}) and kN B
// fragments (one split word each): each accumulator takes small.big,
// big.small, big.big in that order (`tf32::mma3`'s), issued term by term
// across the kM x kN tiles, so that consecutive HMMAs are independent.
template <int kM, int kN>
__device__ __forceinline__ void mma3_tiles(float (&c)[kM][kN][4],
                                           const uint4 (&lo)[kM],
                                           const uint4 (&hi)[kM],
                                           const uint4 (&b)[kN]) {
  uint32_t a_big[kM][4], a_small[kM][4], b_big[kN][2], b_small[kN][2];
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    a_big[i][0] = lo[i].x, a_big[i][1] = hi[i].x;
    a_big[i][2] = lo[i].z, a_big[i][3] = hi[i].z;
    a_small[i][0] = lo[i].y, a_small[i][1] = hi[i].y;
    a_small[i][2] = lo[i].w, a_small[i][3] = hi[i].w;
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    b_big[j][0] = b[j].x, b_big[j][1] = b[j].z;
    b_small[j][0] = b[j].y, b_small[j][1] = b[j].w;
  }
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) tf32::mma(c[i][j], a_small[i], b_big[j]);
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) tf32::mma(c[i][j], a_big[i], b_small[j]);
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) tf32::mma(c[i][j], a_big[i], b_big[j]);
}

// The pipeline every CTA runs: step s's copies are issued kStages steps
// ahead into raw stage s % kStages, split into split tile s % 2 one step
// ahead, and multiplied; one barrier a step.  The CTA's tables are made
// while the first copies are in flight, and the first barrier publishes
// them.  `role` is a y or a state CTA (tables, and issue, split and mma
// of a step).
template <class Role>
__device__ __forceinline__ void run_steps(Role& role, int n_steps,
                                          float* raw, uint4* split) {
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < n_steps) role.issue(s, raw + s * kRaw);
    commit();
  }
  role.tables();
  wait_group<kStages - 1>();
  __syncthreads();
  role.split(0, raw, split);
  for (int s = 0; s < n_steps; ++s) {
    wait_group<kStages - 2>();  // this thread's copies of step s + 1
    __syncthreads();  // everyone's; split s is in; step s - 1's products
                      // are done with the other split tile
    if (s + kStages < n_steps)
      role.issue(s + kStages, raw + (s % kStages) * kRaw);
    commit();
    role.mma(s, split + (s & 1) * kSplit);
    if (s + 1 < n_steps)
      role.split(s + 1, raw + ((s + 1) % kStages) * kRaw,
                 split + ((s + 1) & 1) * kSplit);
  }
}

// The tables of heads h0 .. h0 + nh - 1 of chunk bc, one warp a head:
// cum (the float64 prefix sums of da, rounded once) and dt for a y CTA;
// dt and exp(cum_{Q-1} - cum_q) for a state CTA.  Rows Q .. qpad - 1 are 0.
// Each lane loads its segment of da and dt at once (kSeg rows at most).
__device__ __forceinline__ void scan_heads(const Params& p, int64_t bc,
                                           int h0, int nh, float* tab0,
                                           float* tab1, bool state) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Q = p.Q, H = p.H, seg = (Q + 31) / 32;
  const int lo = min(lane * seg, Q), hi = min(lo + seg, Q);
  for (int hl = warp; hl < nh; hl += kWarps) {
    const int64_t base = bc * Q * H + h0 + hl;
    float dav[kSeg], dtv[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int64_t at = base + static_cast<int64_t>(lo + i) * H;
      dav[i] = lo + i < hi ? p.da[at] : 0.f;
      dtv[i] = lo + i < hi ? p.dt[at] : 0.f;
    }
    float* cum = (state ? tab1 : tab0) + hl * p.qpad;
    float* dtr = (state ? tab0 : tab1) + hl * p.qpad;
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) part += static_cast<double>(dav[i]);
    double incl = part;  // inclusive scan of the lane sums, in lane order
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    double run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) run = 0.0;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      if (lo + i < hi) {
        run += static_cast<double>(dav[i]);
        cum[lo + i] = static_cast<float>(run);
        dtr[lo + i] = dtv[i];
      }
    }
    for (int q = Q + lane; q < p.qpad; q += 32) {
      cum[q] = 0.f;
      dtr[q] = 0.f;
    }
    if (state) {  // the decay to the chunk end, from the rounded sums
      __syncwarp();
      const float last = cum[Q - 1];
      __syncwarp();
      for (int q = lo; q < hi; ++q) cum[q] = expf(last - cum[q]);
    }
  }
}

// A y CTA: query tile qt, heads h0 .. h0 + nh - 1 of group g.  Step
// s < n_score stages key tile s / n_nc and columns kNC (s % n_nc) .. of C
// and B; then step n_score + (hl n_pb + pb) n_t + j stages key tile j of
// head h0 + hl's x, columns 64 pb .. (n_pb blocks of P).
template <bool kVec>
struct YCta {
  const Params& p;
  int64_t bc;
  int qt, n_t, q0, h0, nh, n_score, lds;
  const float* xg;  // x of the chunk
  const float* bg;  // B and C of the chunk and the group
  const float* cg;
  float* yg;
  float* cum_t;  // [kTab][qpad] cum, and dt, of the heads
  float* dt_t;
  float* sc;     // [kT][lds] scores of the query tile, key columns
  float* xchg;   // [4][8][4][32] the odd-parity warps' sums
  int tid, lane, gq, tq, rg, kh, row0, ra, rb;
  float sacc[1][4][4], acc[1][8][4];

  __device__ __forceinline__ YCta(const Params& p_, float* smem,
                                  int64_t bc_, int qt_, int r)
      : p(p_), bc(bc_), qt(qt_), n_t(qt_ + 1), q0(qt_ * kT) {
    const int g = r / p.nhb, hb = r % p.nhb;
    h0 = g * p.rep + hb * kHB;
    nh = min(kHB, p.rep - hb * kHB);
    n_score = n_t * p.n_nc;
    lds = p.qpad + 8;
    xg = p.x + bc * p.Q * p.hp;
    bg = p.b + bc * p.Q * p.gn + static_cast<int64_t>(g) * p.N;
    cg = p.c + bc * p.Q * p.gn + static_cast<int64_t>(g) * p.N;
    yg = p.y + bc * p.Q * p.hp;
    cum_t = smem + kStages * kRaw + 2 * 4 * kSplit;
    dt_t = cum_t + kTab * p.qpad;
    sc = dt_t + kTab * p.qpad;
    xchg = sc + kT * lds;
    tid = threadIdx.x;
    lane = tid % 32;
    gq = lane / 4, tq = lane % 4;
    rg = (tid / 32) & 3, kh = (tid / 32) >> 2;
    row0 = q0 + 16 * rg;  // the warp's first row
    ra = row0 + gq, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[0][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
  }

  __device__ __forceinline__ int n_steps() const {
    return n_score + nh * p.npb * n_t;
  }

  // the tables, and the score tile zeroed: a warp that skips a key range
  // above its rows leaves zeros there, which the mask multiplies by 0
  __device__ __forceinline__ void tables() const {
    scan_heads(p, bc, h0, nh, cum_t, dt_t, false);
    for (int e = tid; e < kT * n_t * kT; e += kThreads)
      sc[e / (n_t * kT) * lds + e % (n_t * kT)] = 0.f;
  }

  __device__ __forceinline__ void issue(int s, float* dst) const {
    if (s < n_score) {
      const int j = s / p.n_nc, n0 = (s % p.n_nc) * kNC;
      copy_tile<kVec, kT, kNC>(dst, cg + q0 * p.gn + n0, p.gn, p.Q - q0,
                               p.N - n0);
      copy_tile<kVec, kT, kNC>(dst + kT * kNC, bg + j * kT * p.gn + n0,
                               p.gn, p.Q - j * kT, p.N - n0);
    } else {
      const int rr = s - n_score, j = rr % n_t, hp = rr / n_t;
      const int pc0 = (hp % p.npb) * kT, h = h0 + hp / p.npb;
      copy_tile<kVec, kT, kT>(
          dst, xg + j * kT * p.hp + static_cast<int64_t>(h) * p.P + pc0,
          p.hp, p.Q - j * kT, p.P - pc0);
    }
  }

  // every raw value is read before the first split word is stored, so
  // the loads do not wait on the stores
  __device__ __forceinline__ void split(int s, const float* src,
                                        uint4* dst) const {
    if (s < n_score) {  // C rows, then B rows, by n pair
      constexpr int kPer = kT * kNC / kThreads;
      const float2* rv = reinterpret_cast<const float2*>(src);
      float2 v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = rv[tid + i * kThreads];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kThreads;  // row (C then B), n pair
        dst[e / (kNC / 2) * kLdC + e % (kNC / 2)] = split2(v[i].x, v[i].y);
      }
    } else {  // dt x by key pair, each product rounded once
      constexpr int kPer = kT / 2 * kT / kThreads;
      const int rr = s - n_score;
      const float* dth = dt_t + (rr / n_t / p.npb) * p.qpad + rr % n_t * kT;
      float x0[kPer], x1[kPer];
      float2 d[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kThreads, kp = e / kT, pc = e % kT;
        x0[i] = src[2 * kp * kT + pc];
        x1[i] = src[(2 * kp + 1) * kT + pc];
        d[i] = *reinterpret_cast<const float2*>(dth + 2 * kp);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kThreads, kp = e / kT, pc = e % kT;
        dst[kp * kLdX + pc] =
            split2(__fmul_rn(x0[i], d[i].x), __fmul_rn(x1[i], d[i].y));
      }
    }
  }

  // rows 16 rg .. + 15 of the query tile against keys 32 kh .. + 31 of
  // key tile j, over kNC columns of N; the tile's scores go to shared
  // memory after its last columns
  __device__ __forceinline__ void score_mma(int s, const uint4* buf) {
    const int j = s / p.n_nc, t0 = j * kT + 32 * kh;
    if (row0 >= p.Q || t0 >= p.Q || (j == qt && 32 * kh > 16 * rg + 15))
      return;
    const uint4* cs = buf + (16 * rg + gq) * kLdC + tq;
    const uint4* bs = buf + (kT + 32 * kh + gq) * kLdC + tq;
#pragma unroll
    for (int kk = 0; kk < kNC / 8; ++kk) {
      const uint4 lo[1] = {cs[4 * kk]}, hi[1] = {cs[8 * kLdC + 4 * kk]};
      uint4 b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) b[nt] = bs[8 * nt * kLdC + 4 * kk];
      mma3_tiles(sacc, lo, hi, b);
    }
    if (s % p.n_nc != p.n_nc - 1) return;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* dst = sc + (16 * rg + gq) * lds + t0 + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(dst) =
          make_float2(sacc[0][nt][0], sacc[0][nt][1]);
      *reinterpret_cast<float2*>(dst + 8 * lds) =
          make_float2(sacc[0][nt][2], sacc[0][nt][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[0][nt][e] = 0.f;
    }
  }

  __device__ __forceinline__ void mma(int s, const uint4* buf) {
    if (s < n_score) {
      score_mma(s, buf);
      return;
    }
    const int Q = p.Q, P = p.P;
    const int rr = s - n_score, j = rr % n_t, hp = rr / n_t;
    const int pc0 = (hp % p.npb) * kT, hl = hp / p.npb, t0 = j * kT;
    const float* cum_h = cum_t + hl * p.qpad;
    if (row0 < Q) {
      const float cqa = cum_h[ra], cqb = cum_h[rb];
      // the warp's k-steps; on the diagonal tile up to its last row
      const int kmax = j < qt ? kT / 8 : min(kT / 8, 2 * rg + 2);
      for (int kk = kh; kk < kmax && t0 + 8 * kk < Q; kk += 2) {
        const int key = t0 + 8 * kk + 2 * tq;
        const float2 sa = *reinterpret_cast<const float2*>(
            sc + (16 * rg + gq) * lds + key);
        const float2 sb = *reinterpret_cast<const float2*>(
            sc + (16 * rg + gq + 8) * lds + key);
        const float2 ck = *reinterpret_cast<const float2*>(cum_h + key);
        // rows (ra, rb) x keys (key, key + 1) are a0 a1 a2 a3: k-index
        // (t, t + 4) of the fragment is key (2t, 2t + 1) of the k-step.
        // A masked entry's decay is expf(-inf) = 0 (the score is finite):
        // the mask is on the argument, so no branch skips an expf
        const bool in_a = ra < Q, in_b = rb < Q;
        const float ninf = __uint_as_float(0xff800000u);
        const float d0 =
            sa.x * expf(in_a && key <= ra ? cqa - ck.x : ninf);
        const float d1 =
            sb.x * expf(in_b && key <= rb ? cqb - ck.x : ninf);
        const float d2 =
            sa.y * expf(in_a && key + 1 <= ra ? cqa - ck.y : ninf);
        const float d3 =
            sb.y * expf(in_b && key + 1 <= rb ? cqb - ck.y : ninf);
        const uint4 lo[1] = {split2(d0, d2)}, hi[1] = {split2(d1, d3)};
        const uint4* xs = buf + (4 * kk + tq) * kLdX + gq;
        uint4 b[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) b[nt] = xs[8 * nt];
        mma3_tiles(acc, lo, hi, b);
      }
    }
    if (j == qt) finish(h0 + hl, pc0);
  }

  // after a head's last key tile: the odd-parity warps hand over their
  // sums, the even-parity warps add them (in that order) and store y
  __device__ __forceinline__ void finish(int h, int pc0) {
    const int Q = p.Q, P = p.P;
    if (kh == 1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xchg[((rg * 8 + nt) * 4 + e) * 32 + lane] = acc[0][nt][e];
    }
    __syncthreads();
    if (kh == 0 && row0 < Q) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = acc[0][nt][e] + xchg[((rg * 8 + nt) * 4 + e) * 32 + lane];
        const int pc = pc0 + 8 * nt + 2 * tq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = i ? rb : ra;
          if (row >= Q || pc >= P) continue;
          float* dst = yg + row * p.hp + static_cast<int64_t>(h) * P + pc;
          if ((P & 1) == 0) {
            *reinterpret_cast<float2*>(dst) =
                make_float2(v[2 * i], v[2 * i + 1]);
          } else {
            dst[0] = v[2 * i];
            if (pc + 1 < P) dst[1] = v[2 * i + 1];
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.f;
  }
};

// A state CTA: heads h0 .. h0 + nh - 1 of group g (or, for P > kSM, p
// columns pc0 .. of one head) stacked to rows m = (head, p), columns n0 ..
// n0 + kSN - 1 of N; step s stages rows kSK s .. of x and of B.
template <bool kVec>
struct StateCta {
  const Params& p;
  int64_t bc;
  int h0, nh, pc0, pw, m_valid, n0;
  const float* xg;  // x of the chunk from head h0, column pc0
  const float* bg;  // B of the chunk and the group from column n0
  float* dt_t;      // [kTab][qpad] dt, and the decay to the chunk end
  float* dec_t;
  int tid, gq, tq, wm, wn, col, half, col_tab;
  bool col_in;
  float acc[2][8][4];

  __device__ __forceinline__ StateCta(const Params& p_, float* smem,
                                      int64_t bc_, int r)
      : p(p_), bc(bc_) {
    const int per_g = p.nmb * p.nnb;
    const int g = r / per_g, mb = r % per_g / p.nnb, nb = r % p.nnb;
    const int hblk = mb / p.npbs;
    pc0 = mb % p.npbs * p.pm;
    h0 = g * p.rep + hblk * p.hs;
    nh = min(p.hs, p.rep - hblk * p.hs);
    n0 = nb * kSN;
    pw = min(p.pm, p.P - pc0);  // p columns of each head in the block
    m_valid = nh * pw;
    xg = p.x + bc * p.Q * p.hp + static_cast<int64_t>(h0) * p.P + pc0;
    bg = p.b + bc * p.Q * p.gn + static_cast<int64_t>(g) * p.N + n0;
    dt_t = smem + kStages * kRaw + 2 * 4 * kSplit;
    dec_t = dt_t + kTab * p.qpad;
    tid = threadIdx.x;
    gq = (tid % 32) / 4, tq = tid % 4;
    wm = (tid / 32) & 3, wn = (tid / 32) >> 2;
    col = tid % kSM, half = tid / kSM;  // the thread's split column
    col_in = col < m_valid;
    col_tab = col_in ? (col / pw) * p.qpad : 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  __device__ __forceinline__ int n_steps() const {
    return (p.Q + kSK - 1) / kSK;
  }

  __device__ __forceinline__ void tables() const {
    scan_heads(p, bc, h0, nh, dt_t, dec_t, true);
  }

  __device__ __forceinline__ void issue(int s, float* dst) const {
    copy_tile<kVec, kSK, kSM>(dst, xg + s * kSK * p.hp, p.hp,
                              p.Q - s * kSK, m_valid);
    copy_tile<kVec, kSK, kSN>(dst + kSK * kSM, bg + s * kSK * p.gn, p.gn,
                              p.Q - s * kSK, p.N - n0);
  }

  // (dt x) dec and B by q pair, each product rounded once
  __device__ __forceinline__ void split(int s, const float* src,
                                        uint4* dst) const {
    constexpr int kPer = kSK / 2 / (kThreads / kSM);
    float xa[kPer][2], xb[kPer][2];
    float2 dt2[kPer], dec2[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qp = half + 2 * i, q = s * kSK + 2 * qp;
      xa[i][0] = src[2 * qp * kSM + col];
      xa[i][1] = src[(2 * qp + 1) * kSM + col];
      xb[i][0] = src[kSK * kSM + 2 * qp * kSN + col];
      xb[i][1] = src[kSK * kSM + (2 * qp + 1) * kSN + col];
      dt2[i] = *reinterpret_cast<const float2*>(dt_t + col_tab + q);
      dec2[i] = *reinterpret_cast<const float2*>(dec_t + col_tab + q);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qp = half + 2 * i;
      const float w0 =
          col_in ? __fmul_rn(__fmul_rn(xa[i][0], dt2[i].x), dec2[i].x) : 0.f;
      const float w1 =
          col_in ? __fmul_rn(__fmul_rn(xa[i][1], dt2[i].y), dec2[i].y) : 0.f;
      dst[qp * kLdS + col] = split2(w0, w1);
      dst[(kSK / 2 + qp) * kLdS + col] = split2(xb[i][0], xb[i][1]);
    }
  }

  // warp (wm, wn): rows 32 wm .. + 31, columns n0 + 64 wn .. + 63
  __device__ __forceinline__ void mma(int s, const uint4* buf) {
    const int m_w = 32 * wm, n_w = n0 + 64 * wn;
    if (m_w >= m_valid || n_w >= p.N) return;
    const uint4* as = buf + tq * kLdS + m_w + gq;
    const uint4* bs = buf + (kSK / 2 + tq) * kLdS + 64 * wn + gq;
    // rows past m_valid, columns past N and q past Q are zero in the
    // split tiles: their products add exact zeros, and the store masks
#pragma unroll
    for (int kk = 0; kk < kSK / 8; ++kk) {
      uint4 lo[2], hi[2], b[8];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        lo[mt] = as[4 * kk * kLdS + 16 * mt];
        hi[mt] = as[4 * kk * kLdS + 16 * mt + 8];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) b[nt] = bs[4 * kk * kLdS + 8 * nt];
      mma3_tiles(acc, lo, hi, b);
    }
  }

  __device__ __forceinline__ void store() const {
    const int P = p.P, N = p.N;
    float* out = p.st + (bc * p.H + h0) * static_cast<int64_t>(P) * N;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = 32 * wm + 16 * mt + gq + 8 * i;
        if (m >= m_valid) continue;
        float* orow =
            out + (static_cast<int64_t>(m / pw) * P + pc0 + m % pw) * N;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = n0 + 64 * wn + 8 * nt + 2 * tq;
          if (n >= N) continue;
          if ((N & 1) == 0) {
            *reinterpret_cast<float2*>(orow + n) =
                make_float2(acc[mt][nt][2 * i], acc[mt][nt][2 * i + 1]);
          } else {
            orow[n] = acc[mt][nt][2 * i];
            if (n + 1 < N) orow[n + 1] = acc[mt][nt][2 * i + 1];
          }
        }
      }
    }
  }
};

template <bool kVec>
__device__ __forceinline__ void y_cta(const Params& p, float* smem,
                                      int64_t bc, int qt, int r) {
  YCta<kVec> cta(p, smem, bc, qt, r);
  run_steps(cta, cta.n_steps(), smem,
            reinterpret_cast<uint4*>(smem + kStages * kRaw));
}

template <bool kVec>
__device__ __forceinline__ void state_cta(const Params& p, float* smem,
                                          int64_t bc, int r) {
  StateCta<kVec> cta(p, smem, bc, r);
  run_steps(cta, cta.n_steps(), smem,
            reinterpret_cast<uint4*>(smem + kStages * kRaw));
  cta.store();
}

// Block x = unit * nbc + chunk: units are the y CTAs of query tiles nqt - 1
// down to 1, then the state CTAs, then the y CTAs of query tile 0.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int64_t bc = blockIdx.x % p.nbc;
  const int unit = blockIdx.x / p.nbc;
  const int heavy = (p.nqt - 1) * p.ny_qt;
  if (unit < heavy)
    y_cta<kVec>(p, smem, bc, p.nqt - 1 - unit / p.ny_qt, unit % p.ny_qt);
  else if (unit < heavy + p.n_state)
    state_cta<kVec>(p, smem, bc, unit - heavy);
  else
    y_cta<kVec>(p, smem, bc, 0, unit - heavy - p.n_state);
}

template <bool kVec>
cudaError_t launch(const Params& p, int grid, cudaStream_t st) {
  const size_t smem = smem_bytes(p.qpad);
  auto* kernel = ssd_chunk_kernel<kVec>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// xc (B, nc, Q, H, P), dtc and da (B, nc, Q, H), bc and cc (B, nc, Q, G,
// N) with G dividing H; y (B, nc, Q, H, P), states (B, nc, H, P, N).  All
// float32, contiguous, on the device of `stream`; every extent > 0,
// Q <= kMaxQ (256: what shared memory holds) and the grid within
// 2^31 - 1 CTAs; otherwise it returns cudaErrorInvalidValue and launches
// nothing.
int ssd_chunk_launch(const float* xc, const float* dtc, const float* da,
                     const float* bc, const float* cc, float* y,
                     float* states, int B, int nc, int Q, int H, int P,
                     int G, int N, void* stream) {
  if (B <= 0 || nc <= 0 || Q <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 ||
      Q > kMaxQ || H % G != 0 || static_cast<int64_t>(B) * nc > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = xc, p.dt = dtc, p.da = da, p.b = bc, p.c = cc, p.y = y,
  p.st = states;
  p.nbc = B * nc, p.Q = Q, p.H = H, p.P = P, p.G = G, p.N = N;
  p.rep = H / G, p.qpad = cdiv(Q, kT) * kT;
  p.hp = static_cast<int64_t>(H) * P, p.gn = static_cast<int64_t>(G) * N;
  p.nqt = p.qpad / kT, p.nhb = cdiv(p.rep, kHB), p.ny_qt = G * p.nhb;
  p.n_nc = cdiv(N, kNC), p.npb = cdiv(P, kT);
  p.pm = P < kSM ? P : kSM, p.npbs = cdiv(P, p.pm);
  p.hs = P <= kSM ? (kSM / P < kHS ? kSM / P : kHS) : 1;
  if (p.hs > p.rep) p.hs = p.rep;
  p.nmb = cdiv(p.rep, p.hs) * p.npbs, p.nnb = cdiv(N, kSN);
  p.n_state = G * p.nmb * p.nnb;
  const int64_t units =
      static_cast<int64_t>(p.nqt) * p.ny_qt + p.n_state;
  if (units * p.nbc > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(units * p.nbc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = P % 4 == 0 && N % 4 == 0 && aligned16(xc) &&
                   aligned16(bc) && aligned16(cc);
  const cudaError_t e = vec ? launch<true>(p, grid, s)
                            : launch<false>(p, grid, s);
  return static_cast<int>(e);
}

}  // extern "C"
