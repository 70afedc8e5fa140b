// Round gradients g = X^T (w * (X beta - y)) for NVIDIA Hopper (sm_90a):
// the flat, coded (two-stream) and tier-masked variants.
//
// Replaces the Pallas TPU kernels of
//   src/repro/kernels/round_grad/round_grad.py:
//     masked_round_gradient       (_masked_kernel, pallas_call at line 94),
//     coded_round_gradient        (_coded_kernel,  pallas_call at line 154),
//     tier_masked_round_gradient  (_tier_kernel,   pallas_call at line 209),
// and, through its own C entry point over the flat variant at w = 1,
//   src/repro/kernels/coded_grad/coded_grad.py::lsq_gradient
//                               (_kernel,        pallas_call at line 69),
// the per-epoch hot loop of every strategy on the fused gradient path:
// the flat one for UncodedFL/CodedFL, the coded one for StochasticCodedFL
// at sample_frac < 1 (systematic and parity rows in one launch), the
// tiered one for HierarchicalCFL (T tier partials from one pass over X).
//
// What bounds them on this card: bytes, and the latency of one launch.
// The work is about 4*M*D flops (4*M*D*T for T tiers) over an (M, D)
// float32 matrix read once, about one flop per byte, far below the
// H100's ~20 flops per byte balance point for float32 outside the tensor
// cores (and below its float64 one).  At the paper's shapes (M = 5632
// packed or 7200 rows, plus 2016 parity rows for the coded variant, D =
// 500) those bytes take 3.4-5.5 us at 3.35 TB/s: short enough that a
// second launch, CTA-wide barriers between a row's residual and its
// accumulation, and each round trip to L2 at the end all show.
//
// What the design does about it:
//   * One launch.  Each CTA owns a contiguous range of rows whose length
//     is a function of the row count alone (about M / 128 rounded up to a
//     multiple of its 8 warps; never the SM count or the occupancy), so
//     every launch, card and instance sees one partition; or, given a row
//     tile (`rpc`, a positive multiple of 8: the tuner's block_m), that
//     many rows, for the systematic and the parity block alike.  Warp w
//     of the CTA takes rows w, w + 8, w + 16, ... of its range and streams
//     them through its own ring of 2-4 rows in shared memory with cp.async
//     (16-byte .cg copies when D % 4 == 0 and every base is 16-byte
//     aligned, as at D = 500; else a 4-byte .ca instance of the same
//     kernel), the row's y, w and tier masks riding along: the copies of
//     its next rows are in flight while it forms one row's residual and
//     adds coef * mask_t * x into its sums.  No barrier stands between
//     the warps until the end.  beta is loaded once per CTA.
//   * The sums are float64 and the result is rounded once to float32.
//     The residual is a warp dot over D in float64 (beta held as float64
//     in shared memory, each x converted once, four partial sums a lane,
//     then a fixed xor-butterfly); lane l keeps the float64 sums of
//     columns (l + 32 q) * 4 + e (float4) or l + 32 q of every tier in
//     registers: 512 columns a CTA, so D > 512 runs ceil(D / 512) CTAs
//     per row range (blockIdx.y), each forming the whole residual and
//     summing its own columns; up to four tiers a launch, more in chunks
//     of four, each a launch.  At the end the eight warps' sums are added
//     in warp order into the CTA's float64 partial in device memory.
//     float32 sums of M rows of magnitude |coef x| differ from the exact
//     value, and from any other float32 order, by rounding that scales
//     with those magnitudes, which at a cancelling column exceeds rtol
//     1e-3 of the result: the float64 sums agree with the float64 value
//     to the last float32 rounding, so the kernel differs from the plain
//     float32 expression by that expression's own error.
//   * The cross-CTA sum is fixed-order and inside the launch.  Each CTA
//     writes its partial; one thread reads the generation word, runs
//     __threadfence() and takes a ticket from the counter with one
//     atomicAdd.  The last ticket holders are the reducers, one per 16
//     column pairs (16 columns where D % 4 != 0), at most 32 and at most
//     the CTAs; each sums 16 of them at a time over all partials in an
//     order fixed by CTA index, never by arrival: thread group k sums
//     partials k, k + 16, k + 32, ... in turn (eight loads in flight),
//     then the 16 group sums are added in group order, and the total is
//     rounded to float32.  The last arrival knows every partial is
//     written: it resets the counter to 0 for the next launch and
//     advances the generation; the other reducers wait on the generation
//     (an acquire load).  They are resident (they hold a ticket) and the
//     CTAs still to take one need no waiter to finish, so the launch
//     finishes as long as those CTAs find a free slot.  The wrapper caps
//     the reducers at a quarter of the CTAs of the instance that the
//     device holds at once (occupancy times SMs, at least one): the
//     waiters of up to four such launches in flight together, on any
//     device, leave a slot free.  On an H100 (132 SMs, at least one CTA
//     an SM) the cap stays at 32; on a slice of 32 SMs holding one CTA
//     an SM it is 8.
//     The order of the sums depends on the partials' count alone, so the
//     cap changes no bit.  A wait that never ends (more launches in
//     flight than that, or a fault) ends the launch with an error, not a
//     hang.  Atomics touch the counter and the generation only, never a
//     value.  The wrapper keeps one (counter, generation)
//     pair per (device, stream), zeroed once: two calls in flight on two
//     streams never share one, and calls on one stream run in order.
//   * One device body (`stream_rows`) serves all variants with the same
//     row ranges and the same reduce.  The flat gradient IS the tier
//     kernel's one-tier instance with no mask (mask value 1.0f), and the
//     tier kernel at T = 1 launches that same instance with an all-ones
//     mask, so it computes coef * 1.0, which is exact: the single-tier
//     hierarchy is bit-equal to the flat path by construction.  The
//     least-squares gradient is the same instance with w == nullptr
//     (w = 1), bit-equal to the flat one at w = None.  The instance (one
//     tier or up to four) never changes a tier's arithmetic.
//   * The coded variant launches CTAs over the concatenated row range:
//     the first n_ctas(M) own systematic rows, the rest parity rows, so
//     no CTA straddles the two blocks; both blocks' partials go through
//     the one fixed-order reduce.
//   * Ragged edges (M not a multiple of the rows, D of 4 or 512) are
//     masked in the kernel; nothing is padded on the host.
//   * Any D.  The row-resident instances above stage whole rows, so a
//     two-row ring a warp with four masks a row fits the CTA's shared
//     memory up to D = resident_max_d() (3220).  Past it, up to
//     kMaxCluster column chunks (D <= 8192), one launch over thread-block
//     clusters reads X once (`cluster_round_grad_kernel`, route kCluster):
//     a cluster of ceil(D / kChunk) CTAs along D owns a row range (the
//     partition of ~rows * chunks / kTargetCtas rows, or the row tile),
//     one CTA a kChunk-column chunk.  Each warp stages its chunk of its
//     rows, `batch` rows at a time (all of them where they fit, else
//     kBatch rows with the next batch in flight), by one bulk copy a row
//     completing on an mbarrier (cp.async.bulk; 4-byte cp.async where X
//     is not 16-byte aligned or D % 4 != 0), forms each row's partial dot
//     over its chunk (float64, four partial sums a lane, the fixed
//     xor-butterfly) into its own shared memory, then, after one cluster
//     barrier a batch, lane s reads row s's partial dots of every rank
//     through distributed shared memory and adds them in float64 in rank
//     order, so every CTA of the cluster forms the same coefficient
//     (x . beta - y) * w bits with no round trip to device memory.  The
//     chunk is still resident: coef * mask_t * x goes into the same
//     float64 sums, the warps' sums into the CTA's partial, and the
//     partials through the fixed-order sums of the reduce above, with
//     tickets taken a cluster at a time: the last cluster to take one is
//     the only reducer (one column a thread, all of its partials' loads
//     in flight), so no CTA ever waits on another cluster, and no waiting
//     reducer can hold the SMs that a cluster still to run needs, whatever
//     the grid (a cap on waiters from cudaOccupancyMaxActiveClusters
//     would not do: CTAs become resident a whole cluster at a time, so
//     one waiter can keep a cluster from a GPC).  The dot slots are
//     double-buffered: a rank overwrites slot k % 2 only
//     after the barrier of batch k + 1, which every CTA reaches after
//     reading batch k's.  A wider D (more chunks than kMaxCluster) takes
//     two launches a call: `residual_kernel` forms each row's coefficient
//     (x . beta - y) * w once, a warp dot over D in float64 (four partial
//     sums a lane, the fixed xor-butterfly), into a float64 (M,) scratch;
//     then the same warps, rings and reduce as above over about
//     kTargetCtas CTAs in all, each CTA staging only its kChunk columns of
//     a row and reading the row's coefficient from the scratch (`kWide`).
//     The coded variant takes clusters up to kPortableCluster CTAs only
//     (D <= 4096) and the two-launch route past it.  Every path is
//     fixed-order and free of atomics on values; the sums stay float64
//     and are rounded once.  The route is a function of D and the
//     variant (`route`; the wrapper's `route` mirrors it).  At D <=
//     resident_max_d() nothing of this runs, so those results are the
//     row-resident instances' bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "kernel_api.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;         // depth of each warp's ring
constexpr int kTargetCtas = 128;      // the row partition aims at this many
constexpr int kClusterCtas = 112;     // the cluster route's partition aims at
constexpr int kLaneCols = 16;         // columns a lane sums, per tier
constexpr int kChunk = 32 * kLaneCols;  // columns a CTA sums (blockIdx.y)
constexpr int kMaxTiers = 4;          // tiers a launch sums
constexpr int kRedItems = 16;         // items a reducer pass takes
constexpr int kRedSubsets = kThreads / kRedItems;  // partials' subsets
constexpr int kRedBatch = 8;          // partials a reducer thread loads at once
constexpr int kMaxReducers = 32;      // CTAs that sum the partials, at most
// the dynamic shared memory one CTA may use (227 KB less the static)
constexpr int kDynFloats = (232448 - 64) / 4;
constexpr int kMaxCluster = 16;       // column chunks of the cluster route
constexpr int kPortableCluster = 8;   // past it, a non-portable cluster size
constexpr int kWholeRows = 12;        // a warp's rows staged in one batch
constexpr int kBatch = 4;             // else rows a batch, two in flight
static_assert(kMaxStages >= 2 && kMaxStages <= 8, "ring depth");
static_assert(kThreads % kRedItems == 0, "reducer threads");

// -- host: the partition and the shared-memory plan ----------------------

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Rows a CTA owns: the row tile `tile` where it is positive, else
// ~rows * chunks / target, a multiple of the warps (warp w takes rows w,
// w + kWarps, ...), a function of `rows` and `chunks` alone.  The cluster
// route aims at kClusterCtas: at 768 rows and D = 4096, 14 clusters of 8,
// which an H100 holds at once at four tiers a launch (one CTA an SM; it
// holds 15) as at one.
// The row-resident instances pass chunks = 1 (about kTargetCtas row
// ranges, each run by every column chunk's CTA); the wide ones the
// column chunks of D, so that a launch stays near kTargetCtas CTAs in
// all, each warp streaming several rows, and never needs more partials
// than chunks = 1 (the count `rg_num_ctas` sizes).
int rows_per_cta(int rows, int tile, int chunks = 1,
                 int target = kTargetCtas) {
  if (tile > 0) return tile;
  int64_t r = (static_cast<int64_t>(rows) * chunks + target - 1) / target;
  r = (r + kWarps - 1) / kWarps * kWarps;
  return r < kWarps ? kWarps : static_cast<int>(r);
}

// CTAs over `rows` rows (one for an empty block, which adds a zero
// partial).
int ctas_for(int rows, int tile, int chunks = 1, int target = kTargetCtas) {
  const int rpc = rows_per_cta(rows, tile, chunks, target);
  const int n = (rows + rpc - 1) / rpc;
  return n < 1 ? 1 : n;
}

// A row tile the kernels take: 0 (their own partition) or a positive
// multiple of the warps.
bool valid_tile(int tile) {
  return tile == 0 || (tile > 0 && tile % kWarps == 0);
}

int chunks_for(int d) { return (d + kChunk - 1) / kChunk; }

// Floats of one ring stage: `width` columns of a row of X (all D, or a
// wide CTA's kChunk), then its y, w and `nm` tier masks.
__host__ __device__ inline int stage_floats(int width, int nm) {
  return pad4(width) + pad4(2 + nm);
}

// Columns a ring stage holds, and floats of beta (float64) in shared
// memory: the row-resident instances stage whole rows and hold beta; the
// wide ones stage their kChunk columns and read coefficients instead.
__host__ __device__ inline int stage_width(int d, bool wide) {
  return wide ? kChunk : d;
}
__host__ __device__ inline int beta_floats(int d, bool wide) {
  return wide ? 0 : 2 * pad4(d);
}

// Dynamic shared memory of one CTA, in floats: beta and each warp's ring
// (which the warps' float64 sums, kWarps x min(d, kChunk), reuse at the
// end).
int smem_floats(int d, int nm, int stages, bool wide = false) {
  const int n = beta_floats(d, wide) +
                kWarps * stages * stage_floats(stage_width(d, wide), nm);
  return n < kThreads * 4 ? kThreads * 4 : n;  // the reduce's scratch
}

// Ring depth: as deep as shared memory allows, at most kMaxStages and the
// rows of a warp, at least 2.  0: not even 2 fit.
int ring_stages(int d, int nm, int rpc, bool wide = false) {
  int s = rpc / kWarps;
  s = s > kMaxStages ? kMaxStages : s < 2 ? 2 : s;
  while (s >= 2 && smem_floats(d, nm, s, wide) > kDynFloats) --s;
  return s >= 2 ? s : 0;
}

// Largest D the row-resident instances take at any tier count: a two-row
// ring a warp, each row carrying kMaxTiers masks.  Wider D takes the
// residual pass and the wide instances.
int resident_max_d() {
  static const int limit = [] {
    int d = 4 * kChunk * 2;
    while (d > 0 && smem_floats(d, kMaxTiers, 2) > kDynFloats) --d;
    return d;
  }();
  return limit;
}

// How a call at this D runs: the row-resident instances, one launch over
// clusters along D, or the residual pass and the column-chunked launch.
// The coded variant takes clusters up to the portable size only: its two
// blocks' row ranges round up to 8 clusters of 16 CTAs at (768 + 230,
// 8192), of which an H100 holds 7 at once, and there it ran slower than
// the two-launch route (PERF.md).
enum Route { kResident = 0, kCluster = 1, kTwoLaunch = 2 };

Route route(int d, bool coded = false) {
  if (d <= resident_max_d()) return kResident;
  return chunks_for(d) <= (coded ? kPortableCluster : kMaxCluster)
             ? kCluster : kTwoLaunch;
}

// The cluster route's staging: rows a warp stages a batch and the batches
// in flight (1: all of the warp's rows at once; 2: kBatch rows while the
// next kBatch land), from the rows a CTA owns.
void cluster_batches(int rpc, int* batch, int* bufs) {
  const int rows = (rpc + kWarps - 1) / kWarps;
  *batch = rows <= kWholeRows ? rows : kBatch;
  *bufs = rows <= kWholeRows ? 1 : 2;
}

// Floats of a cluster CTA's rings (kWarps x bufs x batch stages of kChunk
// columns), which the warps' float64 sums reuse at the end; then the two
// dot slots (float64, kWarps x batch each) and one mbarrier a stage.
__host__ __device__ inline int cluster_ring_floats(int batch, int bufs) {
  const int ring = kWarps * bufs * batch * kChunk;
  return ring > 2 * kWarps * kChunk ? ring : 2 * kWarps * kChunk;
}
int cluster_smem_floats(int batch, int bufs) {
  return cluster_ring_floats(batch, bufs) + 4 * kWarps * batch +
         2 * kWarps * bufs * batch;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// -- device helpers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// Wait until at most `n` (uniform, < kMaxStages - 1) of this thread's
// newest commit groups are pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

// kW doubles (16 or 8 bytes) that bypass L1: the partials are written by
// other CTAs of the same launch.
template <int kW>
__device__ __forceinline__ void load_cg(const double* p, double (&v)[kW]) {
  if constexpr (kW == 2) {
    const double2 q = __ldcg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldcg(p);
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// -- the cluster route's helpers -------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of shared::cta address `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t map_to(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ double ld_cluster_f64(uint32_t addr) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n"
               : "=d"(v) : "r"(addr) : "memory");
  return v;
}

// Every thread of the cluster meets here: what each wrote to any CTA's
// shared memory before is visible to all after.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
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

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global `src` to shared `dst`, completing on the mbarrier `bar`, which
// this call arms (one arrival and the bytes).
__device__ __forceinline__ void bulk_row(float* dst, const float* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The rows [row0, row_end) of (x, y, w, masks) one CTA streams.
struct Rows {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const float* __restrict__ w;      // nullptr: w = 1
  const float* __restrict__ masks;  // (nm, mask_stride) or nullptr
  int64_t mask_stride;
  int nm;                           // masks copied per row (0 or nt)
  int64_t row0, row_end;
  int d;
  const double* res;                // wide: coefficients of these rows
};

// Start copying row `r` into ring stage `stage` (the calling warp's
// lanes): X's row (columns [col0, col0 + len) of it, `width` floats
// apart from the meta), then y, w and the masks (the masks alone where
// the coefficients are read, kWide).  One commit group; empty when `r`
// is past the rows.
template <int kVec, bool kWide>
__device__ __forceinline__ void issue_row(float* stage, int64_t r,
                                          const Rows& rs, int lane, int col0,
                                          int len, int width) {
  if (r < rs.row_end) {
    const float* src = rs.x + r * rs.d + col0;
    for (int c = lane * kVec; c < len; c += 32 * kVec)
      cp_async<kVec>(stage + c, src + c);
    float* meta = stage + pad4(width);
    if (!kWide && lane == 0) cp_async<1>(meta, rs.y + r);
    if (!kWide && lane == 1 && rs.w != nullptr)
      cp_async<1>(meta + 1, rs.w + r);
    for (int t = lane; t < rs.nm; t += 32)
      cp_async<1>(meta + 2 + t, rs.masks + t * rs.mask_stride + r);
  }
  cp_async_commit();
}

// The CTA's partial over columns [col0, col0 + kChunk), tier by tier: the
// warps' float64 sums `acc` (lane l holding columns col0 + (l + 32 q) *
// kVec + e) added in warp order through `s_part` (kWarps x kChunk doubles
// of shared memory no warp reads any more) into dst + t * dst_stride.
template <int kNt, int kVec>
__device__ __forceinline__ void cta_partial(
    const double (&acc)[kNt][kLaneCols], int nt, int d, int col0,
    double* s_part, double* dst, int64_t dst_stride) {
  constexpr int kQ = kLaneCols / kVec;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int len = min(kChunk, d - col0);
#pragma unroll
  for (int t = 0; t < kNt; ++t) {
    if (t >= nt) break;
    __syncthreads();  // the rings, or the last tier's sums, are consumed
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int cl = (lane + 32 * q) * kVec;
      if (col0 + cl < d) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          s_part[warp * len + cl + e] = acc[t][q * kVec + e];
      }
    }
    __syncthreads();
    for (int cl = tid; cl < len; cl += kThreads) {
      double v = s_part[cl];
      for (int g = 1; g < kWarps; ++g) v += s_part[g * len + cl];
      dst[t * dst_stride + col0 + cl] = v;
    }
  }
}

// Streams the CTA's rows and writes its float64 partials of `nt` tiers
// over columns [col0, col0 + kChunk), col0 = blockIdx.y * kChunk, to
// dst + t * dst_stride.  Warp w takes rows row0 + w, row0 + w + kWarps,
// ... through its own ring of `stages` rows in shared memory: the copies
// of its next rows are in flight while it forms a row's residual (a warp
// dot over all of D in float64: beta is float64 in shared memory, each x
// is converted once; four partial sums a lane, then a fixed
// xor-butterfly) and adds coef * mask_t * x into its own float64 sums,
// with no barrier between warps.  Lane l sums columns col0 + (l + 32 q)
// * kVec + e of each tier in registers (columns past D add exact zeros).
// At the end the warps' sums are added in warp order into the CTA's
// partial.  kWide: the ring holds only the CTA's columns (at stage
// offset 0) and the row's coefficient is read from rs.res, not formed.
template <int kNt, int kVec, bool kWide>
__device__ __forceinline__ void stream_rows(const Rows& rs, int nt,
                                            const float* __restrict__ beta,
                                            int stages, double* dst,
                                            int64_t dst_stride) {
  constexpr int kQ = kLaneCols / kVec;  // register chunks a lane
  const int d = rs.d;
  const int col0 = blockIdx.y * kChunk;
  const int width = stage_width(d, kWide);
  const int sf = stage_floats(width, rs.nm);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) float smem[];
  double* s_beta = reinterpret_cast<double*>(smem);     // (d,)
  float* ring = smem + beta_floats(d, kWide) + warp * stages * sf;
  // the columns a stage holds: the CTA's own (kWide) or the whole row
  const int copy0 = kWide ? col0 : 0;
  const int copy_len = kWide ? min(kChunk, d - col0) : d;

  const int64_t first = rs.row0 + warp;
  const int n_rows = rs.row_end > first ? static_cast<int>(
      (rs.row_end - first + kWarps - 1) / kWarps) : 0;
  for (int j = 0; j < stages - 1; ++j)
    issue_row<kVec, kWide>(ring + j * sf,
                           first + static_cast<int64_t>(j) * kWarps, rs,
                           lane, copy0, copy_len, width);

  double acc[kNt][kLaneCols];
#pragma unroll
  for (int t = 0; t < kNt; ++t)
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) acc[t][q] = 0.0;
  if (!kWide)
    for (int i = tid; i < d; i += kThreads)
      s_beta[i] = static_cast<double>(beta[i]);
  __syncthreads();

  for (int j = 0; j < n_rows; ++j) {
    cp_async_wait_pending(stages - 2);  // this lane's copies of row j
    __syncwarp();  // every lane's; row j - 1 is consumed
    issue_row<kVec, kWide>(
        ring + ((j + stages - 1) % stages) * sf,
        first + static_cast<int64_t>(j + stages - 1) * kWarps, rs, lane,
        copy0, copy_len, width);
    const float* row = ring + (j % stages) * sf;
    const float* meta = row + pad4(width);
    double xd[kLaneCols];
    double cf;
    if constexpr (kWide) {
      // the coefficient, formed by residual_kernel; this CTA's columns
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int cl = (lane + 32 * q) * kVec;
        float xv[kVec];
        if (col0 + cl < d) load_vec<kVec>(row + cl, xv);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          xd[q * kVec + e] = col0 + cl < d ? static_cast<double>(xv[e])
                                           : 0.0;
      }
      cf = rs.res[first + static_cast<int64_t>(j) * kWarps];
    } else {
      // the residual: this CTA's columns first (kept as float64 for the
      // sums), then the other chunks' in order; four partial sums a lane
      double part[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int c = col0 + (lane + 32 * q) * kVec;
        float xv[kVec];
        if (c < d) load_vec<kVec>(row + c, xv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          xd[q * kVec + e] = c < d ? static_cast<double>(xv[e]) : 0.0;
          if (c < d) part[q % 4] = fma(xd[q * kVec + e], s_beta[c + e],
                                       part[q % 4]);
        }
      }
      for (int ch = 0; ch < static_cast<int>(gridDim.y); ++ch) {
        if (ch == static_cast<int>(blockIdx.y)) continue;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int c = ch * kChunk + (lane + 32 * q) * kVec;
          if (c < d) {
            float xv[kVec];
            load_vec<kVec>(row + c, xv);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              part[q % 4] = fma(static_cast<double>(xv[e]), s_beta[c + e],
                                part[q % 4]);
          }
        }
      }
      double dot = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      cf = (dot - static_cast<double>(meta[0])) *
           (rs.w != nullptr ? static_cast<double>(meta[1]) : 1.0);
    }
    double k[kNt];  // coef * mask, exact at mask 1.0f
#pragma unroll
    for (int t = 0; t < kNt; ++t)
      k[t] = rs.nm > 0 && t < nt ? cf * static_cast<double>(meta[2 + t])
                                 : cf;
#pragma unroll
    for (int t = 0; t < kNt; ++t)
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q)
        acc[t][q] = fma(k[t], xd[q], acc[t][q]);
  }
  cp_async_wait<0>();
  cta_partial<kNt, kVec>(
      acc, nt, d, col0,
      reinterpret_cast<double*>(smem + beta_floats(d, kWide)),  // rings
      dst, dst_stride);
}

// After every CTA of the launch (n_tickets of them) has written its
// float64 partials: the CTAs of blockIdx.x = b at partials + (t * n_parts
// + b) * d.  The last ticket holders (one per kRedItems items of kW
// doubles, at most kMaxReducers and max_red, the host's cap >= 1) sum
// them into out (nt, d) in a fixed order and round once to float32:
// out[t, c] = sum over k = 0 .. kRedSubsets - 1 in order of (sum over
// b = k, k + kRedSubsets, ... in order of partial b), an order that
// depends on n_parts alone.  counter[0] counts the tickets and
// counter[1] is a generation: the last arrival resets counter[0] to 0
// for the next launch and advances counter[1], which the other reducers
// wait on.
template <int kW>
__device__ __forceinline__ void reduce_partials(
    const double* partials, float* __restrict__ out, unsigned* counter,
    int n_parts, int n_tickets, int nt, int d, int max_red) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_ticket, s_gen;
  __syncthreads();  // the CTA's partial is written
  if (threadIdx.x == 0) {
    s_gen = load_acquire(counter + 1);  // before the ticket: not yet advanced
    __threadfence();  // (cumulative) the partial is visible before the ticket
    s_ticket = atomicAdd(counter, 1u);
  }
  __syncthreads();
  const int per_row = d / kW;
  const int items = nt * per_row;
  const unsigned n = static_cast<unsigned>(n_tickets);
  unsigned n_red = static_cast<unsigned>(
      (items + kRedItems - 1) / kRedItems);
  if (n_red > kMaxReducers) n_red = kMaxReducers;
  if (n_red > static_cast<unsigned>(max_red)) n_red = max_red;
  if (n_red > n) n_red = n;
  const unsigned ticket = s_ticket;
  if (ticket + n_red < n) return;  // not a reducer
  if (threadIdx.x == 0) {
    if (ticket == n - 1) {  // the last arrival: every ticket is taken
      __threadfence();
      atomicExch(counter, 0u);
      atomicAdd(counter + 1, 1u);  // releases the other reducers
    } else {
      // the other CTAs finish within microseconds; a generation that
      // never advances ends the launch with an error, not a hang
      for (unsigned spins = 0; load_acquire(counter + 1) == s_gen; ++spins) {
        if (spins == (1u << 26)) __trap();
        __nanosleep(32);
      }
    }
    __threadfence();
  }
  __syncthreads();  // every partial is written

  // thread (sub, it): item it of each pass, partials sub, sub +
  // kRedSubsets, ..., kRedBatch loads in flight
  const int it = threadIdx.x % kRedItems, sub = threadIdx.x / kRedItems;
  const int per_slice = (items + static_cast<int>(n_red) - 1) /
                        static_cast<int>(n_red);
  const int i0 = static_cast<int>(ticket + n_red - n) * per_slice;
  const int i1 = min(items, i0 + per_slice);
  double* s_red = reinterpret_cast<double*>(smem);  // (subsets, items, kW)
  for (int base = i0; base < i1; base += kRedItems) {
    const int i = base + it;
    const int t = i / per_row, c = (i - t * per_row) * kW;
    double s[kW];
#pragma unroll
    for (int e = 0; e < kW; ++e) s[e] = 0.0;
    if (i < i1) {
      const double* p = partials + static_cast<int64_t>(t) * n_parts * d + c;
      for (int b0 = sub; b0 < n_parts; b0 += kRedBatch * kRedSubsets) {
        double v[kRedBatch][kW];
#pragma unroll
        for (int j = 0; j < kRedBatch; ++j) {
          const int b = b0 + j * kRedSubsets;
          if (b < n_parts) {
            load_cg<kW>(p + static_cast<int64_t>(b) * d, v[j]);
          } else {
#pragma unroll
            for (int e = 0; e < kW; ++e) v[j][e] = 0.0;
          }
        }
#pragma unroll
        for (int j = 0; j < kRedBatch; ++j)
#pragma unroll
          for (int e = 0; e < kW; ++e) s[e] += v[j][e];
      }
    }
#pragma unroll
    for (int e = 0; e < kW; ++e) s_red[(sub * kRedItems + it) * kW + e] = s[e];
    __syncthreads();
    if (sub == 0 && i < i1) {
      for (int k = 1; k < kRedSubsets; ++k)
#pragma unroll
        for (int e = 0; e < kW; ++e) s[e] += s_red[(k * kRedItems + it) * kW + e];
#pragma unroll
      for (int e = 0; e < kW; ++e)
        out[static_cast<int64_t>(t) * d + c + e] = static_cast<float>(s[e]);
    }
    __syncthreads();
  }
}

// The cluster route's reduce, after each CTA has written its partials:
// the same fixed-order sums as reduce_partials (the subsets b mod
// kRedSubsets, each in order of b, then the subsets in order), rounded
// once to float32.  Tickets are taken a cluster at a time (n_parts
// clusters of gridDim.y CTAs): one cluster barrier once every CTA has
// written and fenced its partial (after it no rank reads another rank's
// dots), rank 0 takes the ticket and stores it in every rank's shared
// memory, a second barrier.  The last cluster to take one knows every
// partial is written: its CTAs are the only reducers, rank r summing
// columns r, r + gridDim.y, ... of each kThreads-column slice of out (nt,
// d), one column a thread with kRedSubsets of its partials' loads in
// flight, and rank 0 resets the counter for the next launch.  No reducer
// waits on another cluster, so no CTA holds an SM that a cluster still
// to run needs, whatever the grid.
__device__ __forceinline__ void reduce_cluster_partials(
    const double* partials, float* __restrict__ out, unsigned* counter,
    int n_parts, int nt, int d) {
  __shared__ unsigned s_ticket;
  const uint32_t rank = cluster_rank();
  const int ch = static_cast<int>(gridDim.y);
  __syncthreads();  // the CTA's partial is written
  if (threadIdx.x == 0) __threadfence();  // and visible before the ticket
  cluster_barrier();  // every CTA of the cluster has written its partial
  if (rank == 0 && threadIdx.x == 0) {
    __threadfence();  // (cumulative) the cluster's partials, then the ticket
    const unsigned ticket = atomicAdd(counter, 1u);
    if (ticket + 1 == static_cast<unsigned>(n_parts)) {
      __threadfence();  // every other cluster's partials, before ours
      atomicExch(counter, 0u);
    }
    for (int r = 0; r < ch; ++r)
      asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(
                       map_to(smem_addr(&s_ticket), r)), "r"(ticket)
                   : "memory");
  }
  cluster_barrier();  // every rank holds the ticket
  if (s_ticket + 1 != static_cast<unsigned>(n_parts)) return;
  const int cols = nt * d;
  for (int f = (static_cast<int>(rank) * kThreads) + threadIdx.x; f < cols;
       f += ch * kThreads) {
    const int t = f / d, c = f - t * d;
    const double* p = partials + static_cast<int64_t>(t) * n_parts * d + c;
    double sub[kRedSubsets];
#pragma unroll
    for (int k = 0; k < kRedSubsets; ++k) sub[k] = 0.0;
    for (int b0 = 0; b0 < n_parts; b0 += kRedSubsets) {
      double v[kRedSubsets];
#pragma unroll
      for (int k = 0; k < kRedSubsets; ++k)
        v[k] = b0 + k < n_parts ? __ldcg(p + static_cast<int64_t>(b0 + k) * d)
                                : 0.0;
#pragma unroll
      for (int k = 0; k < kRedSubsets; ++k) sub[k] += v[k];
    }
    double sum = sub[0];
#pragma unroll
    for (int k = 1; k < kRedSubsets; ++k) sum += sub[k];
    out[f] = static_cast<float>(sum);
  }
}

// The wide instances' first launch: res[r] = (x_r . beta - y_r) * w_r
// (w = 1 where w is nullptr) in float64 for the rows of x (m) and then of
// xp (c; the coded variant's parity block, c = 0 elsewhere), one warp a
// row, kResLoads loads of X in flight a lane.  Lane l forms columns
// (l + 32 (kResLoads i + u)) * kVec + e in partial sum u % 4, i and u in
// order; the four sums are added as (0 + 1) + (2 + 3) and then by the
// fixed xor-butterfly: an order that depends on D alone.
constexpr int kResWarps = 4;  // rows a CTA of residual_kernel
constexpr int kResLoads = 8;  // loads of X in flight a lane
template <int kVec>
__global__ void __launch_bounds__(kResWarps * 32)
residual_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ w, int m,
                const float* __restrict__ xp, const float* __restrict__ yp,
                const float* __restrict__ wp, int c,
                const float* __restrict__ beta, double* __restrict__ res,
                int d) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kResWarps +
                    threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= static_cast<int64_t>(m) + c) return;
  const bool sys = r < m;
  const int64_t i = sys ? r : r - m;
  const float* row = (sys ? x : xp) + i * d;
  constexpr int kStep = 32 * kVec;
  double part[4] = {0.0, 0.0, 0.0, 0.0};
  for (int c0 = lane * kVec; c0 < d; c0 += kResLoads * kStep) {
    float xv[kResLoads][kVec], bv[kResLoads][kVec];
#pragma unroll
    for (int u = 0; u < kResLoads; ++u) {
      if (c0 + u * kStep < d) {
        load_vec<kVec>(row + c0 + u * kStep, xv[u]);
        load_vec<kVec>(beta + c0 + u * kStep, bv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kResLoads; ++u) {
      if (c0 + u * kStep < d) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          part[u % 4] = fma(static_cast<double>(xv[u][e]),
                            static_cast<double>(bv[u][e]), part[u % 4]);
      }
    }
  }
  double dot = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (lane == 0) {
    const float* wr = sys ? w : wp;
    res[r] = (dot - static_cast<double>((sys ? y : yp)[i])) *
             (wr != nullptr ? static_cast<double>(wr[i]) : 1.0);
  }
}

// Flat and tiered (nt <= kNt tiers): CTA (b, chunk) owns rows [b * rpc,
// ...) of x and columns [chunk * kChunk, ...) of the partials, and writes
// tier t's to partials[(t * n_ctas + b) * d]; the reducers sum them into
// out (nt, d).  kWide: res holds the rows' coefficients.
template <int kNt, int kVec, bool kWide>
__global__ void __launch_bounds__(kThreads)
tier_round_grad_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ w,
                       const float* __restrict__ masks, int nt,
                       const float* __restrict__ beta, double* partials,
                       float* __restrict__ out, unsigned* counter, int m,
                       int d, int rpc, int stages, int max_red,
                       const double* __restrict__ res) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rpc;
  const Rows rs{x, y, w, masks, m, masks != nullptr ? nt : 0, row0,
                min(static_cast<int64_t>(m), row0 + rpc), d, res};
  stream_rows<kNt, kVec, kWide>(
      rs, nt, beta, stages, partials + static_cast<int64_t>(blockIdx.x) * d,
      static_cast<int64_t>(gridDim.x) * d);
  reduce_partials<kVec == 4 ? 2 : 1>(partials, out, counter, gridDim.x,
                                     gridDim.x * gridDim.y, nt, d, max_red);
}

// Coded: CTAs [0, n_sys) own systematic rows (rpc_sys each), the rest
// parity rows (rpc_par each); CTA b writes its partial to partials[b * d].
// kWide: res holds the m systematic rows' coefficients, then the c
// parity rows'.
template <int kVec, bool kWide>
__global__ void __launch_bounds__(kThreads)
coded_round_grad_kernel(const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ w, int m,
                        const float* __restrict__ xp,
                        const float* __restrict__ yp,
                        const float* __restrict__ wp, int c,
                        const float* __restrict__ beta, double* partials,
                        float* __restrict__ out, unsigned* counter, int d,
                        int rpc_sys, int rpc_par, int n_sys, int stages,
                        int max_red, const double* __restrict__ res) {
  const int b = blockIdx.x;
  const bool sys = b < n_sys;
  const int rpc = sys ? rpc_sys : rpc_par;
  const int64_t row0 = static_cast<int64_t>(sys ? b : b - n_sys) * rpc;
  const Rows rs{sys ? x : xp, sys ? y : yp, sys ? w : wp, nullptr, 0, 0,
                row0, min(static_cast<int64_t>(sys ? m : c), row0 + rpc), d,
                res == nullptr ? nullptr : sys ? res : res + m};
  stream_rows<1, kVec, kWide>(rs, 1, beta, stages,
                              partials + static_cast<int64_t>(b) * d, 0);
  reduce_partials<kVec == 4 ? 2 : 1>(partials, out, counter, gridDim.x,
                                     gridDim.x * gridDim.y, 1, d, max_red);
}

// The cluster route's staging of batch k of a warp's rows: row j = k *
// batch + s (s < batch) of the warp, where it has one, into stage (k %
// bufs) * batch + s of its ring: columns [col0, col0 + len) by one bulk
// copy on the stage's mbarrier (kVec 4), or 4-byte cp.async by each lane
// of its own columns, one commit group a batch (kVec 1).
template <int kVec>
__device__ __forceinline__ void issue_batch(float* ring, uint64_t* bar,
                                            const Rows& rs, int64_t first,
                                            int rows, int k, int batch,
                                            int bufs, int lane, int col0,
                                            int len) {
  for (int s = 0; s < batch; ++s) {
    const int j = k * batch + s;
    if (j >= rows) break;
    const int slot = (k % bufs) * batch + s;
    const float* src = rs.x + (first + static_cast<int64_t>(j) * kWarps) *
                                  rs.d + col0;
    if constexpr (kVec == 4) {
      if (lane == 0)
        bulk_row(ring + slot * kChunk, src, 4u * len, smem_addr(bar + slot));
    } else {
      for (int c = lane; c < len; c += 32)
        cp_async<1>(ring + slot * kChunk + c, src + c);
    }
  }
  if constexpr (kVec == 1) cp_async_commit();
}

// The cluster route (csrc note "Any D"): flat and tiered (nt <= kNt tiers,
// masks (nt, m) or nullptr; c = 0, n_sys = gridDim.x) or coded (nt = 1;
// blocks [0, n_sys) own systematic rows, the rest parity rows).  Cluster
// b (blockIdx.x) owns a row range, its CTA of rank blockIdx.y the columns
// [blockIdx.y * kChunk, ...), and writes tier t's partial to
// partials[(t * gridDim.x + b) * d]; the reducers sum them into out (nt,
// d).  Every CTA of a cluster runs the same batches (warp 0's rows set
// their count), so the cluster barriers match.  Planned for one CTA an
// SM (at 768 rows and D = 4096 its stages take 112 KB of shared memory).
template <int kNt, int kVec>
__global__ void __launch_bounds__(kThreads)
cluster_round_grad_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const float* __restrict__ w,
                          const float* __restrict__ masks, int nt, int m,
                          const float* __restrict__ xp,
                          const float* __restrict__ yp,
                          const float* __restrict__ wp, int c, int n_sys,
                          int rpc_sys, int rpc_par,
                          const float* __restrict__ beta, double* partials,
                          float* __restrict__ out, unsigned* counter, int d,
                          int batch, int bufs) {
  constexpr int kQ = kLaneCols / kVec;  // register chunks a lane
  const int b = blockIdx.x;
  const bool sys = b < n_sys;
  const int rpc = sys ? rpc_sys : rpc_par;
  const int64_t row0 = static_cast<int64_t>(sys ? b : b - n_sys) * rpc;
  const Rows rs{sys ? x : xp, sys ? y : yp, sys ? w : wp, masks, m,
                masks != nullptr ? nt : 0, row0,
                min(static_cast<int64_t>(sys ? m : c), row0 + rpc), d,
                nullptr};
  const int ch = static_cast<int>(gridDim.y);
  const int col0 = blockIdx.y * kChunk;
  const int len = min(kChunk, d - col0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) float smem[];
  double* s_dot = reinterpret_cast<double*>(
      smem + cluster_ring_floats(batch, bufs));  // [2][kWarps][batch]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_dot + 2 * kWarps * batch) +
                  warp * bufs * batch;
  float* ring = smem + warp * bufs * batch * kChunk;

  const int64_t first = rs.row0 + warp;
  const int rows = rs.row_end > first ? static_cast<int>(
      (rs.row_end - first + kWarps - 1) / kWarps) : 0;
  const int rows0 = rs.row_end > rs.row0 ? static_cast<int>(
      (rs.row_end - rs.row0 + kWarps - 1) / kWarps) : 0;
  const int n_batches = (rows0 + batch - 1) / batch;

  if (kVec == 4 && lane == 0) {
    for (int i = 0; i < bufs * batch; ++i) mbar_init(smem_addr(bar + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int k = 0; k < bufs && k < n_batches; ++k)
    issue_batch<kVec>(ring, bar, rs, first, rows, k, batch, bufs, lane, col0,
                      len);
  // beta of the lane's columns, as float64, in registers
  double bd[kLaneCols];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int cl = (lane + 32 * q) * kVec;
    float bv[kVec];
    if (cl < len) load_vec<kVec>(beta + col0 + cl, bv);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      bd[q * kVec + e] = cl < len ? static_cast<double>(bv[e]) : 0.0;
  }
  double acc[kNt][kLaneCols];
#pragma unroll
  for (int t = 0; t < kNt; ++t)
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) acc[t][q] = 0.0;
  __syncthreads();

  for (int k = 0; k < n_batches; ++k) {
    const int buf = k % bufs;
    double* dots = s_dot + ((k & 1) * kWarps + warp) * batch;
    // lane s holds row s's y, w and masks
    const int js = k * batch + lane;
    const bool mine = lane < batch && js < rows;
    float ys = 0.f, ws = 1.f, ms[kNt];
#pragma unroll
    for (int t = 0; t < kNt; ++t) ms[t] = 1.f;
    if (mine) {
      const int64_t r = first + static_cast<int64_t>(js) * kWarps;
      ys = rs.y[r];
      if (rs.w != nullptr) ws = rs.w[r];
#pragma unroll
      for (int t = 0; t < kNt; ++t)
        if (t < rs.nm) ms[t] = rs.masks[t * rs.mask_stride + r];
    }
    if constexpr (kVec == 1) {  // this lane's copies of the batch
      if (bufs == 2 && k + 1 < n_batches) cp_async_wait<1>();
      else cp_async_wait<0>();
    }
    // each row's partial dot over the chunk
    for (int s = 0; s < batch && k * batch + s < rows; ++s) {
      const float* row = ring + (buf * batch + s) * kChunk;
      if constexpr (kVec == 4)
        mbar_wait(smem_addr(bar + buf * batch + s), (k / bufs) & 1);
      double part[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int cl = (lane + 32 * q) * kVec;
        if (col0 + cl < d) {
          float xv[kVec];
          load_vec<kVec>(row + cl, xv);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            part[q % 4] = fma(static_cast<double>(xv[e]), bd[q * kVec + e],
                              part[q % 4]);
        }
      }
      double dot = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) dots[s] = dot;
    }
    cluster_barrier();  // every rank's dots of the batch are written
    // lane s: row s's coefficient, its ranks' dots added in rank order
    double cf = 0.0;
    if (mine) {
      const uint32_t a = smem_addr(dots + lane);
      double v[kMaxCluster];
#pragma unroll
      for (int rk = 0; rk < kMaxCluster; ++rk)
        if (rk < ch) v[rk] = ld_cluster_f64(map_to(a, rk));
      double dot = v[0];
#pragma unroll
      for (int rk = 1; rk < kMaxCluster; ++rk)
        if (rk < ch) dot += v[rk];
      cf = (dot - static_cast<double>(ys)) *
           (rs.w != nullptr ? static_cast<double>(ws) : 1.0);
    }
    for (int s = 0; s < batch && k * batch + s < rows; ++s) {
      const double cs = __shfl_sync(0xffffffffu, cf, s);
      double kt[kNt];  // coef * mask, exact at mask 1.0f
#pragma unroll
      for (int t = 0; t < kNt; ++t) {
        const float mt = __shfl_sync(0xffffffffu, ms[t], s);
        kt[t] = rs.nm > 0 && t < nt ? cs * static_cast<double>(mt) : cs;
      }
      const float* row = ring + (buf * batch + s) * kChunk;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int cl = (lane + 32 * q) * kVec;
        float xv[kVec];
        if (col0 + cl < d) load_vec<kVec>(row + cl, xv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const double xd = col0 + cl < d ? static_cast<double>(xv[e]) : 0.0;
#pragma unroll
          for (int t = 0; t < kNt; ++t)
            acc[t][q * kVec + e] = fma(kt[t], xd, acc[t][q * kVec + e]);
        }
      }
    }
    __syncwarp();  // the batch's stages are consumed
    if (k + bufs < n_batches) {
      if constexpr (kVec == 4)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_batch<kVec>(ring, bar, rs, first, rows, k + bufs, batch, bufs,
                        lane, col0, len);
    }
  }
  // the rings (no other rank reads them) hold the warps' sums
  cta_partial<kNt, kVec>(acc, nt, d, col0, reinterpret_cast<double*>(smem),
                         partials + static_cast<int64_t>(b) * d,
                         static_cast<int64_t>(gridDim.x) * d);
  reduce_cluster_partials(partials, out, counter, gridDim.x, nt, d);
}

// Sets the kernel's dynamic shared memory to `floats` floats and returns
// in *max_red the reducers a launch of it may have: a quarter of the CTAs
// of it that the current device holds at once, at least one (see the
// note at the top).  The count is cached per instance, device and size.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int floats, int* max_red) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> caps;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int bytes = floats * static_cast<int>(sizeof(float));
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, floats);
  const auto it = caps.find(key);
  if (it != caps.end()) {
    *max_red = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, bytes);
  if (e != cudaSuccess) return e;
  const int cap = sms * per_sm / 4;
  *max_red = caps[key] = cap < 1 ? 1 : cap;
  return cudaSuccess;
}

// kNt tiers a launch: 1 (kernel 1's instance) or up to kMaxTiers (the
// run-time tier count); the instance does not change a tier's arithmetic.
// kWide: res holds the coefficients (launch_residual has run).
template <int kNt, int kVec, bool kWide>
cudaError_t launch_tiers(const float* x, const float* y, const float* w,
                         const float* masks, int nt, const float* beta,
                         double* partials, float* out, unsigned* counter,
                         int m, int d, int tile, const double* res,
                         cudaStream_t s) {
  const int ch = kWide ? chunks_for(d) : 1;  // the partition's chunks
  const int rpc = rows_per_cta(m, tile, ch);
  const int nm = masks != nullptr ? nt : 0;
  const int stages = ring_stages(d, nm, rpc, kWide);
  if (stages == 0) return cudaErrorInvalidValue;
  const int floats = smem_floats(d, nm, stages, kWide);
  auto kernel = tier_round_grad_kernel<kNt, kVec, kWide>;
  int max_red = 1;
  const cudaError_t e = prepare(kernel, floats, &max_red);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(ctas_for(m, tile, ch), chunks_for(d)), kThreads,
           floats * sizeof(float), s>>>(x, y, w, masks, nt, beta, partials,
                                        out, counter, m, d, rpc, stages,
                                        max_red, res);
  return cudaGetLastError();
}

template <int kVec, bool kWide>
cudaError_t launch_coded(const float* x, const float* y, const float* w,
                         int m, const float* xp, const float* yp,
                         const float* wp, int c, const float* beta,
                         double* partials, float* out, unsigned* counter,
                         int d, int tile, const double* res,
                         cudaStream_t s) {
  // one row tile for both blocks where it is given
  const int ch = kWide ? chunks_for(d) : 1;  // the partition's chunks
  const int rpc_sys = rows_per_cta(m, tile, ch);
  const int rpc_par = rows_per_cta(c, tile, ch);
  const int n_sys = ctas_for(m, tile, ch);
  const int stages = ring_stages(d, 0, rpc_sys > rpc_par ? rpc_sys : rpc_par,
                                 kWide);
  if (stages == 0) return cudaErrorInvalidValue;
  const int floats = smem_floats(d, 0, stages, kWide);
  auto kernel = coded_round_grad_kernel<kVec, kWide>;
  int max_red = 1;
  const cudaError_t e = prepare(kernel, floats, &max_red);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_sys + ctas_for(c, tile, ch), chunks_for(d)), kThreads,
           floats * sizeof(float), s>>>(x, y, w, m, xp, yp, wp, c, beta,
                                        partials, out, counter, d, rpc_sys,
                                        rpc_par, n_sys, stages, max_red,
                                        res);
  return cudaGetLastError();
}

// The cluster route's launch configuration over row blocks of m
// (rpc_sys rows a CTA) and then c rows (rpc_par; c = 0 for the flat and
// tiered variants): a cluster of chunks_for(d) CTAs along D a row range.
// Sets the kernel's shared memory and, past kPortableCluster CTAs, its
// non-portable cluster size; `attr` holds the cluster dimension.
template <int kNt, int kVec>
cudaError_t cluster_config(int m, int c, int rpc_sys, int rpc_par, int d,
                           cudaStream_t s, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, int* batch, int* bufs) {
  const int ch = chunks_for(d);
  cluster_batches(rpc_sys > rpc_par ? rpc_sys : rpc_par, batch, bufs);
  const int bytes = cluster_smem_floats(*batch, *bufs) *
                    static_cast<int>(sizeof(float));
  auto kernel = cluster_round_grad_kernel<kNt, kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && ch > kPortableCluster)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ctas_for(m, rpc_sys) +
                          (c > 0 ? ctas_for(c, rpc_par) : 0), ch);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = ch;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int kNt, int kVec>
cudaError_t launch_cluster(const float* x, const float* y, const float* w,
                           const float* masks, int nt, int m,
                           const float* xp, const float* yp,
                           const float* wp, int c, int rpc_sys, int rpc_par,
                           const float* beta, double* partials, float* out,
                           unsigned* counter, int d, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int batch = 0, bufs = 0;
  cudaError_t e = cluster_config<kNt, kVec>(m, c, rpc_sys, rpc_par, d, s,
                                            &cfg, &attr, &batch, &bufs);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, cluster_round_grad_kernel<kNt, kVec>, x, y,
                         w, masks, nt, m, xp, yp, wp, c,
                         ctas_for(m, rpc_sys), rpc_sys, rpc_par, beta,
                         partials, out, counter, d, batch, bufs);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The wide instances' residual pass over the rows of x and then xp into
// res (m + c float64).
cudaError_t launch_residual(const float* x, const float* y, const float* w,
                            int m, const float* xp, const float* yp,
                            const float* wp, int c, const float* beta,
                            double* res, int d, bool vec, cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(m) + c;
  if (rows == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>((rows + kResWarps - 1) / kResWarps));
  if (vec)
    residual_kernel<4><<<grid, kResWarps * 32, 0, s>>>(x, y, w, m, xp, yp,
                                                       wp, c, beta, res, d);
  else
    residual_kernel<1><<<grid, kResWarps * 32, 0, s>>>(x, y, w, m, xp, yp,
                                                       wp, c, beta, res, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the (n_ctas, D) float64 partials scratch of the flat and tiered
// variants (per tier) at the kernels' own partition; the coded variant
// needs rg_num_ctas(m) + rg_num_ctas(c).  With a row tile the count is
// ceil(m / tile) (at least 1) per block.  The wide instances' partition
// takes at most as many at any D.
int rg_num_ctas(int m) { return ctas_for(m, 0); }

// The route of a call at this D (`route`): 0 the row-resident instances,
// 1 one launch over clusters along D, 2 the residual pass and the
// column-chunked launch; coded != 0 for the coded variant.
int rg_route(int d, int coded) {
  return static_cast<int>(route(d, coded != 0));
}

// The clusters of the cluster route's launch over m rows at this D and
// tier count (the float4 instance, the kernels' own partition) that the
// current device holds at once (cudaOccupancyMaxActiveClusters), or a
// negative CUDA error; 0 where D takes another route.  For reports.
int rg_cluster_capacity(int m, int d, int nt) {
  if (route(d) != kCluster) return 0;
  const int ch = chunks_for(d);
  const int rpc = rows_per_cta(m, 0, ch, kClusterCtas);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int batch = 0, bufs = 0, clusters = 0;
  cudaError_t e = nt == 1
      ? cluster_config<1, 4>(m, 0, rpc, 0, d, nullptr, &cfg, &attr, &batch,
                             &bufs)
      : cluster_config<kMaxTiers, 4>(m, 0, rpc, 0, d, nullptr, &cfg, &attr,
                                     &batch, &bufs);
  if (e == cudaSuccess)
    e = nt == 1 ? cudaOccupancyMaxActiveClusters(
                      &clusters, cluster_round_grad_kernel<1, 4>, &cfg)
                : cudaOccupancyMaxActiveClusters(
                      &clusters, cluster_round_grad_kernel<kMaxTiers, 4>,
                      &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

// Float64 coefficients the residual scratch `res` of a call over `rows`
// rows at this D holds: `rows` on the two-launch route of the flat and
// tiered variants, else 0 (res may be nullptr); rg_coded_residual_rows
// for the coded one (rows = m + c).
int rg_residual_rows(int rows, int d) {
  return route(d) == kTwoLaunch ? rows : 0;
}
int rg_coded_residual_rows(int rows, int d) {
  return route(d, true) == kTwoLaunch ? rows : 0;
}

// x (m, d), y (m,), w (m,) or nullptr, masks (nt, m) or nullptr (one
// partial, mask 1), beta (d,), out (nt, d): float32; partials (nt,
// n_ctas, d): float64 scratch, n_ctas = rg_num_ctas(m) at tile 0, else
// ceil(m / tile); counter: two zeroed uint32 that no launch on another
// stream uses at the same time (each launch leaves the first at 0); res:
// rg_residual_rows(m, d) float64 scratch; all contiguous, on the device
// of `stream`.  tile: rows a CTA owns, 0 for the kernels' own partition.
int rg_tier_round_gradient(const float* x, const float* y, const float* w,
                           const float* masks, int nt, const float* beta,
                           double* partials, float* out, unsigned* counter,
                           int m, int d, int tile, double* res,
                           void* stream) {
  if (!valid_tile(tile)) return static_cast<int>(cudaErrorInvalidValue);
  const Route rt = route(d);
  const bool wide = rt == kTwoLaunch;
  if (wide && res == nullptr && m > 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ch = rt == kResident ? 1 : chunks_for(d);
  const int target = rt == kCluster ? kClusterCtas : kTargetCtas;
  const int n_ctas = ctas_for(m, tile, ch, target);
  const int rpc = rows_per_cta(m, tile, ch, target);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(beta);
  if (wide) {  // the coefficients once, for every tier chunk
    const cudaError_t e = launch_residual(x, y, w, m, nullptr, nullptr,
                                          nullptr, 0, beta, res, d, vec, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  for (int t0 = 0; t0 < nt; t0 += kMaxTiers) {
    const int k = nt - t0 < kMaxTiers ? nt - t0 : kMaxTiers;
    const float* mk =
        masks == nullptr ? nullptr : masks + static_cast<int64_t>(t0) * m;
    double* part = partials + static_cast<int64_t>(t0) * n_ctas * d;
    float* o = out + static_cast<int64_t>(t0) * d;
    // one tier: kernel 1's instance; more: the run-time tier count
    cudaError_t e;
    if (rt == kCluster)
      e = k == 1 ? (vec ? launch_cluster<1, 4>(x, y, w, mk, k, m, nullptr,
                                               nullptr, nullptr, 0, rpc, 0,
                                               beta, part, o, counter, d, s)
                        : launch_cluster<1, 1>(x, y, w, mk, k, m, nullptr,
                                               nullptr, nullptr, 0, rpc, 0,
                                               beta, part, o, counter, d, s))
                 : (vec ? launch_cluster<kMaxTiers, 4>(
                              x, y, w, mk, k, m, nullptr, nullptr, nullptr,
                              0, rpc, 0, beta, part, o, counter, d, s)
                        : launch_cluster<kMaxTiers, 1>(
                              x, y, w, mk, k, m, nullptr, nullptr, nullptr,
                              0, rpc, 0, beta, part, o, counter, d, s));
    else if (wide)
      e = k == 1 ? (vec ? launch_tiers<1, 4, true>(x, y, w, mk, k, beta,
                                                   part, o, counter, m, d,
                                                   tile, res, s)
                        : launch_tiers<1, 1, true>(x, y, w, mk, k, beta,
                                                   part, o, counter, m, d,
                                                   tile, res, s))
                 : (vec ? launch_tiers<kMaxTiers, 4, true>(
                              x, y, w, mk, k, beta, part, o, counter, m, d,
                              tile, res, s)
                        : launch_tiers<kMaxTiers, 1, true>(
                              x, y, w, mk, k, beta, part, o, counter, m, d,
                              tile, res, s));
    else
      e = k == 1 ? (vec ? launch_tiers<1, 4, false>(x, y, w, mk, k, beta,
                                                    part, o, counter, m, d,
                                                    tile, nullptr, s)
                        : launch_tiers<1, 1, false>(x, y, w, mk, k, beta,
                                                    part, o, counter, m, d,
                                                    tile, nullptr, s))
                 : (vec ? launch_tiers<kMaxTiers, 4, false>(
                              x, y, w, mk, k, beta, part, o, counter, m, d,
                              tile, nullptr, s)
                        : launch_tiers<kMaxTiers, 1, false>(
                              x, y, w, mk, k, beta, part, o, counter, m, d,
                              tile, nullptr, s));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// The flat masked round gradient: the tier variant at one tier, no mask.
int rg_masked_round_gradient(const float* x, const float* y, const float* w,
                             const float* beta, double* partials, float* out,
                             unsigned* counter, int m, int d, int tile,
                             double* res, void* stream) {
  return rg_tier_round_gradient(x, y, w, nullptr, 1, beta, partials, out,
                                counter, m, d, tile, res, stream);
}

// Kernel 6, the least-squares gradient A^T (A beta - y) of the Pallas TPU
// kernel src/repro/kernels/coded_grad/coded_grad.py::lsq_gradient
// (pallas_call at line 69; the server's Eq.-18 parity gradient before
// the 1/c, on the legacy per-epoch path): the flat variant at w = 1, the
// same one-tier instance, row ranges and fixed-order reduce, so it is
// bit-equal to rg_masked_round_gradient with w == nullptr.  It is bound
// by bytes like the flat variant (one pass over A).  a (m, d), y (m,),
// beta (d,), partials (n_ctas, d), out (d,), counter, tile and res as
// above.
int rg_lsq_gradient(const float* a, const float* y, const float* beta,
                    double* partials, float* out, unsigned* counter, int m,
                    int d, int tile, double* res, void* stream) {
  return rg_tier_round_gradient(a, y, nullptr, nullptr, 1, beta, partials,
                                out, counter, m, d, tile, res, stream);
}

// x (m, d), y/w (m,) (w may be nullptr), xp (c, d), yp/wp (c,), beta
// (d,), partials (n_ctas(m) + n_ctas(c), d) float64, out (d,), counter
// as above, res rg_coded_residual_rows(m + c, d) float64; tile 0: each block
// at the kernels' own partition (on the cluster route one row count a
// CTA for both, from m + c rows), else `tile` rows a CTA in both blocks.
int rg_coded_round_gradient(const float* x, const float* y, const float* w,
                            int m, const float* xp, const float* yp,
                            const float* wp, int c, const float* beta,
                            double* partials, float* out, unsigned* counter,
                            int d, int tile, double* res, void* stream) {
  if (!valid_tile(tile)) return static_cast<int>(cudaErrorInvalidValue);
  const Route rt = route(d, true);
  const bool wide = rt == kTwoLaunch;
  if (wide && res == nullptr && m + c > 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(xp) &&
                   aligned16(beta);
  cudaError_t e;
  if (rt == kCluster) {
    // one row count a CTA for both blocks, from all their rows: the
    // launch stays near kClusterCtas CTAs, as the flat one
    const int rpc = rows_per_cta(m + c, tile, chunks_for(d), kClusterCtas);
    e = vec ? launch_cluster<1, 4>(x, y, w, nullptr, 1, m, xp, yp, wp, c,
                                   rpc, rpc, beta, partials, out, counter, d,
                                   s)
            : launch_cluster<1, 1>(x, y, w, nullptr, 1, m, xp, yp, wp, c,
                                   rpc, rpc, beta, partials, out, counter, d,
                                   s);
  } else if (wide) {
    e = launch_residual(x, y, w, m, xp, yp, wp, c, beta, res, d, vec, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = vec ? launch_coded<4, true>(x, y, w, m, xp, yp, wp, c, beta,
                                    partials, out, counter, d, tile, res, s)
            : launch_coded<1, true>(x, y, w, m, xp, yp, wp, c, beta,
                                    partials, out, counter, d, tile, res, s);
  } else {
    e = vec ? launch_coded<4, false>(x, y, w, m, xp, yp, wp, c, beta,
                                     partials, out, counter, d, tile,
                                     nullptr, s)
            : launch_coded<1, false>(x, y, w, m, xp, yp, wp, c, beta,
                                     partials, out, counter, d, tile,
                                     nullptr, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
