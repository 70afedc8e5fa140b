"""Time variants of the round-gradient kernels (kernels 1, 4, 5, 6) on
one GPU.

    python3 scripts/round_grad_variants.py [--only NAME,NAME]

Builds `src/repro_torch/kernels/csrc/round_grad.cu` and variants of it,
each made by replacing a line of the source, through
`kernel_variants.build_variants` (one `nvcc` per variant, all started
together, into `build/round_grad_variants/`; each replaced line must
occur once in the source, or the script stops):

  * kernel    — the source as it is: each warp a ring of up to 4 rows,
                ~128 CTAs (the row partition's target), one reducer per
                16 columns, at most 32;
  * stages2   — rings of 2 rows;
  * stages3   — rings of 3 rows;
  * stages6   — rings of up to 6 rows;
  * ctas64    — ~64 CTAs, twice the rows each;
  * ctas256   — ~256 CTAs, half the rows each;
  * reducers1 — the last CTA alone sums every partial;
  * reducers4 — at most 4 reducers;
  * wait_all  — each row waits for every copy in flight;
  * no_dot    — the residuals' dot products skipped;
  * no_acc    — the accumulation skipped;
  * no_copy   — X's rows not copied (the rings hold whatever they held);
  * threads512 — 16 warps a CTA (3 rows each at M = 5632);
  * no_reduce — no ticket and no reduce (wrong results): the streaming
                pass and the launch;
  * no_stream — zero partials, then the reduce: the launch and the
                reduce;
  * empty     — every CTA returns at once: the launch alone.

Each is timed on the driven paths' shapes: the flat kernel at (5632,
500) with weights and at (7200, 500) with w = None, the tier kernel at
(5632, 500), T = 3, the coded kernel at 7200 + 2016 rows of 500 and the
least-squares gradient at (2016, 500); cold (each call on another copy
of the operands, the copies together over twice the L2) and warm (one
copy).  Time: `kernel_variants.median_ms`, CUDA events around 20
back-to-back launches queued behind a sleep kernel, median of 7 runs.
The reduce's order does not depend on the variant, so every variant's
results must equal the unmodified kernel's bit for bit (the script
stops otherwise), except where the row partition changes (ctas64,
ctas256) or the work is cut, which print their largest difference.
Prints the SASS opcode histogram of the one-tier float4 instance.

With `--wide`, variants of the cluster route past the row-resident
width instead, timed at (768, 4096) and (768, 8192) (the flat kernel
with weights, the tier kernel at T = 3, and the coded kernel with 230
parity rows at 4096), each against the float64 expression:

  * kernel        — the source as it is;
  * two_launch    — every wide D on the residual pass and the
                    column-chunked launch (the route before the clusters);
  * cl_no_reduce  — no ticket and no reduce (wrong results);
  * cl_no_exchange — each CTA's coefficient from its own chunk's dot, no
                    cluster barrier a batch (wrong results);
  * cl_no_copy    — no bulk copy and no wait on its barrier (wrong
                    results): what staging X costs;
  * cl_copy_only  — the bulk copies and their waits alone, then zero
                    partials and the reduce (wrong results);
  * cl_batch4     — kBatch rows a batch, two batches in flight, at every
                    row count;
  * cl_ctas128 / cl_ctas64 — the cluster partition aimed at ~128 / ~64
                    CTAs in all (112 in the kernel);
  * cl_4byte      — 4-byte cp.async copies in place of the bulk copies;
  * cl_empty      — every CTA returns at once: the cluster launch alone.

Needs a CUDA card (sm_90a) and `nvcc`.
"""
from __future__ import annotations

import argparse
import itertools
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from kernel_variants import (build_variants, library_function,  # noqa: E402
                             median_ms, opcode_histogram, print_card)
from repro_torch.kernels.round_grad import ops  # noqa: E402

OUT = ROOT / "build" / "round_grad_variants"
STAGES = "constexpr int kMaxStages = 4;"
CTAS = "constexpr int kTargetCtas = 128;"
REDUCERS = "constexpr int kMaxReducers = 32;"
WAIT = "cp_async_wait_pending(stages - 2);"
DOT = ("if (c < d) part[q % 4] = fma(xd[q * kVec + e], s_beta[c + e],\n"
       "                                       part[q % 4]);")
ACC = "acc[t][q] = fma(k[t], xd[q], acc[t][q]);"
COPY = "cp_async<kVec>(stage + c, src + c);"
THREADS = "constexpr int kThreads = 256;"
TIER_REDUCE = ("  reduce_partials<kVec == 4 ? 2 : 1>(partials, out, counter, "
               "gridDim.x,\n                                     gridDim.x * "
               "gridDim.y, nt, d, max_red);\n")
N_ROWS = "const int n_rows = rs.row_end > first ?"
TIER_ENTRY = "  const Rows rs{x, y, w, masks, m, masks != nullptr ? nt : 0, row0,"
VARIANTS = {
    "kernel": {},
    "stages2": {STAGES: "constexpr int kMaxStages = 2;"},
    "stages3": {STAGES: "constexpr int kMaxStages = 3;"},
    "stages6": {STAGES: "constexpr int kMaxStages = 6;"},
    "ctas64": {CTAS: "constexpr int kTargetCtas = 64;"},
    "ctas256": {CTAS: "constexpr int kTargetCtas = 256;"},
    "reducers1": {REDUCERS: "constexpr int kMaxReducers = 1;"},
    "reducers4": {REDUCERS: "constexpr int kMaxReducers = 4;"},
    "wait_all": {WAIT: "cp_async_wait<0>();"},
    "no_dot": {DOT: "(void)0;"},
    "no_acc": {ACC: "(void)0;"},
    "no_copy": {COPY: "(void)src;"},
    "threads512": {THREADS: "constexpr int kThreads = 512;"},
    "no_reduce": {TIER_REDUCE: ""},
    "no_stream": {N_ROWS: "const int n_rows = false ?"},
    "empty": {TIER_ENTRY: "  if (d > 0) return;\n" + TIER_ENTRY},
}
ROUTE = "return chunks_for(d) <= kMaxCluster ? kCluster : kTwoLaunch;"
CL_REDUCE = "  reduce_cluster_partials(partials, out, counter, gridDim.x, nt, d);\n"
CL_BARRIER = "    cluster_barrier();  // every rank's dots of the batch are written\n"
CL_REMOTE = "        if (rk < ch) v[rk] = ld_cluster_f64(map_to(a, rk));"
CL_COPY = ("        bulk_row(ring + slot * kChunk, src, 4u * len, "
           "smem_addr(bar + slot));")
CL_WAIT = "        mbar_wait(smem_addr(bar + buf * batch + s), (k / bufs) & 1);"
CL_BATCHES = "  for (int k = 0; k < n_batches; ++k) {\n    const int buf = k % bufs;"
CL_ACC = "            acc[t][q * kVec + e] = fma(kt[t], xd, acc[t][q * kVec + e]);"
CL_ENTRY = "  constexpr int kQ = kLaneCols / kVec;  // register chunks a lane\n  const int b = blockIdx.x;\n  const bool sys = b < n_sys;"
WHOLE = "constexpr int kWholeRows = 12;"
CL_CTAS = "constexpr int kClusterCtas = 112;"
VEC = "  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(beta);\n  if (wide) {"
WIDE_VARIANTS = {
    "kernel": {},
    "two_launch": {ROUTE: "return kTwoLaunch;"},
    "cl_no_reduce": {CL_REDUCE: "  if (d > 0) return;\n" + CL_REDUCE},
    "cl_no_exchange": {CL_BARRIER: "", CL_REMOTE: "v[rk] = dots[lane];"},
    "cl_no_copy": {CL_COPY: "        (void)src;", CL_WAIT: "(void)0;"},
    "cl_copy_only": {CL_BARRIER: "", CL_REMOTE: "v[rk] = 0.0;",
                     CL_ACC: "(void)xd;"},
    "cl_batch4": {WHOLE: "constexpr int kWholeRows = 0;"},
    "cl_ctas128": {CL_CTAS: "constexpr int kClusterCtas = 128;"},
    "cl_ctas64": {CL_CTAS: "constexpr int kClusterCtas = 64;"},
    "cl_4byte": {VEC: VEC.replace("const bool vec = ", "const bool vec = false && ")},
    "cl_empty": {CL_ENTRY: CL_ENTRY.replace("  const int b = blockIdx.x;\n",
                                            "  if (d > 0) return;\n  const int b = blockIdx.x;\n")},
}
# variants whose sums take another order or whose work is cut
UNCHECKED = {"ctas64", "ctas256", "threads512", "no_reduce", "no_stream",
             "empty", "no_dot", "no_acc", "no_copy"}
L2_BYTES = 50 * 2**20


def operands(dev) -> dict[str, tuple]:
    """{case: operand tuple} at the driven paths' shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rows(m, d=500):
        return (torch.randn((m, d), generator=gen, device=dev),
                torch.randn((m,), generator=gen, device=dev),
                torch.rand((m,), generator=gen, device=dev))

    x, y, w = rows(5632)
    xu, yu, _ = rows(7200)
    xp, yp, wp = rows(2016)
    beta = torch.randn((500,), generator=gen, device=dev)
    tier = torch.randint(0, 3, (5632,), generator=gen, device=dev)
    masks = (torch.arange(3, device=dev)[:, None] == tier[None, :]).float()
    return {"flat (5632, 500)": (x, y, w, beta),
            "flat (7200, 500) w=None": (xu, yu, None, beta),
            "tier (5632, 500) T=3": (x, y, w, masks, beta),
            "coded (7200 + 2016, 500)": (xu, yu, torch.ones_like(yu), xp,
                                         yp, wp, beta),
            "lsq (2016, 500)": (xp, yp, beta)}


def wide_operands(dev) -> dict[str, tuple]:
    """{case: operand tuple} past the row-resident width."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for d in (4096, 8192):
        x = torch.randn((768, d), generator=gen, device=dev)
        y = torch.randn((768,), generator=gen, device=dev)
        w = torch.rand((768,), generator=gen, device=dev)
        beta = torch.randn((d,), generator=gen, device=dev)
        tier = torch.randint(0, 3, (768,), generator=gen, device=dev)
        masks = (torch.arange(3, device=dev)[:, None]
                 == tier[None, :]).float()
        out[f"flat (768, {d})"] = (x, y, w, beta)
        out[f"tier (768, {d}) T=3"] = (x, y, w, masks, beta)
        if d == 4096:
            out[f"coded (768 + 230, {d})"] = (
                x, y, w, torch.randn((230, d), generator=gen, device=dev),
                torch.randn((230,), generator=gen, device=dev),
                torch.rand((230,), generator=gen, device=dev), beta)
    return out


def float64_share(got, case: str, ops_) -> float:
    """Largest |got - float64| / (1e-3 |float64| + 1e-6 S) of a case."""
    if case.startswith("coded"):
        x, y, w, xp, yp, wp, beta = ops_
        x, y, w, masks = (torch.cat([x, xp]), torch.cat([y, yp]),
                          torch.cat([w, wp]), None)
    elif case.startswith("tier"):
        x, y, w, masks, beta = ops_
    else:
        (x, y, w, beta), masks = ops_, None
    x64, y64, b64, w64 = x.double(), y.double(), beta.double(), w.double()
    ms = torch.ones((1, x.shape[0]), dtype=torch.float64, device=x.device) \
        if masks is None else masks.double()
    exact = ((x64 @ b64 - y64) * w64 * ms) @ x64
    scale = ((w64.abs() * ms.abs()) * (x64.abs() @ b64.abs() + y64.abs())) \
        @ x64.abs()
    err = (got.double().reshape(exact.shape) - exact).abs()
    return float((err / (1e-3 * exact.abs() + 1e-6 * scale)).max())


def launcher(path: Path, case: str, dev):
    """A function of the case's operands that launches the variant's
    kernel on them into a fresh output and returns the output."""
    sig = ops._SIGNATURES
    counter = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = library_function(path, "rg_num_ctas", sig)

    def p(t):
        return None if t is None else t.data_ptr()

    def check(status):
        if status != 0:
            raise RuntimeError(f"{path.name} {case}: CUDA error {status}")

    # the residual scratch, which only the two-launch route reads
    res = torch.empty(768 + 2016 + 7200, dtype=torch.float64, device=dev)

    if case.startswith("flat"):
        fn = library_function(path, "rg_masked_round_gradient", sig)

        def run(x, y, w, beta):
            m, d = x.shape
            part = torch.empty((n(m), d), dtype=torch.float64, device=dev)
            out = torch.empty(d, device=dev)
            check(fn(p(x), p(y), p(w), p(beta), p(part), p(out), p(counter),
                     m, d, 0, p(res), stream))
            return out
    elif case.startswith("tier"):
        fn = library_function(path, "rg_tier_round_gradient", sig)

        def run(x, y, w, masks, beta):
            (m, d), nt = x.shape, masks.shape[0]
            part = torch.empty((nt, n(m), d), dtype=torch.float64,
                               device=dev)
            out = torch.empty((nt, d), device=dev)
            check(fn(p(x), p(y), p(w), p(masks), nt, p(beta), p(part),
                     p(out), p(counter), m, d, 0, p(res), stream))
            return out
    elif case.startswith("coded"):
        fn = library_function(path, "rg_coded_round_gradient", sig)

        def run(x, y, w, xp, yp, wp, beta):
            (m, d), c = x.shape, xp.shape[0]
            part = torch.empty((n(m) + n(c), d), dtype=torch.float64,
                               device=dev)
            out = torch.empty(d, device=dev)
            check(fn(p(x), p(y), p(w), m, p(xp), p(yp), p(wp), c, p(beta),
                     p(part), p(out), p(counter), d, 0, p(res), stream))
            return out
    else:
        fn = library_function(path, "rg_lsq_gradient", sig)

        def run(a, y, beta):
            m, d = a.shape
            part = torch.empty((n(m), d), dtype=torch.float64, device=dev)
            out = torch.empty(d, device=dev)
            check(fn(p(a), p(y), p(beta), p(part), p(out), p(counter), m, d,
                     0, p(res), stream))
            return out
    return run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default=None)
    parser.add_argument("--wide", action="store_true")
    args = parser.parse_args()
    variants = WIDE_VARIANTS if args.wide else VARIANTS
    names = (args.only or ",".join(variants)).split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print_card()
    built = build_variants("round_grad", {n: variants[n] for n in names},
                           OUT / ("wide" if args.wide else ""))
    for name, (_, log) in built.items():
        print(f"{name}: registers {re.findall(r'Used (\d+) registers', log)}"
              f", spill stores {re.findall(r'(\d+) bytes spill stores', log)}",
              flush=True)
    if "kernel" in built and not args.wide:
        print("SASS of tier_round_grad_kernel<1, 4>: " + opcode_histogram(
            built["kernel"][0], "tier_round_grad_kernelILi1ELi4E"),
              flush=True)
    dev = torch.device("cuda")
    if args.wide and "kernel" in built:
        capacity = library_function(built["kernel"][0], "rg_cluster_capacity",
                                    ops._SIGNATURES)
        for d in (4096, 8192):
            print(f"clusters the card holds at once at (768, {d}): one tier "
                  f"{capacity(768, d, 1)}, four tiers {capacity(768, d, 3)}",
                  flush=True)
    cases = wide_operands(dev) if args.wide else operands(dev)
    base = {}
    for name, (path, _) in built.items():
        for case, ops_ in cases.items():
            run = launcher(path, case, dev)
            got = run(*ops_)
            torch.cuda.synchronize()
            if case not in base:
                base[case] = got.clone()
            diff = float((got - base[case]).abs().max())
            share = (f"; float64-bound share {float64_share(got, case, ops_):.3e}"
                     if args.wide else "")
            if not args.wide and name not in UNCHECKED and diff != 0.0:
                raise RuntimeError(f"{name} {case}: differs from the kernel "
                                   f"by {diff:.3e}")
            size = sum(t.numel() * 4 for t in ops_ if t is not None)
            copies = [tuple(None if t is None else t.clone() for t in ops_)
                      for _ in range(-(-2 * L2_BYTES // size) + 1)]
            cycle = itertools.cycle(copies)
            cold, _ = median_ms(lambda: run(*next(cycle)))
            warm, _ = median_ms(lambda: run(*ops_))
            del copies, cycle
            print(f"{name} {case}: cold {1e3 * cold!r} us, warm "
                  f"{1e3 * warm!r} us; max |diff| from the kernel "
                  f"{diff:.3e}{share}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
