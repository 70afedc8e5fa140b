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
Prints the SASS opcode histogram of the one-tier float4 instance.  Needs a CUDA card
(sm_90a) and `nvcc`.
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

    if case.startswith("flat"):
        fn = library_function(path, "rg_masked_round_gradient", sig)

        def run(x, y, w, beta):
            m, d = x.shape
            part = torch.empty((n(m), d), dtype=torch.float64, device=dev)
            out = torch.empty(d, device=dev)
            check(fn(p(x), p(y), p(w), p(beta), p(part), p(out), p(counter),
                     m, d, 0, None, stream))
            return out
    elif case.startswith("tier"):
        fn = library_function(path, "rg_tier_round_gradient", sig)

        def run(x, y, w, masks, beta):
            (m, d), nt = x.shape, masks.shape[0]
            part = torch.empty((nt, n(m), d), dtype=torch.float64,
                               device=dev)
            out = torch.empty((nt, d), device=dev)
            check(fn(p(x), p(y), p(w), p(masks), nt, p(beta), p(part),
                     p(out), p(counter), m, d, 0, None, stream))
            return out
    elif case.startswith("coded"):
        fn = library_function(path, "rg_coded_round_gradient", sig)

        def run(x, y, w, xp, yp, wp, beta):
            (m, d), c = x.shape, xp.shape[0]
            part = torch.empty((n(m) + n(c), d), dtype=torch.float64,
                               device=dev)
            out = torch.empty(d, device=dev)
            check(fn(p(x), p(y), p(w), m, p(xp), p(yp), p(wp), c, p(beta),
                     p(part), p(out), p(counter), d, 0, None, stream))
            return out
    else:
        fn = library_function(path, "rg_lsq_gradient", sig)

        def run(a, y, beta):
            m, d = a.shape
            part = torch.empty((n(m), d), dtype=torch.float64, device=dev)
            out = torch.empty(d, device=dev)
            check(fn(p(a), p(y), p(beta), p(part), p(out), p(counter), m, d,
                     0, None, stream))
            return out
    return run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default=",".join(VARIANTS))
    names = parser.parse_args().only.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print_card()
    built = build_variants("round_grad", {n: VARIANTS[n] for n in names},
                           OUT)
    for name, (_, log) in built.items():
        print(f"{name}: registers {re.findall(r'Used (\d+) registers', log)}"
              f", spill stores {re.findall(r'(\d+) bytes spill stores', log)}",
              flush=True)
    if "kernel" in built:
        print("SASS of tier_round_grad_kernel<1, 4>: " + opcode_histogram(
            built["kernel"][0], "tier_round_grad_kernelILi1ELi4E"),
              flush=True)
    dev = torch.device("cuda")
    cases = operands(dev)
    base = {}
    for name, (path, _) in built.items():
        for case, ops_ in cases.items():
            run = launcher(path, case, dev)
            got = run(*ops_)
            torch.cuda.synchronize()
            if case not in base:
                base[case] = got.clone()
            diff = float((got - base[case]).abs().max())
            if name not in UNCHECKED and diff != 0.0:
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
                  f"{diff:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
