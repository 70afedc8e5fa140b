"""Kernels 1, 4, 5 and 6 against an earlier build of `round_grad.cu`, and
past the row-resident width, on one GPU.

    python3 scripts/round_grad_wide.py [--parent OLD.cu] [--calls 40]

With `--parent`, OLD.cu (an earlier `csrc/round_grad.cu`, for example the
parent commit's from `git archive`; a source whose C entry points take no
residual scratch, as before any D was taken, is called without it) and
the current source are compiled side by side, and at the shapes
`chip_smoke.py` drives (phase 3's operands: the flat kernel at (5632,
500) with weights and (7200, 500) without, the coded kernel at 7200 +
2016 rows, the tier kernel at T = 3 and 8, the least-squares kernel at
(2016, 500); and D = 3000 and the widest row-resident D) each result of
the current build must be `torch.equal` to the earlier one's.  Each case
is then timed cold (operands rotated over copies larger than twice the
L2) in the order earlier, current, current, earlier.

Then, past the row-resident width (768 rows: the coded-head probe's 12 x
64 clients at granite-8b's D = 4096, 230 parity rows; and D = 8192):
kernels 1, 4, 5 (T = 3) and 6 of the current build (and of the earlier
one, with `--parent`), and the plain float32 version, against the
float64 expression within rtol 1e-3 + 1e-6 * S (chip_smoke's bound, S
the summed |terms|), with the share of the bound each reaches, and the
cold times of the kernel (earlier, current, current, earlier with
`--parent`), the plain version, the library product (coef @ X) and the
bound of `repro_torch.roofline.kernel_terms`.  Needs a CUDA card (sm_90a)
and `nvcc`.  To run it against the parent commit, unpack the parent's source into a git-ignored directory first, e.g.
`git show HEAD~1:src/repro_torch/kernels/csrc/round_grad.cu >
build/parent/round_grad.cu`, then `python3 scripts/round_grad_wide.py
--parent build/parent/round_grad.cu`.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from kernel_variants import median_ms, print_card  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.round_grad import ops, ref  # noqa: E402
from repro_torch.roofline import kernel_terms  # noqa: E402

OUT = ROOT / "build" / "round_grad_wide"
L2_BYTES = 50 * 2**20
ENTRIES = ("rg_masked_round_gradient", "rg_tier_round_gradient",
           "rg_coded_round_gradient", "rg_lsq_gradient")


def compile_pair(parent: Path | None) -> dict[str, ctypes.CDLL]:
    """{"current": lib, "parent": lib} compiled together into OUT."""
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"current": build.CSRC / "round_grad.cu"}
    if parent is not None:
        sources["parent"] = parent
    procs = {}
    for name, src in sources.items():
        lib = OUT / f"lib{name}.so"
        procs[name] = (build.start_nvcc(src, lib), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].rg_num_ctas.argtypes = [ctypes.c_int]
        scratch = hasattr(libs[name], "rg_residual_rows")
        if scratch:
            libs[name].rg_residual_rows.argtypes = [ctypes.c_int] * 2
        for entry in ENTRIES:
            args, res = ops._SIGNATURES[entry]
            fn = getattr(libs[name], entry)
            # entry points from before any D take no residual scratch
            fn.argtypes = args if scratch else args[:-2] + args[-1:]
            fn.restype = res
    return libs


def caller(lib: ctypes.CDLL, name: str, dev):
    """{case kind: fn(*operands) -> out} over one build's entry points,
    each at the kernels' own partition (tile 0)."""
    counter = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    current = hasattr(lib, "rg_residual_rows")  # takes the scratch

    def p(t):
        return None if t is None else t.data_ptr()

    def scratch(rows, d, coded):
        rows_of = lib.rg_residual_rows
        if coded and hasattr(lib, "rg_coded_residual_rows"):
            rows_of = lib.rg_coded_residual_rows
            rows_of.argtypes = [ctypes.c_int] * 2
        n = rows_of(rows, d) if current else 0
        return (torch.empty(n, dtype=torch.float64, device=dev),) \
            if n else (None,)

    def tail(rows, d, coded=False):  # (tile, [res,] stream)
        return (0,) + (tuple(p(t) for t in scratch(rows, d, coded))
                       if current else ()) + (stream,)

    def check(status, what):
        if status != 0:
            raise RuntimeError(f"{name} {what}: CUDA error {status}")

    def flat(x, y, w, beta):
        m, d = x.shape
        part = torch.empty((lib.rg_num_ctas(m), d), dtype=torch.float64,
                           device=dev)
        out = torch.empty(d, device=dev)
        check(lib.rg_masked_round_gradient(
            p(x), p(y), p(w), p(beta), p(part), p(out), p(counter), m, d,
            *tail(m, d)), "flat")
        return out

    def tier(x, y, w, masks, beta):
        (m, d), nt = x.shape, masks.shape[0]
        part = torch.empty((nt, lib.rg_num_ctas(m), d), dtype=torch.float64,
                           device=dev)
        out = torch.empty((nt, d), device=dev)
        check(lib.rg_tier_round_gradient(
            p(x), p(y), p(w), p(masks), nt, p(beta), p(part), p(out),
            p(counter), m, d, *tail(m, d)), "tier")
        return out

    def coded(x, y, w, xp, yp, wp, beta):
        (m, d), c = x.shape, xp.shape[0]
        part = torch.empty((lib.rg_num_ctas(m) + lib.rg_num_ctas(c), d),
                           dtype=torch.float64, device=dev)
        out = torch.empty(d, device=dev)
        check(lib.rg_coded_round_gradient(
            p(x), p(y), p(w), m, p(xp), p(yp), p(wp), c, p(beta), p(part),
            p(out), p(counter), d, *tail(m + c, d, coded=True)), "coded")
        return out

    def lsq(a, y, beta):
        m, d = a.shape
        part = torch.empty((lib.rg_num_ctas(m), d), dtype=torch.float64,
                           device=dev)
        out = torch.empty(d, device=dev)
        check(lib.rg_lsq_gradient(p(a), p(y), p(beta), p(part), p(out),
                                  p(counter), m, d, *tail(m, d)), "lsq")
        return out

    return {"flat": flat, "tier": tier, "coded": coded, "lsq": lsq}


def driven_cases(dev, widest: int) -> dict[str, tuple]:
    """{label: (kind, operands)} at chip_smoke's driven shapes and at the
    row-resident edge."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rows(m, d, weights):
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((m,), generator=gen, device=dev)
        w = torch.rand((m,), generator=gen, device=dev) if weights else None
        if w is not None:
            w[::7] = 0.0
        return x, y, w

    cases = {}
    x, y, w = rows(5632, 500, True)
    beta = torch.randn((500,), generator=gen, device=dev)
    cases["flat (5632, 500) w=rand"] = ("flat", (x, y, w, beta))
    xu, yu, _ = rows(7200, 500, False)
    cases["flat (7200, 500) w=None"] = ("flat", (xu, yu, None, beta))
    for nt in (3, 8):
        tier_of = torch.randint(0, nt, (5632,), generator=gen, device=dev)
        masks = (torch.arange(nt, device=dev)[:, None]
                 == tier_of[None, :]).float()
        cases[f"tier (5632, 500) T={nt}"] = ("tier", (x, y, w, masks, beta))
    xp, yp, _ = rows(2016, 500, False)
    wp = (torch.rand((2016,), generator=gen, device=dev) < 0.5).float() / 0.5
    cases["coded (7200 + 2016, 500)"] = (
        "coded", (xu, yu, torch.ones_like(yu), xp, yp, wp, beta))
    cases["lsq (2016, 500)"] = ("lsq", (xp, yp, beta))
    for d in (3000, widest):
        xd, yd, wd = rows(300, d, True)
        bd = torch.randn((d,), generator=gen, device=dev)
        cases[f"flat (300, {d}) w=rand"] = ("flat", (xd, yd, wd, bd))
        cases[f"coded (200 + 100, {d})"] = (
            "coded", (xd[:200], yd[:200], wd[:200], xd[200:], yd[200:],
                      wd[200:], bd))
    return cases


def cold_ms(fn, operands, calls: int) -> float:
    """Median time of one call in ms, rotating over copies of the
    operands larger than twice the L2 together."""
    size = sum(t.numel() * t.element_size() for t in operands
               if t is not None)
    copies = [tuple(None if t is None else t.clone() for t in operands)
              for _ in range(-(-2 * L2_BYTES // size) + 1)]
    cycle = itertools.cycle(copies)
    ms, _ = median_ms(lambda: fn(*next(cycle)), calls=calls)
    return ms


def share_of_bound(got, x, y, w, beta, masks=None) -> float:
    """Largest |got - float64| / (1e-3 |float64| + 1e-6 S)."""
    x64, y64, b64 = x.double(), y.double(), beta.double()
    w64 = torch.ones_like(y64) if w is None else w.double()
    ms = torch.ones((1, x.shape[0]), dtype=torch.float64, device=x.device) \
        if masks is None else masks.double()
    exact = ((x64 @ b64 - y64) * w64 * ms) @ x64
    scale = ((w64.abs() * ms.abs()) * (x64.abs() @ b64.abs() + y64.abs())) \
        @ x64.abs()
    err = (got.double().reshape(exact.shape) - exact).abs()
    return float((err / (1e-3 * exact.abs() + 1e-6 * scale)).max())


def wide_report(dev, calls: int, builds: dict | None) -> bool:
    """Kernels 1, 4, 5 and 6 at D = 4096 and 8192 against float64 and
    plain, with cold times (of both builds in turns where `builds` holds
    {"parent": calls, "current": calls} from `caller`); True when every
    one is inside the bound."""
    gen = torch.Generator(device=dev).manual_seed(1)
    ok = True
    for m, d in ((768, 4096), (768, 8192)):
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((m,), generator=gen, device=dev)
        w = torch.rand((m,), generator=gen, device=dev)
        beta = torch.randn((d,), generator=gen, device=dev)
        xp = torch.randn((230, d), generator=gen, device=dev)
        yp = torch.randn((230,), generator=gen, device=dev)
        wp = torch.rand((230,), generator=gen, device=dev)
        tier_of = torch.randint(0, 3, (m,), generator=gen, device=dev)
        masks = (torch.arange(3, device=dev)[:, None]
                 == tier_of[None, :]).float()
        coef = ((x @ beta - y) * w).contiguous()
        cases = {
            "kernel 1": ("flat", ops.masked_round_gradient,
                         ref.masked_round_gradient, (x, y, w, beta),
                         ("round_grad", (m, d)),
                         lambda c, xs: c @ xs, (coef, x),
                         dict(x=x, y=y, w=w, beta=beta)),
            "kernel 4": ("coded", ops.coded_round_gradient,
                         ref.coded_round_gradient,
                         (x, y, w, xp, yp, wp, beta),
                         ("coded_round_grad", (m, 230, d)),
                         lambda c, xs: c @ xs,
                         (torch.cat([coef, (xp @ beta - yp) * wp]),
                          torch.cat([x, xp])),
                         dict(x=torch.cat([x, xp]), y=torch.cat([y, yp]),
                              w=torch.cat([w, wp]), beta=beta)),
            "kernel 5": ("tier", ops.tier_masked_round_gradient,
                         ref.tier_masked_round_gradient,
                         (x, y, w, masks, beta),
                         ("tier_round_grad", (m, d, 3)),
                         lambda c, xs: c @ xs,
                         ((coef[None, :] * masks).contiguous(), x),
                         dict(x=x, y=y, w=w, beta=beta, masks=masks)),
            "kernel 6": ("lsq", ops.lsq_gradient, ref.lsq_gradient,
                         (x, y, beta), ("coded_grad", (m, d)),
                         lambda c, xs: c @ xs,
                         ((x @ beta - y).contiguous(), x),
                         dict(x=x, y=y, w=None, beta=beta)),
        }
        for name, (kind, kfn, pfn, operands, (family, shape), lib_fn,
                   lib_ops, exact) in cases.items():
            got, plain = kfn(*operands), pfn(*operands)
            again = kfn(*operands)
            old = builds["parent"][kind](*operands) if builds else None
            torch.cuda.synchronize()
            k_share = share_of_bound(got, **exact)
            p_share = share_of_bound(plain, **exact)
            o_share = share_of_bound(old, **exact) if builds else 0.0
            terms = kernel_terms(family, shape)
            if builds:
                k_times = [cold_ms(builds[n][kind], operands, calls)
                           for n in ("parent", "current", "current",
                                     "parent")]
                times = ("cold us earlier, current, current, earlier "
                         + ", ".join(f"{1e3 * t:.3f}" for t in k_times))
            else:
                times = f"cold kernel {1e3 * cold_ms(kfn, operands, calls)!r} us"
            p_ms = cold_ms(pfn, operands, calls)
            l_ms = cold_ms(lib_fn, lib_ops, calls)
            inside = max(k_share, p_share, o_share) <= 1.0 and \
                torch.equal(got, again)
            ok &= inside
            print(f"{name} {shape} (route "
                  f"{ops.route(d, coded=kind == 'coded')}): float64-bound "
                  f"share kernel {k_share:.3e}"
                  + (f", earlier build {o_share:.3e}" if builds else "")
                  + f", plain {p_share:.3e}; max |kernel - plain| "
                  f"{float((got - plain).abs().max()):.3e}; relaunch "
                  f"bit-identical {torch.equal(got, again)}; {times}; plain "
                  f"{1e3 * p_ms!r} us, library coef @ X {1e3 * l_ms!r} us, "
                  f"bound {1e6 * terms['bound_s']!r} us ({terms['bound_by']}, "
                  f"{int(terms['bytes'])} bytes)", flush=True)
    return ok


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--calls", type=int, default=40)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print_card()
    dev = resolve_device("cuda")
    ok = True
    calls = None
    if args.parent is not None:
        libs = compile_pair(args.parent)
        widest = ops.RESIDENT_MAX_D
        print(f"widest row-resident D {widest}", flush=True)
        calls = {name: caller(lib_, name, dev) for name, lib_ in libs.items()}
        for label, (kind, operands) in driven_cases(dev, widest).items():
            old = calls["parent"][kind](*operands)
            new = calls["current"][kind](*operands)
            torch.cuda.synchronize()
            equal = torch.equal(old, new)
            ok &= equal
            times = [cold_ms(calls[n][kind], operands, args.calls)
                     for n in ("parent", "current", "current", "parent")]
            print(f"{label}: torch.equal to the earlier build {equal}; cold "
                  f"us earlier, current, current, earlier "
                  + ", ".join(f"{1e3 * t:.3f}" for t in times), flush=True)
    ok &= wide_report(dev, args.calls, calls)
    print(f"round_grad_wide ok {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
