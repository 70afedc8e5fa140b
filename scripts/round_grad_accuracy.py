"""The flat round-gradient kernel and its plain version against float64
on one GPU, at chip_smoke's inputs.

    python3 scripts/round_grad_accuracy.py

Draws the operands phase 3 of `chip_smoke.py` draws for kernel 1 (a
generator seeded 0 on the card: (5632, 500) with random weights, every
seventh zero, then (7200, 500) with w = None) and prints, for each, the
element where the kernel and the plain float32 expression are furthest
apart relative to chip_smoke's bound (rtol 1e-3, atol 1e-6 of the plain
value), both values' errors there against the float64 expression, and
each one's mean and largest error over all elements.  Needs a CUDA card
(sm_90a) and `nvcc`.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from kernel_variants import print_card  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.round_grad import ops, ref  # noqa: E402

CASES = {"coded": (5632, 500, True), "uncoded": (7200, 500, False)}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print_card()
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, (m, d, weighted) in CASES.items():
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((m,), generator=gen, device=dev)
        w = torch.rand((m,), generator=gen, device=dev) if weighted else None
        if w is not None:
            w[::7] = 0.0
        beta = torch.randn((d,), generator=gen, device=dev)
        got = ops.masked_round_gradient(x, y, w, beta)
        want = ref.masked_round_gradient(x, y, w, beta)
        w64 = None if w is None else w.double()
        exact = ref.masked_round_gradient(x.double(), y.double(), w64,
                                          beta.double())
        share = (got - want).abs() / (1e-6 + 1e-3 * want.abs())
        i = int(share.argmax())
        print(f"{label} ({m}, {d}): element {i}, float64 value "
              f"{float(exact[i])!r}, kernel - plain at "
              f"{float(share[i]):.3f} of chip_smoke's bound", flush=True)
        for name, v in (("kernel", got), ("plain", want)):
            err = v.double() - exact
            print(f"  {name}: {float(v[i])!r}, error {float(err[i])!r}; "
                  f"mean |error| {float(err.abs().mean())!r}, largest "
                  f"{float(err.abs().max())!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
