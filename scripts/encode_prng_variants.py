"""Time variants of the in-kernel-generator encode kernel on one GPU.

    python3 scripts/encode_prng_variants.py

Builds `src/repro_torch/kernels/csrc/encode.cu` and three variants of its
`encode_prng_kernel`, each made by replacing one line of the source,
through `kernel_variants.build_variants` (one `nvcc` per variant, all
started together, into `build/encode_prng_variants/`; a variant whose
line is no longer in the source exactly once stops the script), and
times each at the fleet path's shape, C = 2016, L = 300, D = 501, for
both generator kinds:

  * kernel      — the source as it is;
  * w_at_x_load — diag(w) applied to each X element as it is loaded
                  instead of to the hashed G entry;
  * no_x_loads  — X elements made from their index, no global loads:
                  what the products and the hash cost alone;
  * no_hash     — G entries made from their index, no threefry and no
                  erfinv: what the products and the loads cost alone.

Time: `kernel_variants.median_ms`, CUDA events around 20 back-to-back
launches on the same operands (warm in L2), queued behind a sleep
kernel, median of 7 runs.  Prints each variant's registers (ptxas), its
time, and its largest difference from the unmodified kernel relative to
max|kernel|.  Needs a CUDA card (sm_90a) and `nvcc`.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from kernel_variants import (build_variants, library_function,  # noqa: E402
                             median_ms, print_card)
from repro_torch.kernels.encode import ops, prng  # noqa: E402

OUT = ROOT / "build" / "encode_prng_variants"
X_LOAD = "? x[static_cast<int64_t>(gk) * d + gn]"
G_ENTRY = ("g_reg = bits_to_generator(bits_at(k0, k1, idx, size), kind) "
           "* w[gk];")
VARIANTS = {
    "kernel": {},
    "w_at_x_load": {
        X_LOAD: "? w[gk] * x[static_cast<int64_t>(gk) * d + gn]",
        G_ENTRY: "g_reg = bits_to_generator(bits_at(k0, k1, idx, size), "
                 "kind);"},
    "no_x_loads": {X_LOAD: "? 1e-3f * static_cast<float>(gk + gn)"},
    "no_hash": {G_ENTRY: "g_reg = (1.0f + 1e-6f * static_cast<float>(idx))"
                         " * w[gk];"},
}
C, L, D = 2016, 300, 501


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print_card()
    built = build_variants("encode", VARIANTS, OUT)
    for name, (_, log) in built.items():
        regs = re.search(r"encode_prng_kernel.*?Used (\d+) registers", log,
                         re.S)
        print(f"{name}: {regs[1] if regs else '?'} registers", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.rand(L, generator=gen, device=dev)
    x = torch.randn((L, D), generator=gen, device=dev)
    k0, k1 = prng.key_words(prng.prng_key(1))
    stream = torch.cuda.current_stream().cuda_stream
    base = {}
    for name, (path, _) in built.items():
        fn = library_function(path, "enc_encode_parity_prng",
                              ops._SIGNATURES)
        for kind, code in (("normal", 0), ("bernoulli", 1)):
            out = torch.empty((C, D), device=dev)

            def launch():
                if fn(k0, k1, w.data_ptr(), x.data_ptr(), out.data_ptr(), C,
                      L, D, code, 0, stream) != 0:
                    raise RuntimeError(f"{name} launch failed")

            launch()
            torch.cuda.synchronize()
            base.setdefault(kind, out.clone())
            rel = float((out - base[kind]).abs().max()
                        / base[kind].abs().max())
            ms, low = median_ms(launch)
            print(f"{name} {kind}: {1e3 * ms!r} us (min {1e3 * low!r}); "
                  f"max |diff| / max|kernel| {rel:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
