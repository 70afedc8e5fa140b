"""Time variants of the in-kernel-generator encode kernel on one GPU.

    python3 scripts/encode_prng_variants.py

Builds `src/repro_torch/kernels/csrc/encode.cu` and three variants of its
`encode_prng_kernel`, each made by replacing one line of the source
(one `nvcc` per variant through `kernels.build.start_nvcc`, all started
together, into `build/encode_prng_variants/`; a variant whose line is no
longer in the source stops the script), and times each at the fleet
path's shape, C = 2016, L = 300, D = 501, for both generator kinds:

  * kernel       — the source as it is;
  * w_at_x_load  — diag(w) applied to each X element as it is loaded
                   (the fusion `encode_kernel` uses) instead of to the
                   hashed G entry;
  * no_x_loads   — X elements made from their index, no global loads:
                   what the products and the hash cost alone;
  * no_hash      — G entries made from their index, no threefry and no
                   erfinv: what the products and the loads cost alone.

Time: CUDA events around 20 back-to-back launches on the same operands
(warm in L2), queued behind a sleep kernel, median of 7 runs.  Prints
each variant's registers (ptxas), its time, and its largest difference
from the unmodified kernel relative to max|kernel|.  Needs a CUDA card
(sm_90a) and `nvcc`.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.encode import prng  # noqa: E402

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


def build_variants() -> dict[str, Path]:
    source = (build.CSRC / "encode.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not one line of "
                                   f"encode.cu")
            text = text.replace(old, new)
        src = OUT / f"{name}.cu"
        src.write_text(text)
        lib = OUT / f"lib{name}.so"
        procs[name] = (build.start_nvcc(src, lib), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        regs = re.search(r"encode_prng_kernel.*?Used (\d+) registers", log,
                         re.S)
        print(f"{name}: {regs[1] if regs else '?'} registers", flush=True)
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.rand(L, generator=gen, device=dev)
    x = torch.randn((L, D), generator=gen, device=dev)
    k0, k1 = prng.key_words(prng.prng_key(1))
    stream = torch.cuda.current_stream().cuda_stream
    base = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).enc_encode_parity_prng
        fn.argtypes = [ctypes.c_uint32] * 2 + [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
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
            times = []
            for _ in range(7):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(2**24)
                start.record()
                for _ in range(20):
                    launch()
                end.record()
                end.synchronize()
                times.append(1e3 * start.elapsed_time(end) / 20)
            print(f"{name} {kind}: {statistics.median(times)!r} us "
                  f"(min {min(times)!r}); max |diff| / max|kernel| "
                  f"{rel:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
