"""Time variants of the parity-encode kernel (kernel 2) on one GPU.

    python3 scripts/encode_variants.py [--only NAME,NAME]

Builds `src/repro_torch/kernels/csrc/encode.cu` and variants of its
`encode_kernel`, each made by replacing lines of the source, through
`kernel_variants.build_variants` (one `nvcc` per variant, all started
together, into `build/encode_variants/`; each replaced line must occur
once in the source, or the script stops), and times each at the coded
path's shape, (C, L, D) = (2016, 300, 501):

  * kernel      — the source as it is: 128 x 64 tiles, 8 warps of 32 x 32,
                  steps of 32 along L, three raw stages;
  * tile64      — 64 x 64 tiles, 4 warps of 32 x 32 (256 CTAs);
  * tile64_s2   — the same with two raw stages: two CTAs an SM;
  * warps4      — 128 x 64 tiles, 4 warps of 64 x 32;
  * step16      — steps of 16 along L;
  * stages2     — two raw stages;
  * stages4     — four raw stages;
  * plain_tf32  — one TF32 product per float32 product (big.big): what
                  the second and third products cost (its results miss
                  the float64 bound);
  * no_mma      — the copies and the splits alone, no products (wrong
                  results): what the staging costs;
  * no_copy     — no copies (the splits and products run on whatever the
                  raw stages hold): what the copies cost;
  * no_split    — no splits after the first step: what the splits cost;
  * wait_all    — each step waits for every copy in flight;
  * g_scalar    — G by 4-byte copies too;
  * empty       — no step at all: the launch, the first split and the
                  store of zeros;
  * launch_only — every CTA returns at once;

each also at D = 500, where X takes 16-byte copies, and prints the
SASS opcode histogram of the instance the coded path takes (16-byte
copies of G, 4-byte of X).

Time: `kernel_variants.median_ms`, CUDA events around 20 back-to-back
launches on the same operands (warm in L2), queued behind a sleep
kernel, median of 7 runs; the library call `G @ (w X)` (w X formed
outside the span) beside them.  Prints each variant's registers and
spill bytes (ptxas), its time, its largest difference from the
unmodified kernel and its worst share of the float64 bound of
`kernels.encode.ops.float64_reference_and_bound`.  Needs a CUDA card
(sm_90a) and `nvcc`.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from kernel_variants import (build_variants, library_function,  # noqa: E402
                             median_ms, opcode_histogram, print_card)
from repro_torch.kernels.encode import ops  # noqa: E402

OUT = ROOT / "build" / "encode_variants"
BM = "constexpr int kBM = 128;"
BK = "constexpr int kBK = 32;"
WARPS = "constexpr int kWarpsM = 4, kWarpsN = 2;"
STAGES = "constexpr int kStages = 3;"
MMA3 = ("tf32::mma3(acc[mt][nt], fa_big[mt], fa_small[mt], fb_big[nt],\n"
        "                   fb_small[nt]);")
MMA_STEP = "mma_step(split + (s & 1) * kSplitWords, acc, s * kBK, l, wm, wn);"
COPY_G = "copy_tile<kVecG ? 4 : 1, kBM, kBK>(raw, g, c, l, row0, k0);"
COPY_X = "copy_tile<kVecX ? 4 : 1, kBK, kBN>(raw + kBM * kBK, x, l, d, k0, col0);"
SPLIT = "if (s + 1 < n_steps)  // the next step, into the other split buffer"
STEPS = "const int n_steps = (l + kBK - 1) / kBK;"
WAIT = "cp_async_wait<kStages - 2>();"
VARIANTS = {
    "kernel": {},
    "tile64": {BM: "constexpr int kBM = 64;",
               WARPS: "constexpr int kWarpsM = 2, kWarpsN = 2;"},
    "tile64_s2": {BM: "constexpr int kBM = 64;",
                  WARPS: "constexpr int kWarpsM = 2, kWarpsN = 2;",
                  STAGES: "constexpr int kStages = 2;"},
    "warps4": {WARPS: "constexpr int kWarpsM = 2, kWarpsN = 2;"},
    "step16": {BK: "constexpr int kBK = 16;"},
    "stages2": {STAGES: "constexpr int kStages = 2;"},
    "stages4": {STAGES: "constexpr int kStages = 4;"},
    "plain_tf32": {MMA3: "tf32::mma(acc[mt][nt], fa_big[mt], fb_big[nt]);"},
    "no_mma": {MMA_STEP: ""},
    "no_copy": {COPY_G: "", COPY_X: ""},
    "no_split": {SPLIT: "if (false)"},
    "wait_all": {WAIT: "cp_async_wait<0>();"},
    "g_scalar": {COPY_G: COPY_G.replace("kVecG ? 4 : 1", "1")},
    "empty": {STEPS: "const int n_steps = 0;"},
    "launch_only": {STEPS: "if (l > 0) return;\n  " + STEPS},
}
C, L, D = 2016, 300, 501


def ptxas_lines(log: str, kernel: str) -> list[tuple[int, int]]:
    """(registers, spill store bytes) of each instance of `kernel` in an
    `-Xptxas=-v` log."""
    out = []
    for entry in log.split("Compiling entry function")[1:]:
        name = entry.split("'")[1]
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        if re.search(rf"\d{kernel}I", name) and regs and spill:
            out.append((int(regs[1]), int(spill[1])))
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default=",".join(VARIANTS))
    names = parser.parse_args().only.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print_card()
    built = build_variants("encode", {n: VARIANTS[n] for n in names}, OUT)
    for name, (_, log) in built.items():
        print(f"{name}: (registers, spill store bytes) of the encode_kernel "
              f"instances {ptxas_lines(log, 'encode_kernel')}", flush=True)
    if "kernel" in built:
        print("SASS of encode_kernel<true, false>: " + opcode_histogram(
            built["kernel"][0], "encode_kernelILb1ELb0E"), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((C, L), generator=gen, device=dev)
    w = torch.rand((L,), generator=gen, device=dev)
    x = torch.randn((L, D), generator=gen, device=dev)
    p64, bound = ops.float64_reference_and_bound(g, w, x)
    x500 = x[:, :500].contiguous()  # 16-byte rows
    stream = torch.cuda.current_stream().cuda_stream
    base = None
    for name, (path, _) in built.items():
        fn = library_function(path, "enc_encode_parity", ops._SIGNATURES)
        out = torch.empty((C, D), device=dev)

        def launch():
            if fn(g.data_ptr(), w.data_ptr(), x.data_ptr(), out.data_ptr(),
                  C, L, D, stream) != 0:
                raise RuntimeError(f"{name} launch failed")

        launch()
        torch.cuda.synchronize()
        if base is None:
            base = out.clone()
        diff = float((out - base).abs().max())
        share = float(((out.double() - p64).abs() / bound).max())
        ms, low = median_ms(launch)
        out500 = torch.empty((C, 500), device=dev)
        ms500, _ = median_ms(lambda: fn(g.data_ptr(), w.data_ptr(),
                                        x500.data_ptr(), out500.data_ptr(),
                                        C, L, 500, stream))
        print(f"{name}: {ms!r} ms (min {low!r}; at D = 500 {ms500!r} ms); "
              f"max |diff| from the first {diff:.3e}; worst share of the "
              f"float64 bound {share:.4f}", flush=True)
    wx = w[:, None] * x
    ms, low = median_ms(lambda: torch.matmul(g, wx))
    print(f"library G @ (w X): {ms!r} ms (min {low!r})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
