"""Time variants of the SSD intra-chunk kernel (kernel 7) on one GPU.

    python3 scripts/ssd_variants.py [--only NAME,NAME]

Builds `src/repro_torch/kernels/csrc/ssd.cu` and variants of it, each
made by replacing lines of the source, through
`kernel_variants.build_variants` (one `nvcc` per variant, all started
together, into `build/ssd_variants/`; each replaced text must occur once
in the source, or, for `no_exp` and `no_split`, at least once, else the
script stops),
and times each at the serving shape of mamba2-1.3b, (B, nc, Q, H, P, N,
G) = (1, 8, 256, 64, 64, 128, 1), on the model's own decays:

  * kernel          — the source as it is: y CTAs of 64 query rows and 8
                      heads, C B^T once per CTA; state CTAs of 128 stacked
                      rows; three raw stages;
  * per_head_scores — one head a y CTA: C B^T formed once per head (no
                      reuse);
  * hb4             — four heads a y CTA (C B^T twice as often);
  * fma             — each m16n8k8 product replaced by the 32 float32
                      FMAs a lane issues for it on the FMA pipes (one
                      product, not three; the lanes' operand exchange not
                      counted; wrong results): what the tensor cores save;
  * plain_tf32      — one TF32 product per float32 product (big.big; its
                      results miss the float64 bound);
  * no_state        — the state CTAs return at once: what the state costs;
  * no_y            — the y CTAs return at once: what y and the scores cost;
  * no_scores       — no C B^T products (y on whatever the score tile
                      holds): what forming the scores costs;
  * no_exp          — the decay exp(cum_q - cum_t) replaced by its
                      argument (wrong results): what the expf cost;
  * no_copy         — no copies (every step on whatever the raw stages
                      hold): what the copies cost;
  * stages2         — two raw stages;
  * no_tables       — no prefix sums, dt or decay tables (the steps on
                      whatever the tables hold): what the float64 scans
                      cost;
  * no_sync         — no barrier between steps (races; wrong results):
                      what the CTA's warps waiting on each other costs;
  * no_split        — no split of the staged operands (the products on
                      whatever the split tiles hold);
  * no_mma          — no step's products, score stores or y stores: the
                      copies, splits, tables and barriers alone;
  * empty           — the tables, the first copies and the first split,
                      no step;
  * launch_only     — every CTA returns at once;

and prints the SASS opcode histogram of the 16-byte-copy instance.

Time: `kernel_variants.median_ms`, CUDA events around 20 back-to-back
launches on the same operands (87 MB, more than the 50 MB L2), queued
behind a sleep kernel, median of 7 runs; beside them the two library
expressions of `chip_smoke.py` (`torch.matmul` + `torch.tril` on
head-major views, and with C B^T once per group).  Prints each variant's
registers and spill bytes (ptxas), its time, its largest difference from
the unmodified kernel and its worst share of the float64 bound of
`kernels.ssd.ref.float64_reference_and_bound`.  Needs a CUDA card
(sm_90a) and `nvcc`.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from encode_variants import ptxas_lines  # noqa: E402
from kernel_variants import (build_variants, library_function,  # noqa: E402
                             median_ms, opcode_histogram, print_card)
from repro_torch.kernels.ssd import ops, ref  # noqa: E402

OUT = ROOT / "build" / "ssd_variants"
HB = "constexpr int kHB = 8;"
STAGES = "constexpr int kStages = 3;"
SMALL_BIG = "tf32::mma(c[i][j], a_small[i], b_big[j]);"
BIG_SMALL = "tf32::mma(c[i][j], a_big[i], b_small[j]);"
BIG_BIG = "tf32::mma(c[i][j], a_big[i], b_big[j]);"
FMA = """{
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[i][j][e] = fmaf(__uint_as_float(a_big[i][(k + e) & 3]),
                            __uint_as_float(b_big[j][k & 1]), c[i][j][e]);
    }"""
Y_CTA = "  YCta<kVec> cta(p, smem, bc, qt, r);"
STATE_CTA = "  StateCta<kVec> cta(p, smem, bc, r);"
SCORES = "      score_mma(s, buf);"
COPY = "cp_async<kVec>(dst + r * kCols + c, in ? src + r * ld + c : src, in);"
EXP = "* expf("
ENTRY = "  const int64_t bc = blockIdx.x % p.nbc;"
TABLES = "  role.tables();\n"
SYNC = "    __syncthreads();  // everyone's; split s is in; step s - 1's products"
SPLIT = "role.split("
MMA = "    role.mma(s, split + (s & 1) * kSplit);"
LOOP = "  for (int s = 0; s < n_steps; ++s) {"
RETURN = "  if (p.Q > 0) return;\n"
VARIANTS = {
    "kernel": {},
    "per_head_scores": {HB: "constexpr int kHB = 1;"},
    "hb4": {HB: "constexpr int kHB = 4;"},
    "fma": {SMALL_BIG: ";", BIG_SMALL: ";", BIG_BIG: FMA},
    "plain_tf32": {SMALL_BIG: ";", BIG_SMALL: ";"},
    "no_state": {STATE_CTA: RETURN + STATE_CTA},
    "no_y": {Y_CTA: RETURN + Y_CTA},
    "no_scores": {SCORES: ""},
    "no_exp": {EXP: "* ("},
    "no_copy": {COPY: ""},
    "stages2": {STAGES: "constexpr int kStages = 2;"},
    "no_tables": {TABLES: ""},
    "no_sync": {SYNC: "    // products"},
    "no_split": {SPLIT: "if (false) role.split("},
    "no_mma": {MMA: ""},
    "empty": {LOOP: "  for (int s = 0; s < 0 * n_steps; ++s) {"},
    "launch_only": {ENTRY: RETURN + ENTRY},
}
B, NC, Q, H, P, N, G = 1, 8, 256, 64, 64, 128, 1


def model_operands(dev) -> tuple:
    """The serving shape's operands at the model's own decays (dt =
    softplus(N(0, 1)), a = -linspace(1, 16, H)), from a seeded
    generator."""
    gen = torch.Generator(device=dev).manual_seed(0)
    xc, dtc, _, bc, cc = chip_smoke.ssd_operands(gen, dev, B, NC, Q, H, P,
                                                 N, G)
    da = (dtc * -torch.linspace(1.0, 16.0, H, device=dev)).contiguous()
    return xc, dtc, da, bc, cc


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default=",".join(VARIANTS))
    names = parser.parse_args().only.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print_card()
    built = build_variants("ssd", {n: VARIANTS[n] for n in names}, OUT,
                           every=frozenset({EXP, SPLIT}))
    for name, (_, log) in built.items():
        print(f"{name}: (registers, spill store bytes) of the "
              f"ssd_chunk_kernel instances "
              f"{ptxas_lines(log, 'ssd_chunk_kernel')}", flush=True)
    if "kernel" in built:
        print("SASS of ssd_chunk_kernel<true>: " + opcode_histogram(
            built["kernel"][0], "ssd_chunk_kernelILb1E"), flush=True)
    dev = torch.device("cuda")
    operands = model_operands(dev)
    y64, s64, yb, sb = ref.float64_reference_and_bound(*operands)
    stream = torch.cuda.current_stream().cuda_stream
    base = None
    for name, (path, _) in built.items():
        fn = library_function(path, "ssd_chunk_launch", ops._SIGNATURES)
        y = torch.empty((B, NC, Q, H, P), device=dev)
        s = torch.empty((B, NC, H, P, N), device=dev)

        def launch():
            if fn(*(t.data_ptr() for t in operands), y.data_ptr(),
                  s.data_ptr(), B, NC, Q, H, P, G, N, stream) != 0:
                raise RuntimeError(f"{name} launch failed")

        launch()
        torch.cuda.synchronize()
        if base is None:
            base = (y.clone(), s.clone())
        diff = max(float((y - base[0]).abs().max()),
                   float((s - base[1]).abs().max()))
        share = max(chip_smoke.bound_share(y, y64, yb),
                    chip_smoke.bound_share(s, s64, sb))
        ms, low = median_ms(launch)
        print(f"{name}: {ms!r} ms (min {low!r}); max |diff| from the first "
              f"{diff:.3e}; worst share of the float64 bound {share:.4f}",
              flush=True)
    del y64, s64, yb, sb
    hm = chip_smoke.head_major(operands)
    ms, low = median_ms(lambda: chip_smoke.ssd_library(*hm), calls=4)
    print(f"library matmul + tril on head-major views: {ms!r} ms "
          f"(min {low!r})", flush=True)
    del hm
    gm = chip_smoke.group_major(operands)
    ms, low = median_ms(lambda: chip_smoke.ssd_library_grouped(*gm), calls=4)
    print(f"library with C B^T once per group: {ms!r} ms (min {low!r})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
