"""Time variants of the causal flash-attention kernel (kernel 8) on one GPU.

    python3 scripts/flash_attn_variants.py [--only NAME,NAME] [--shape B,Hq,Hkv,S,D]
    python3 scripts/flash_attn_variants.py --parent OLD.cu

Builds `src/repro_torch/kernels/csrc/flash_attn.cu` and variants of it,
each made by replacing some lines of the source (one `nvcc` per variant
through `kernels.build.start_nvcc`, all started together, into
`build/flash_attn_variants/`; each line must occur once in the source,
except the `tf32::split(` calls, which `no_split` and `cvt_rna` replace
at all their occurrences, and the products and the score loop's unroll,
which the variants change in the long and short instances alike; anything
else stops the script), and times each at the serving shape of
granite-8b, (B, Hq, Hkv, S, D) = (1, 32, 8, 2048, 128), or at `--shape`
(the coded-head probe's is 768,32,8,32,128):

  * kernel      — the source as it is;
  * plain_tf32  — one TF32 product per float32 product (big.big) in both
                  products: what the second and third products and the
                  splits of the small parts cost;
  * scores_only — no P.V products: what the output product costs;
  * no_exp      — the probabilities without expf: what the exponentials
                  cost;
  * no_split    — every operand passed to the tensor cores as its float32
                  bits, big and small alike (wrong results): what the
                  splits cost;
  * no_softmax  — the mask, running max, exponentials and rescaling
                  skipped (the scores go to P.V as they are): what the
                  online softmax costs;
  * unroll4     — the score product's loop over D unrolled by 4;
  * keys32      — 32-key K/V tiles (the shared tiles shrink to 69 KB);
  * keys32_3cta — 32-key tiles at three CTAs an SM (at most 170
                  registers a thread);
  * runtime_nd  — D's column-tile count read at run time at D = 128 and
                  64 too (the instance other head sizes take);
  * narrow_2cta — the D = 64 instance planned for two CTAs an SM, as
                  D = 128's (at most 255 registers a thread);
  * narrow_4cta — the D = 64 instance planned for four CTAs an SM (at
                  most 128 registers a thread);
  * no_short    — no short-sequence instance: S <= 64 takes the D = 128
                  or D = 64 instance (its difference from the kernel must
                  be 0);
  * cvt_rna     — the splits by `cvt.rna.tf32.f32` instead of the integer
                  rounding of `tf32::rna` (the same results for finite
                  values: its difference from the kernel must be 0).

and prints the opcode histogram of the kernel's D = 128 instance
(`cuobjdump -sass`).

Time: CUDA events around 20 back-to-back launches on the same operands
(warm in L2), queued behind a sleep kernel, median of 7 runs
(`kernel_variants.py`).  Prints
each variant's registers (ptxas), its time, and its largest difference
from the unmodified kernel.

With `--parent OLD.cu` (an earlier `csrc/flash_attn.cu`, e.g. the
parent commit's unpacked into a git-ignored directory: `git show
HEAD~1:src/repro_torch/kernels/csrc/flash_attn.cu >
build/parent/flash_attn.cu`), the variants are skipped: OLD.cu and the
current source are built side by side and compared at zamba2-1.2b's
(1, 32, 32, 2048, 64), whisper-tiny's (1, 6, 6, 440, 64) and granite-8b's
(1, 32, 8, 2048, 128) prefill shapes, granite's 100- and 1537-token
prompts, one and three query heads a key/value head, and short sequences
(the coded-head probe's (768, 32, 8, 32, 128), S = 64, D = 64, one and
twelve query heads a key/value head): the current result `torch.equal` to
the earlier one's (the script fails otherwise), both within the float64
bound of `kernels.flash_attn.ref.float64_reference_and_bound`, cold
times (operands rotated over copies larger than twice the L2) in the
order earlier, current, current, earlier, the library call of
`chip_smoke.py` (`repeat_interleave` where heads are grouped, then
`scaled_dot_product_attention(is_causal=True)`) and the bound of
`repro_torch.roofline.kernel_terms`.

Beside them, the rate of the instruction the kernel is built on: a kernel
whose warps issue nothing but `mma.sync.aligned.m16n8k8` TF32 products
(`tf32::mma` of `csrc/mma_tf32.cuh`) into `chains` independent
accumulators, 1, 2 or 4 CTAs of 256 threads per SM on 132 SMs, in
TFLOP/s (2048 flops a product).  Needs a CUDA card (sm_90a) and `nvcc`.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from kernel_variants import (build_variants, library_function,  # noqa: E402
                             median_ms, opcode_histogram, print_card)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402

OUT = ROOT / "build" / "flash_attn_variants"
SCORE_MMA = "tf32::mma3(s[j], a_big, a_small, b_big, b_small);"
OUT_MMA = "tf32::mma3(acc[j], a_big, a_small, b_big, b_small);"
PROB = "s[j][e] = expf(s[j][e] - m[e >> 1]);"
SPLIT = "tf32::split("
KK_UNROLL = "#pragma unroll 2\n"
BK = "constexpr int kBk = 64; "
INSTANCE = "const int inst = instance(D, vec, S);"
NARROW_BOUNDS = ("__launch_bounds__(kThreads, kNd == kNarrowNd ? 3 : 2)\n"
                 "flash_attn_kernel(")
BOUNDS = NARROW_BOUNDS
SHORT_RULE = ("  if (S <= kShortMaxS) return (nd == kMaxNd ? 3 : 5) + "
              "(S > 32 ? 1 : 0);\n")
SOFTMAX_FIRST = "      const bool masked = t0 + kBk - 1 > r0 || t0 + kBk > S;\n"
SOFTMAX_LAST = ("        for (int e = 0; e < 4; ++e) acc[j][e] *= "
                "alpha[e >> 1];\n")
INCLUDE = '#include "mma_tf32.cuh"\n'
VARIANTS = {
    "kernel": {},
    "plain_tf32": {SCORE_MMA: "tf32::mma(s[j], a_big, b_big);",
                   OUT_MMA: "tf32::mma(acc[j], a_big, b_big);"},
    "scores_only": {OUT_MMA: ""},
    "no_exp": {PROB: "s[j][e] = s[j][e] - m[e >> 1];"},
    "no_split": {SPLIT: "bits_as_split(",
                 INCLUDE: INCLUDE + "__device__ __forceinline__ void "
                          "bits_as_split(float x, uint32_t& big, uint32_t& "
                          "small) { big = small = __float_as_uint(x); }\n"},
    "no_softmax": {SOFTMAX_FIRST: "#if 0\n" + SOFTMAX_FIRST,
                   SOFTMAX_LAST: SOFTMAX_LAST + "#endif\n"},
    "unroll4": {KK_UNROLL: "#pragma unroll 4\n"},
    "keys32": {BK: "constexpr int kBk = 32; "},
    "keys32_3cta": {BK: "constexpr int kBk = 32; ",
                    BOUNDS: BOUNDS.replace("kNd == kNarrowNd ? 3 : 2", "3")},
    "runtime_nd": {INSTANCE: "const int inst = 0;"},
    "narrow_2cta": {NARROW_BOUNDS: NARROW_BOUNDS.replace("? 3 : 2", "? 2 : 2")},
    "narrow_4cta": {NARROW_BOUNDS: NARROW_BOUNDS.replace("? 3", "? 4")},
    "no_short": {SHORT_RULE: ""},
    "cvt_rna": {SPLIT: "cvt_split(",
                INCLUDE: INCLUDE + r"""
__device__ __forceinline__ uint32_t cvt_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void cvt_split(float x, uint32_t& big,
                                          uint32_t& small) {
  big = cvt_rna(x);
  small = cvt_rna(x - __uint_as_float(big));
}
"""},
}
SHAPE = (1, 32, 8, 2048, 128)
RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include "mma_tf32.cuh"

template <int kChains>
__global__ void mma_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = tf32::rna(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = tf32::rna(1e-3f * (threadIdx.x - i));
  float c[kChains][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < kChains; ++j) tf32::mma(c[j], a, b);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_rate_launch(float* out, int blocks, int chains, int iters,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chains == 4) mma_rate<4><<<blocks, 256, 0, st>>>(out, iters);
  else mma_rate<8><<<blocks, 256, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_rates(stream) -> None:
    """Print the TF32 mma.sync rate at 1, 2 and 4 CTAs an SM."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "mma_rate.cu", OUT / "libmma_rate.so"
    src.write_text(RATE_SOURCE)
    log, _ = (proc := build.start_nvcc(src, lib)).communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"mma_rate failed to build:\n{log}")
    fn = ctypes.CDLL(str(lib)).mma_rate_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    iters = 4096
    for per_sm in (1, 2, 4):
        blocks = 132 * per_sm
        out = torch.empty(blocks * 256, device="cuda")
        for chains in (4, 8):
            def launch():
                if fn(out.data_ptr(), blocks, chains, iters, stream) != 0:
                    raise RuntimeError("mma_rate launch failed")
            launch()
            ms, _ = median_ms(launch, calls=5)
            flops = blocks * 8 * iters * chains * 2048
            print(f"mma.sync m16n8k8 tf32: {per_sm} CTA(s) of 8 warps an SM, "
                  f"{chains} accumulators a warp: {flops / ms / 1e9!r} "
                  f"TFLOP/s", flush=True)


PARENT_SHAPES = {"zamba2-1.2b": (1, 32, 32, 2048, 64),
                 "whisper-tiny": (1, 6, 6, 440, 64),
                 "granite-8b": (1, 32, 8, 2048, 128),
                 "100-token prompt": (1, 32, 8, 100, 128),
                 "1537-token prompt": (1, 32, 8, 1537, 128),
                 "R = 1": (1, 8, 8, 300, 128),
                 "R = 3": (1, 12, 4, 257, 128),
                 "probe": (768, 32, 8, 32, 128),
                 "probe, R = 1": (768, 32, 32, 32, 128),
                 "S = 64": (192, 32, 8, 64, 128),
                 "S = 64, R = 1": (192, 32, 32, 64, 128),
                 "D = 64, S = 32": (768, 32, 8, 32, 64),
                 "D = 64, S = 45, R = 12": (64, 12, 1, 45, 64)}
L2_BYTES = 50 * 2**20


def parent_report(parent: Path) -> bool:
    """The current source against `parent` at PARENT_SHAPES (see the
    module docstring); True when every result is equal and bounded."""
    from repro_torch.kernels.flash_attn import ref
    from repro_torch.roofline import kernel_terms

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in (("parent", parent),
                      ("current", build.CSRC / "flash_attn.cu")):
        lib = OUT / f"lib{name}_pair.so"
        procs[name] = (build.start_nvcc(src, lib), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        fns[name] = library_function(lib, "flash_attn_launch",
                                     ops._SIGNATURES)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(30)
    ok = True
    for label, (B, Hq, Hkv, S, D) in PARENT_SHAPES.items():
        q, k, v = (torch.randn((B, h, S, D), generator=gen, device=dev)
                   for h in (Hq, Hkv, Hkv))

        def call(name, q, k, v):
            out = torch.empty_like(q)
            strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
            if fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, Hq, Hkv, S, D, *strides,
                         ops.scale(D), stream, None) != 0:
                raise RuntimeError(f"{name} launch failed")
            return out

        def library(q, k, v):
            rep = Hq // Hkv
            if rep > 1:
                k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True)

        old, new = call("parent", q, k, v), call("current", q, k, v)
        o64, bound = ref.float64_reference_and_bound(q, k, v)
        torch.cuda.synchronize()
        share = {}
        for n, o in (("earlier", old), ("current", new)):
            err = (o.double() - o64).abs()  # 0 / 0 (an exact 0) counts 0
            share[n] = float(torch.where(bound > 0, err / bound,
                                         torch.where(err > 0, torch.inf,
                                                     0.0)).max())
        lib_err = float((library(q, k, v) - new).abs().max())
        equal = torch.equal(old, new)
        ok &= equal and max(share.values()) <= 1.0
        del o64, bound
        n = -(-2 * L2_BYTES // (4 * (q.numel() + 2 * k.numel()))) + 1
        copies = [(q.clone(), k.clone(), v.clone()) for _ in range(n)]
        cyc = itertools.cycle(copies)
        times = [median_ms(lambda: call(name, *next(cyc)))[0]
                 for name in ("parent", "current", "current", "parent")]
        lib_ms = median_ms(lambda: library(*next(cyc)), calls=4)[0]
        terms = kernel_terms("causal_attention", (B, Hq, Hkv, S, D))
        print(f"{label} (B, Hq, Hkv, S, D) = {(B, Hq, Hkv, S, D)}: instance "
              f"{ops.instance(D, s=S)}; torch.equal to the earlier build "
              f"{equal}; "
              f"float64-bound share earlier {share['earlier']:.4f}, current "
              f"{share['current']:.4f}; cold us earlier, current, current, "
              f"earlier " + ", ".join(f"{1e3 * t:.3f}" for t in times)
              + f"; library {1e3 * lib_ms!r} us (max |library - kernel| "
              f"{lib_err:.3e}); bound {1e6 * terms['bound_s']!r} us "
              f"({terms['bound_by']})", flush=True)
        del copies, cyc
    return ok


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default=",".join(VARIANTS))
    parser.add_argument("--shape", default=",".join(map(str, SHAPE)),
                        help="B,Hq,Hkv,S,D of the timed operands")
    parser.add_argument("--parent", type=Path, default=None)
    args = parser.parse_args()
    names = args.only.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print_card()
    if args.parent is not None:
        ok = parent_report(args.parent)
        print(f"flash_attn parent comparison ok {ok}", flush=True)
        return 0 if ok else 1
    libs = {}
    built = build_variants("flash_attn", {n: VARIANTS[n] for n in names}, OUT,
                           every=frozenset({SPLIT, SCORE_MMA, OUT_MMA,
                                            KK_UNROLL}))
    for name, (lib, log) in built.items():
        regs = re.findall(r"entry function '\w*?\d+([a-z_]+_kernel)"
                          r"I((?:L[a-z]\d+E)+)E.*?Used (\d+) registers", log,
                          re.S)
        print(f"{name}: registers " + ", ".join(
            f"{fn}<{args}> {n}" for fn, args, n in regs), flush=True)
        libs[name] = lib
    if "kernel" in libs:
        for label, mangled in (("D = 128", "flash_attn_kernelILb1ELi16E"),
                               ("short, D = 128, 32 keys",
                                "short_attn_kernelILi16ELi4E")):
            print(f"SASS of the {label} instance: " + opcode_histogram(
                libs["kernel"], mangled), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, Hq, Hkv, S, D = map(int, args.shape.split(","))
    q, k, v = (torch.randn((B, h, S, D), generator=gen, device=dev)
               for h in (Hq, Hkv, Hkv))
    strides = [st for t in (q, k, v, q) for st in t.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    base = None
    for name, path in libs.items():
        fn = library_function(path, "flash_attn_launch", ops._SIGNATURES)
        out = torch.empty_like(q)

        def launch():
            if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Hq, Hkv, S, D, *strides, ops.scale(D), stream,
                  None) != 0:
                raise RuntimeError(f"{name} launch failed")

        launch()
        torch.cuda.synchronize()
        if base is None:
            base = out.clone()
        diff = float((out - base).abs().max())
        ms, low = median_ms(launch)
        print(f"{name}: {ms!r} ms (min {low!r}); max |diff| from the first "
              f"{diff:.3e}", flush=True)
    mma_rates(stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
