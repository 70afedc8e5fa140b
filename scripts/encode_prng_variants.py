"""Time variants of the in-kernel-generator encode kernel (kernel 3) on
one GPU.

    python3 scripts/encode_prng_variants.py [--only NAME,NAME]

Builds `src/repro_torch/kernels/csrc/encode.cu` and variants of its
`encode_prng_kernel`, each made by replacing text of the source, through
`kernel_variants.build_variants` (one `nvcc` per variant, all started
together, into `build/encode_prng_variants/`; each replaced text must
occur once in the source, or, for `no_split` and `no_remote`, at least
once, else the script stops), and times each at the fleet path's
shape, (C, L, D) = (2016, 300, 501), for both generator kinds:

  * kernel      — the source as it is: pairs of 32 x 256 CTAs along D,
                  each hashing one m16 tile of the pair's generator rows
                  into both (8 hash warps, up to 3 steps ahead on
                  mbarriers), 8 product warps of 3xTF32 mma.sync, X by
                  one multicast bulk copy of whole rows per CTA a step;
  * rings       — X through the product warps' rings by 4-byte cp.async
                  (the instance taken for misaligned X or D > 512);
  * no_hash     — G entries made from their index, no threefry and no
                  erfinv: what the hash costs;
  * hash4       — 4 hash warps (4 entries a thread) instead of 8;
  * mma4        — 4 product warps of 64 columns (8 n8 tiles) instead of
                  8 of 32: half the A fragment reads;
  * no_a_loads  — the A fragments made from their index, not read from
                  shared memory (wrong results): what reading them costs;

  * no_x_loads  — no copies of X (the products on whatever the buffers
                  hold): what loading X costs;
  * no_remote   — no stores of the A fragments into the partner, and
                  none expected (wrong results): what the distributed
                  shared memory costs;
  * no_split    — X's words taken as they are, no TF32 split (wrong
                  results): what splitting X costs;
  * no_mma      — each m16n8k8 product replaced by one integer
                  operation on its operands (wrong results): the copies,
                  splits and hashes alone;
  * fma         — each m16n8k8 product replaced by the 32 float32 FMAs a
                  lane issues for it on the FMA pipes (one product, not
                  three; the lanes' operand exchange not counted; wrong
                  results): what the tensor cores save;
  * plain_tf32  — one TF32 product per float32 product (big.big; its
                  results miss the float64 bound);
  * bufs2       — two buffers on the ring (the hash one step ahead);
  * empty       — no step (the barriers' set-up, the pair's two
                  meetings and the output store);
  * launch_only — every CTA returns at once;

and prints the SASS opcode histogram of the normal instance.

Time: `kernel_variants.median_ms`, CUDA events around 20 back-to-back
launches on the same operands (warm in L2), queued behind a sleep
kernel, median of 7 runs; the library call `G @ (w X)` on a materialized
G (no generation; w X formed outside the span) beside them.  Prints each
variant's registers and spill bytes (ptxas), its time, its largest
difference from the unmodified kernel relative to max|kernel| and its
worst share of the float64 bound of
`kernels.encode.ops.float64_reference_and_bound`.  Needs a CUDA card
(sm_90a) and `nvcc`.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from encode_variants import ptxas_lines  # noqa: E402
from kernel_variants import (build_variants, library_function,  # noqa: E402
                             median_ms, opcode_histogram, print_card)
from repro_torch.kernels.encode import ops, prng  # noqa: E402

OUT = ROOT / "build" / "encode_prng_variants"
BITS = """bits[e] = bits_at(k0, k1,
                      static_cast<uint32_t>(r) * static_cast<uint32_t>(l) +
                          static_cast<uint32_t>(kk),
                      size);"""
GENERATOR = "bits_to_generator<kKind>(bits[e])"
HASH_WARPS = "constexpr int kHashWarps = kBulk ? 8 : 4;"
MMA_WARPS = "constexpr int kMmaWarps = 8;"
A_BIG = "const uint4 ab = *reinterpret_cast<const uint4*>(a_step + fa);"
A_SMALL = """const uint4 as =
            *reinterpret_cast<const uint4*>(a_step + fa + kAWords);"""
COPY = """cp_async<1>(stage + (r0 + r) * kXStride + lane + 32 * h,
                  in ? x + static_cast<int64_t>(k0 + r) * d + n + 32 * h
                     : x, in);"""
SPLIT_X = "tf32::split(xv["
SMALL_BIG = "tf32::mma(acc[mt][nt], fa_small[mt], fb_big[nt]);"
BIG_SMALL = "tf32::mma(acc[mt][nt], fa_big[mt], fb_small[nt]);"
BIG_BIG = "tf32::mma(acc[mt][nt], fa_big[mt], fb_big[nt]);"
FMA = """{
#pragma unroll
          for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] = fmaf(__uint_as_float(fa_big[mt][(k + e) & 3]),
                                    __uint_as_float(fb_big[nt][k & 1]),
                                    acc[mt][nt][e]);
        }"""
REMOTE = ("    st_async(remote + 4u * at, vb, remote_full);\n"
          "    st_async(remote + 4u * (at + kAWords), vs, remote_full);\n")
A_TX = "uint32_t bytes = 4u * 2 * kAWords;"
# both roles see no step, so every thread still meets every barrier
STEPS = "const int n_steps = (l + kBL - 1) / kBL;"
ENTRY = ("  extern __shared__ __align__(16) float smem[];\n"
         "  // buffer b:")
BUFS = "constexpr int kBufs = kBulk ? 3 : 4;"
HALF = ("return max(0, min(kBL / 2, l - kBL * q - (kBL / 2) * h)) * d;")
BULK = "return d <= kBulkMaxD && aligned16(x)"
VARIANTS = {
    "kernel": {},
    "no_hash": {BITS: "bits[e] = static_cast<uint32_t>(r) * 7919u + "
                      "static_cast<uint32_t>(kk);",
                GENERATOR: "(1.0f + 1e-6f * static_cast<float>(bits[e]))"},
    "hash4": {HASH_WARPS: "constexpr int kHashWarps = 4;"},
    "mma4": {MMA_WARPS: "constexpr int kMmaWarps = 4;"},
    "no_a_loads": {A_BIG: "const uint4 ab = make_uint4(fa, fa, fa, fa);",
                   A_SMALL: "const uint4 as = make_uint4(fa, fa, fa, fa);"},
    # no bulk copy (nothing expected on the barriers) and no ring copy
    "no_x_loads": {HALF: "return 0 * d;", COPY: "(void)in;"},
    "rings": {BULK: "return false"},
    # the partner's A bytes no longer expected either, so nothing hangs
    "no_remote": {REMOTE: "", A_TX: "uint32_t bytes = 0u;"},
    # the split's rounding taken out: the raw word as big, zero as small
    "no_split": {SPLIT_X: "split_raw(xv["},
    "no_mma": {SMALL_BIG: "acc[mt][nt][0] = __uint_as_float(__float_as_uint("
                          "acc[mt][nt][0]) ^ fa_small[mt][0] ^ "
                          "fb_big[nt][0]);",
               BIG_SMALL: "acc[mt][nt][1] = __uint_as_float(__float_as_uint("
                          "acc[mt][nt][1]) ^ fa_big[mt][1] ^ "
                          "fb_small[nt][1]);",
               BIG_BIG: "acc[mt][nt][2] = __uint_as_float(__float_as_uint("
                        "acc[mt][nt][2]) ^ fa_big[mt][2] ^ fb_big[nt][1]);"},
    "fma": {SMALL_BIG: ";", BIG_SMALL: ";", BIG_BIG: FMA},
    "plain_tf32": {SMALL_BIG: ";", BIG_SMALL: ";"},
    "bufs2": {BUFS: "constexpr int kBufs = 2;"},
    "empty": {STEPS: "const int n_steps = 0 * ((l + kBL - 1) / kBL);"},
    "launch_only": {ENTRY: "  if (c > 0) return;\n" + ENTRY},
}
SPLIT_RAW = """
__device__ __forceinline__ void split_raw(float v, uint32_t& big,
                                          uint32_t& small) {
  big = __float_as_uint(v);
  small = 0u;
}
"""
NAMESPACE = "namespace prng {\n"
VARIANTS["no_split"][NAMESPACE] = NAMESPACE + SPLIT_RAW
C, L, D = 2016, 300, 501


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default=",".join(VARIANTS))
    names = parser.parse_args().only.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print_card()
    built = build_variants("encode", {n: VARIANTS[n] for n in names}, OUT,
                           every=frozenset({SPLIT_X, REMOTE}))
    for name, (_, log) in built.items():
        print(f"{name}: (registers, spill store bytes) of the "
              f"encode_prng_kernel instances (normal, Rademacher) "
              f"{ptxas_lines(log, 'encode_prng_kernel')}", flush=True)
    if "kernel" in built:
        print("SASS of encode_prng_kernel<normal>: " + opcode_histogram(
            built["kernel"][0], "encode_prng_kernelILi0E"), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.rand(L, generator=gen, device=dev)
    x = torch.randn((L, D), generator=gen, device=dev)
    key = prng.split_keys(prng.prng_key(1), 24)[0]
    k0, k1 = prng.key_words(key)
    stream = torch.cuda.current_stream().cuda_stream
    exact = {}
    for kind in prng.KINDS:
        g = prng.generator_values(key, C, L, kind, device=dev)
        exact[kind] = ops.float64_reference_and_bound(g, w, x)
        wx = (w[:, None] * x).contiguous()
        ms, low = median_ms(lambda: torch.matmul(g, wx))
        print(f"library G @ (w X) on a materialized {kind} G: {1e3 * ms!r} "
              f"us (min {1e3 * low!r})", flush=True)
        del g, wx
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
            p64, bound = exact[kind]
            share = float(((out.double() - p64).abs() / bound).max())
            ms, low = median_ms(launch)
            print(f"{name} {kind}: {1e3 * ms!r} us (min {1e3 * low!r}); "
                  f"max |diff| / max|kernel| {rel:.3e}; worst share of "
                  f"the float64 bound {share:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
