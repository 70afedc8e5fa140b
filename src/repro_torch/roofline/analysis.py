"""Roofline terms of the port's kernels and the LM zoo's model FLOPs.

The counterpart of `repro/roofline/analysis.py`.  The reference reads
FLOPs and bytes off a compiled XLA module (`roofline_terms(hlo_text)`);
the port has no HLO, so `kernel_terms(family, shape, block)` counts them
from each hand-written kernel's shape instead:

    t_compute    = the operations of the kernel's route / the card's peak
                   rate for their type (the slowest pipe when there are two)
    t_memory     = bytes / HBM bandwidth
    t_collective = 0 (every kernel runs on one card)

Without a `block` the count is the least work of the function: each
input read once, each output written once, and the operations the
kernel's route must issue for these inputs.  With a `block` (a tile the
kernel launches with, as `repro_torch.tune` enumerates them) it is what
that tile grid issues: the tensor-core products of every padded tile
(the `mma.sync` loops carry no guards, so a 128-row tile at c = 359
computes 384 rows), and the float64 partials that a row tile's CTAs
write and the in-launch reduce reads back.  So the bound depends on the
tile, as the reference's does through its grid steps.

`active_params`, `model_flops` and `dominant_term` are the reference's,
over the port's `configs.base`.
"""
from __future__ import annotations

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig

# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth, the float32 rate
# outside the tensor cores, the dense TF32 tensor-core rate (the 3xTF32
# products of kernels 2, 3, 7 and 8 run three TF32 products per float32
# product), and the INT32 rate: 64 integer lanes an SM, 132 SMs, 1.98 GHz
# boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations of one threefry2x32 hash with its counter pairing
# (20 rounds of add, funnel shift and xor, five key injections)
HASH_INT_OPS = 80
# 3xTF32: each float32 product is three TF32 tensor-core products
TF32_PRODUCTS = 3

# kernel 2's mma.sync steps along L and the round-gradient CTAs' column
# chunk (csrc/encode.cu, round_grad.cu)
MMA_K = 8
RG_CHUNK_COLS = 512
RG_MAX_TIERS = 4

FAMILIES = ("round_grad", "coded_round_grad", "tier_round_grad",
            "coded_grad", "encode", "encode_prng", "ssd_chunk",
            "causal_attention")


def _ceil_to(v: int, step: int) -> int:
    return -(-v // step) * step


def _terms(flops: float, nbytes: float, route: str,
           pipes: dict[str, float]) -> dict:
    """The terms from `flops` (float32-equivalent), `nbytes` and the
    route's seconds on each pipe it uses (`pipes`)."""
    t_compute = max(pipes.values())
    t_memory = nbytes / HBM_BYTES_PER_S
    return {"flops": float(flops), "bytes": float(nbytes),
            "t_compute": t_compute, "t_memory": t_memory,
            "t_collective": 0.0, "pipes": dict(pipes),
            "t_fp32": flops / FP32_FLOPS_PER_S,
            "bound_s": max(t_compute, t_memory),
            "bound_by": "bytes" if t_memory >= t_compute else "operations",
            "route": route}


def _rg_partition(rows: int, block) -> int:
    """CTAs a row tile (block_m,) gives `rows` rows: block_m a CTA, or
    the kernel's own partition (`round_grad.ops.rows_per_cta`) at 0."""
    from repro_torch.kernels.round_grad.ops import rows_per_cta

    rpc = int(block[0]) or rows_per_cta(rows)
    return max(1, -(-rows // rpc))


def _round_grad_terms(rows: int, d: int, n_w: int, n_tiers: int,
                      parts, block, flops: float, nbytes: float) -> dict:
    """A round-gradient kernel's terms: the least work (`flops`,
    `nbytes`) or, with a row tile, what its grid issues.  Each CTA
    forms its rows' whole residual (2 D flops a row) for each of its
    ceil(D / 512) column chunks, adds coef * x into the sums of every
    tier of its instance (1, or 4 beside more than one tier) over all 512
    columns of its chunk, and writes a float64 partial of its columns
    that the reduce reads back; a launch sums four tiers at most, each
    launch reading X again.  `parts` are the row blocks' lengths."""
    route = ("float64 sums on the FMA pipes, counted as float32 FMA work "
             "at 67 TFLOP/s")
    if block is not None:
        chunks = -(-d // RG_CHUNK_COLS)
        launches = -(-n_tiers // RG_MAX_TIERS)
        inst = 1 if n_tiers == 1 else RG_MAX_TIERS
        n_ctas = sum(_rg_partition(p, block) for p in parts)
        flops = launches * chunks * (
            rows * (2 * d + 3) + 2 * rows * RG_CHUNK_COLS * inst) \
            + n_tiers * n_ctas * d
        nbytes = 4 * launches * chunks * (rows * (d + n_w)
                                          + n_ctas * d) \
            + 4 * (n_tiers * rows if n_tiers > 1 else 0) \
            + 4 * n_tiers * d + 16 * n_tiers * n_ctas * d
    return _terms(flops, nbytes, route, {"fp32": flops / FP32_FLOPS_PER_S})


def _encode_products(c: int, ell: int, d: int, block) -> float:
    """Float32 products (2 flops each) the encode's tensor cores form:
    C L D, or the padded tile grid's."""
    if block is None:
        return 2.0 * c * ell * d
    bc, bd, _ = (int(b) for b in block)
    return 2.0 * _ceil_to(c, bc) * _ceil_to(ell, MMA_K) * _ceil_to(d, bd)


def kernel_terms(family: str, shape: tuple, block=None, *,
                 weighted: bool = True) -> dict:
    """Roofline terms of one kernel call (seconds and counts).

    family, shape:
      "round_grad"        (m, d)    kernel 1 (`weighted`: w given)
      "coded_round_grad"  (m, c, d) kernel 4, systematic + parity rows
      "tier_round_grad"   (m, d, T) kernel 5
      "coded_grad"        (m, d)    kernel 6
      "encode"            (c, ell, d)  kernel 2
      "encode_prng"       (c, ell, d)  kernel 3
      "ssd_chunk"         (B, nc, Q, H, P, N, G)  kernel 7
      "causal_attention"  (B, Hq, Hkv, S, D)      kernel 8
    block: None for the least work, else the tile ((block_m,) for the
    round gradients, (0,) their own partition; (bc, bd, bl) for kernel
    2; kernels 3, 7 and 8, which launch one tile, take none).

    Returns {"flops" (float32-equivalent), "bytes", "t_compute",
    "t_memory", "t_collective", "pipes" (seconds on each pipe the route
    uses), "t_fp32" (flops on the float32 FMA pipes), "bound_s", "bound_by"
    ("bytes" or "operations"), "route"}.
    """
    shape = tuple(int(s) for s in shape)
    if family == "round_grad":
        m, d = shape
        n_w = 2 if weighted else 1
        return _round_grad_terms(m, d, n_w, 1, (m,), block,
                                 4 * m * d + 3 * m,
                                 4 * (m * d + m * n_w + 2 * d))
    if family == "coded_grad":
        m, d = shape
        return _round_grad_terms(m, d, 1, 1, (m,), block, 4 * m * d + m,
                                 4 * (m * d + m + 2 * d))
    if family == "coded_round_grad":
        m, c, d = shape
        r = m + c
        return _round_grad_terms(r, d, 2, 1, (m, c), block,
                                 4 * r * d + 3 * r,
                                 4 * (r * d + 2 * r + 2 * d))
    if family == "tier_round_grad":
        m, d, nt = shape
        return _round_grad_terms(
            m, d, 2, nt, (m,), block,
            2 * m * d + 2 * nt * m * d + 2 * m + nt * m,
            4 * (m * d + 2 * m + nt * m + d + nt * d))
    if family in ("encode", "encode_prng"):
        c, ell, d = shape
        flops = 2 * c * ell * d + ell * d
        pipes = {}
        if family == "encode":
            nbytes = 4 * (c * ell + ell + ell * d + c * d)
            products = _encode_products(c, ell, d, block)
            route = "3xTF32: three TF32 products per float32 product"
        elif block is not None:
            raise ValueError(f"{family} takes no tile")
        else:  # each generator entry hashed once
            nbytes = 4 * (ell + ell * d + c * d)
            products = 2.0 * c * ell * d
            pipes["int32"] = HASH_INT_OPS * c * ell / INT32_OPS_PER_S
            route = ("the larger of 3xTF32 and one threefry hash per "
                     "generator entry at the INT32 rate")
        pipes["tf32"] = TF32_PRODUCTS * products / TF32_FLOPS_PER_S
        return _terms(flops, nbytes, route, pipes)
    if block is not None:
        raise ValueError(f"{family} takes no tile")
    if family == "ssd_chunk":
        b, nc, q, h, p, n, g = shape
        tri = q * (q + 1) // 2
        # C B^T once per (chunk, group) over its causal half, then per
        # head the causal half of the product with dt x and the state
        flops = b * nc * (g * tri * 2 * n + h * (tri * 2 * p + 2 * q * p * n))
        nbytes = 4 * (b * nc * q * h * (2 * p + 2) + 2 * b * nc * q * g * n
                      + b * nc * h * p * n)
    elif family == "causal_attention":
        b, hq, hkv, s, d = shape
        flops = 4 * b * hq * d * s * (s + 1) // 2
        nbytes = 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    else:
        raise ValueError(f"unknown kernel family {family!r}; known: "
                         f"{FAMILIES}")
    return _terms(flops, nbytes,
                  "3xTF32: three TF32 products per float32 product",
                  {"tf32": TF32_PRODUCTS * flops / TF32_FLOPS_PER_S})


def active_params(cfg: ArchConfig) -> float:
    """Approximate active (per-token) parameter count, excluding embeddings.

    MoE counts top_k experts per MoE layer; the rest is dense."""
    d = cfg.d_model
    hd = cfg.hd if cfg.n_heads else 0
    n_attn = cfg.n_heads * hd
    n_kv = cfg.n_kv_heads * hd
    attn = d * (n_attn + 2 * n_kv) + n_attn * d
    mlp = 3 * d * cfg.d_ff if cfg.act == "swiglu" else 2 * d * cfg.d_ff
    if cfg.arch_type in ("ssm", "hybrid"):
        s = cfg.ssm
        h = s.n_heads(d)
        d_inner = h * s.headdim
        mix = d * (2 * d_inner + 2 * s.n_groups * s.d_state + h) + d_inner * d
        if cfg.arch_type == "ssm":
            return cfg.n_layers * mix
        n_attn_apps = cfg.n_layers // cfg.hybrid.attn_every
        return cfg.n_layers * mix + n_attn_apps * (attn + mlp)
    if cfg.arch_type == "moe":
        n_moe = cfg.n_layers // cfg.moe.every
        n_dense = cfg.n_layers - n_moe
        return cfg.n_layers * attn + n_moe * cfg.moe.top_k * mlp \
            + n_dense * mlp
    if cfg.arch_type == "audio":
        enc = cfg.encdec.n_enc_layers * (attn + mlp)
        dec = cfg.n_layers * (2 * attn + mlp)  # self + cross
        return enc + dec
    # dense, and vlm (cross layers cost about what self layers do)
    return cfg.n_layers * (attn + mlp)


def model_flops(cfg: ArchConfig, shape_name: str) -> float:
    """6 * N_active * tokens for training; 2 * N_active * tokens for
    inference shapes (forward only; one token a sequence in decode)."""
    spec = INPUT_SHAPES[shape_name]
    n_act = active_params(cfg)
    if spec["kind"] == "train":
        return 6.0 * n_act * spec["global_batch"] * spec["seq_len"]
    if spec["kind"] == "prefill":
        return 2.0 * n_act * spec["global_batch"] * spec["seq_len"]
    return 2.0 * n_act * spec["global_batch"]


def dominant_term(terms: dict) -> str:
    vals = {"compute": terms["t_compute"], "memory": terms["t_memory"],
            "collective": terms["t_collective"]}
    return max(vals, key=vals.get)


__all__ = ["FAMILIES", "FP32_FLOPS_PER_S", "HASH_INT_OPS",
           "HBM_BYTES_PER_S", "INT32_OPS_PER_S", "TF32_FLOPS_PER_S",
           "active_params", "dominant_term", "kernel_terms", "model_flops"]
