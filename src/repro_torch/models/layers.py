"""Transformer building blocks (counterpart of `repro/models/layers.py`):
initialisers, norms, MLPs, rotary embeddings, grouped-query attention for
prefill and for single-token decode against a KV cache (with optional
sliding window), and cross-attention over a memory sequence.

Conventions, as in the reference:
  * params are plain dicts of tensors; `dtype` controls storage and the
    products run in `x.dtype` (the caller casts activations);
  * shapes: tokens (B, S), activations (B, S, D), heads (B, S, H, Dh);
  * GQA: n_heads = n_kv_heads * group, scores by a grouped einsum, so the
    key/value heads are never copied `group`-fold.

Differences from the reference:
  * `self_attention(use_kernel=True)` (the default) sends causal
    attention with no window to `kernels.flash_attn.ops.causal_attention`
    (kernel 8 on the card, its plain version on the CPU);
    `use_kernel=False` and a sliding window keep the grouped expression;
  * `apply_rope` takes cos and sin of the float32 angles in float64 and
    rounds once, so its tables agree with XLA's float32 ones at ~99% of
    the entries where torch's float32 `cos`/`sin` agree at 94-97%;
  * `decode_self_attention` takes `pos` as an int or as a (B,) tensor,
    one absolute position per row, and writes the new K/V into the cache
    in place (the reference returns a new cache);
  * self-attention is always roped.  Non-causal self-attention (the
    audio encoder's) and cross-attention take the plain expression with
    no mask, never kernel 8, which is causal only: as in the reference,
    which reaches no kernel there;
  * the reference's `_seq_shard` (`attn_seq_shard`) has no counterpart:
    it is a `with_sharding_constraint`, a hint to XLA's SPMD partitioner
    that is a no-op off a mesh, and eager PyTorch on one card has no
    partitioner to hint.

The reference's `fused_proj` config field and the settings its dry
run applies (`launch.dryrun.optimize_config`) are the reference's
arithmetic: `fused` packs wk|wv
into `wkv` (and bk|bv into `bkv`) and w_gate|w_up into `w_gu`, split
again after the product; `impl="repeat"` copies each key/value head to
its R query heads and takes (B, H, S, T) scores, the same function as
the grouped one; a bf16 `softmax_dtype` rounds the scores to bf16 before
the mask and takes the softmax in bf16 steps (`softmax_bf16`), the
weights cast back to q's dtype.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn import ops as fa_ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator | None, shape: tuple[int, ...], std: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, std^2) entries from `gen`, drawn in float32 and cast to
    `dtype` (scaled in place: no second float32 copy); on the meta device
    (shape checks) nothing is drawn."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=device)
    return out.mul_(std).to(dtype)


def dense_init(gen: torch.Generator | None, in_dim: int, out_dim: int,
               dtype: torch.dtype, device: torch.device,
               stack: tuple[int, ...] = ()) -> torch.Tensor:
    """(*stack, in_dim, out_dim) weights, N(0, 1) x 1/sqrt(in_dim)."""
    return normal(gen, (*stack, in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                  dtype, device)


def init_norm(d: int, dtype: torch.dtype, device: torch.device,
              stack: tuple[int, ...] = ()) -> dict:
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=device)}


def init_ln(d: int, dtype: torch.dtype, device: torch.device,
            stack: tuple[int, ...] = ()) -> dict:
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=device),
            "bias": torch.zeros((*stack, d), dtype=dtype, device=device)}


def init_attention(gen: torch.Generator | None, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   device: torch.device, stack: tuple[int, ...] = (),
                   bias: bool = False, kv_input_dim: Optional[int] = None,
                   fused: bool = False) -> dict:
    """QKVO projections, with zero `bq`/`bk`/`bv` biases when `bias`.
    `kv_input_dim` (default d_model) is the width K and V are projected
    from: a cross-attention memory's.  `fused` packs K and V into one
    (kv_in, 2 * Hkv * hd) `wkv` (and `bkv`), K's half first."""
    kv_in = kv_input_dim or d_model
    kv_w = n_kv_heads * head_dim
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device,
                         stack),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device,
                         stack),
    }
    if fused:
        p["wkv"] = dense_init(gen, kv_in, 2 * kv_w, dtype, device, stack)
    else:
        p["wk"] = dense_init(gen, kv_in, kv_w, dtype, device, stack)
        p["wv"] = dense_init(gen, kv_in, kv_w, dtype, device, stack)
    if bias:
        widths = ((("bq", n_heads * head_dim), ("bkv", 2 * kv_w)) if fused
                  else (("bq", n_heads * head_dim), ("bk", kv_w),
                        ("bv", kv_w)))
        for name, width in widths:
            p[name] = torch.zeros((*stack, width), dtype=dtype,
                                  device=device)
    return p


def init_mlp(gen: torch.Generator | None, d_model: int, d_ff: int,
             dtype: torch.dtype, device: torch.device,
             stack: tuple[int, ...] = (), act: str = "swiglu",
             fused: bool = False) -> dict:
    """SwiGLU's w_gate, w_up and w_down (`fused`: w_gate|w_up packed into
    one (d_model, 2 * d_ff) `w_gu`, the gate's half first), or GELU's
    w_up and w_down."""
    if act == "swiglu":
        if fused:
            return {"w_gu": dense_init(gen, d_model, 2 * d_ff, dtype, device,
                                       stack),
                    "w_down": dense_init(gen, d_ff, d_model, dtype, device,
                                         stack)}
        return {"w_gate": dense_init(gen, d_model, d_ff, dtype, device,
                                     stack),
                "w_up": dense_init(gen, d_model, d_ff, dtype, device, stack),
                "w_down": dense_init(gen, d_ff, d_model, dtype, device,
                                     stack)}
    return {"w_up": dense_init(gen, d_model, d_ff, dtype, device, stack),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device, stack)}


# ---------------------------------------------------------------------------
# norms / mlp
# ---------------------------------------------------------------------------

def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, in the reference's order: square
    in `x.dtype`, take the mean in float32, scale in `x.dtype`."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    return layernorm(p, x) if kind == "ln" else rmsnorm(p, x)


def mlp(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """SwiGLU (from the packed `w_gu` where the block has one), or GELU
    in its tanh form (`jax.nn.gelu`'s default)."""
    if act == "swiglu":
        if "w_gu" in p:
            g, u = torch.chunk(x @ p["w_gu"].to(x.dtype), 2, dim=-1)
            h = F.silu(g) * u
        else:
            h = F.silu(x @ p["w_gate"].to(x.dtype))
            h = h * (x @ p["w_up"].to(x.dtype))
    else:
        h = F.gelu(x @ p["w_up"].to(x.dtype), approximate="tanh")
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) absolute token positions (each
    row its own).  The angles are float32 products, as the reference's;
    their cos and sin are rounded once from float64."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs      # (B, S, Dh/2)
    angles = angles.to(torch.float64)
    cos = torch.cos(angles).to(torch.float32)[:, :, None, :]
    sin = torch.sin(angles).to(torch.float32)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _project_qkv(p: dict, x: torch.Tensor, kv_src: torch.Tensor,
                 n_heads: int, n_kv_heads: int, head_dim: int):
    """Q from x (B, S, D), K and V from kv_src (B, T, D_kv), all in
    `x.dtype` (K and V split from one product where `wkv` packs them)."""
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    k, v = _project_kv(p, kv_src, x.dtype)
    B, S = x.shape[:2]
    T = kv_src.shape[1]
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, T, n_kv_heads, head_dim)
    v = v.reshape(B, T, n_kv_heads, head_dim)
    return q, k, v


def _project_kv(p: dict, src: torch.Tensor, dtype: torch.dtype):
    """(B, T, Hkv * hd) K and V of `src` in `dtype`, biased where the
    block has biases."""
    if "wkv" in p:
        kv = src @ p["wkv"].to(dtype)
        if "bkv" in p:
            kv = kv + p["bkv"].to(dtype)
        return torch.chunk(kv, 2, dim=-1)
    k = src @ p["wk"].to(dtype)
    v = src @ p["wv"].to(dtype)
    if "bk" in p:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return k, v


@functools.lru_cache(maxsize=None)
def _attn_scale(Dh: int, dtype: torch.dtype) -> float:
    """1/sqrt(Dh) in float32, rounded to `dtype`, as the reference; a host
    number computed once per (Dh, dtype), so no copy to the device waits
    on the stream."""
    return float(torch.tensor(fa_ops.scale(Dh)).to(dtype))


def softmax_bf16(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim of bf16 `x`, in the steps XLA compiles
    `jax.nn.softmax` of a bf16 array to under `jax.jit`: x - max(x) and
    its exp rounded to bf16, the sum taken over the float32 exps and
    rounded to bf16, the quotient of the two bf16 values rounded once.
    Bit-equal to the jitted reference on the same bf16 input, where
    `torch.softmax` (float32 inside, one rounding) agrees at ~64% of the
    weights and differs by up to 2^-8."""
    e = torch.exp((x - x.amax(dim=-1, keepdim=True)).float())
    total = e.sum(dim=-1, keepdim=True).to(torch.bfloat16)
    return e.to(torch.bfloat16) / total


def _softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
             dtype: torch.dtype) -> torch.Tensor:
    """Scores cast to `dtype` (float32 or bf16), masked with NEG_INF, and
    their softmax over the keys."""
    scores = scores.to(dtype)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    if dtype == torch.bfloat16:
        return softmax_bf16(scores)
    return torch.softmax(scores, dim=-1)


def gqa_scores_apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor], impl: str = "grouped",
                     softmax_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Grouped-query attention core.

    q: (B, S, Hq, Dh), k/v: (B, T, Hkv, Dh), mask: broadcastable to
    (B, Hkv, R, S, T) (grouped) / (B, Hq, S, T) (repeat), or plain
    (S, T).  Returns (B, S, Hq, Dh).  Scores of q * 1/sqrt(Dh) in
    `softmax_dtype`, masked with NEG_INF, softmax, weights in q's dtype.

    impl="grouped": 5-D (B, G, R, S, T) scores, the key/value heads never
    copied.  impl="repeat": K and V repeated to the Hq heads first, (B,
    H, S, T) scores (a 5-D mask is reshaped to them); on a mesh the
    reference picks it because Hq divides the model axis where G does
    not, on one card it is the same function at R-fold the K/V bytes."""
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    scale = _attn_scale(Dh, q.dtype)
    R = Hq // Hkv
    if impl == "repeat":
        if R > 1:
            k = k.repeat_interleave(R, dim=2)
            v = v.repeat_interleave(R, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", q * scale, k)
        if mask is not None and mask.ndim == 5:
            mask = mask.reshape(mask.shape[0], -1, *mask.shape[3:])
        w = _softmax(scores, mask, softmax_dtype).to(q.dtype)
        return torch.einsum("bhst,bthd->bshd", w, v)
    if impl != "grouped":
        raise ValueError(f"unknown attention impl {impl!r}")
    qg = q.reshape(B, S, Hkv, R, Dh)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg * scale, k)
    w = _softmax(scores, mask, softmax_dtype).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v)
    return out.reshape(B, S, Hq, Dh)


def causal_mask(S: int, T: int, window: Optional[int] = None,
                offset: int = 0,
                device: torch.device | None = None) -> torch.Tensor:
    """(S, T) boolean mask; query i attends key j iff
    j <= i + offset and (no window or i + offset - j < window)."""
    i = torch.arange(S, device=device)[:, None] + offset
    j = torch.arange(T, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (i - j < window)
    return m


def self_attention(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                   n_heads: int, n_kv_heads: int, head_dim: int,
                   theta: float, causal: bool = True,
                   window: Optional[int] = None,
                   return_kv: bool = False, use_kernel: bool = True,
                   impl: str = "grouped",
                   softmax_dtype: torch.dtype = torch.float32):
    """Full-sequence self-attention with rope (training, encoder,
    prefill); causal unless `causal=False` (then unmasked, and `window`
    is not read).

    Causal with no window, a float32 softmax and `use_kernel`, the core
    goes to `kernels.flash_attn.ops.causal_attention` on transposed
    views of the (B, S, H, Dh) projections (no copy); the output comes
    back as a view of a (B, S, Hq, Dh) tensor.  That holds for either
    `impl`: the repeated K/V of `impl="repeat"` give the same function
    as the grouped ones, which the kernel reads in place.  A bf16
    softmax, like a window, takes the plain expression
    (`gqa_scores_apply`) on every device: kernel 8 counts as the
    reference's `causal_attention` Pallas kernel, which has no bf16
    softmax either.  With return_kv=True also returns the
    post-rope (k, v), which the prefill turns into the decode cache."""
    q, k, v = _project_qkv(p, x, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    B, S = x.shape[:2]
    if not causal:
        out = gqa_scores_apply(q, k, v, None, impl, softmax_dtype)
    elif use_kernel and window is None and softmax_dtype == torch.float32:
        out = fa_ops.causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2)).transpose(1, 2)
    else:
        out = gqa_scores_apply(q, k, v,
                               causal_mask(S, S, window, device=x.device),
                               impl, softmax_dtype)
    out = out.reshape(B, S, -1) @ p["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def kv_cache_len(S: int, window: Optional[int] = None,
                 cache_len: Optional[int] = None) -> int:
    """Slots of the decode cache that `kv_to_cache` builds from S
    positions."""
    if window is None:
        target = cache_len or S
        if target < S:
            raise ValueError(f"prompt {S} exceeds cache_len {target}")
        return target
    target = min(window, cache_len) if cache_len else window
    # the roll keeps k[:, S - window:], R5's short slice included
    return target if S <= target else len(range(S)[S - window:])


def kv_to_cache(k: torch.Tensor, v: torch.Tensor,
                window: Optional[int] = None,
                cache_len: Optional[int] = None) -> dict:
    """Arrange full-sequence (B, S, G, Dh) K/V into the decode-cache layout.

    Full attention: slot == position, zero-padded out to `cache_len` so
    subsequent decode steps have room.  Sliding window: keep the last
    `window` positions at slots pos % window, matching the rolling writes
    of `decode_self_attention`."""
    S = k.shape[1]
    target = kv_cache_len(S, window, cache_len)
    if window is None or S <= target:
        pad = (0, 0, 0, 0, 0, target - S)
        return {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    r = S % window
    return {"k": torch.roll(k[:, S - window:], r, dims=1),
            "v": torch.roll(v[:, S - window:], r, dims=1)}


def cross_attention(p: dict, x: torch.Tensor, memory: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    impl: str = "grouped") -> torch.Tensor:
    """Cross-attention of x (B, S, D) over a memory sequence (B, T, D_kv):
    no mask, no rope, a float32 softmax."""
    q, k, v = _project_qkv(p, x, memory, n_heads, n_kv_heads, head_dim)
    out = gqa_scores_apply(q, k, v, None, impl)
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype)


def cross_attention_cached(p: dict, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                           head_dim: int,
                           impl: str = "grouped") -> torch.Tensor:
    """Cross-attention against precomputed (B, T, Hkv, Dh) K/V (decode,
    and the prefill once the memory's K/V are projected)."""
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    B, S = x.shape[:2]
    q = q.reshape(B, S, n_heads, head_dim)
    out = gqa_scores_apply(q, k, v, None, impl)
    return out.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def project_cross_kv(p: dict, memory: torch.Tensor, *, n_kv_heads: int,
                     head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A memory's (B, T, Hkv, Dh) K and V, in `memory.dtype`."""
    k, v = _project_kv(p, memory, memory.dtype)
    B, T = memory.shape[:2]
    return (k.reshape(B, T, n_kv_heads, head_dim),
            v.reshape(B, T, n_kv_heads, head_dim))


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, n_kv_heads: int, head_dim: int,
                  dtype: torch.dtype, device: torch.device,
                  stack: tuple[int, ...] = ()) -> dict:
    shape = (*stack, batch, cache_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(p: dict, x: torch.Tensor, cache: dict,
                          pos: int | torch.Tensor, *, n_heads: int,
                          n_kv_heads: int, head_dim: int, theta: float,
                          window: Optional[int] = None, impl: str = "grouped"
                          ) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, D); `pos` is the absolute position of
    the new token, an int for every row or a (B,) tensor, one per row.
    The cache holds the last `cache_len` K/V, stored post-rope at absolute
    positions (for a sliding-window model cache_len == window and writes
    wrap).  Row b is roped at pos[b], writes its K/V at slot
    pos[b] % cache_len of its own cache row (in place: the returned cache
    holds the same tensors) and attends the keys j <= pos[b] (all of them
    once a rolling cache is full)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, x, n_heads, n_kv_heads, head_dim)
    pos = torch.as_tensor(pos, device=x.device).expand(B)
    q = apply_rope(q, pos[:, None], theta)
    k = apply_rope(k, pos[:, None], theta)
    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]
    rows = torch.arange(B, device=x.device)
    slot = pos % cache_len
    ck[rows, slot] = k[:, 0]
    cv[rows, slot] = v[:, 0]
    j = torch.arange(cache_len, device=x.device)[None, :]
    valid = j <= pos[:, None]
    if window is not None:
        valid = valid | (pos[:, None] >= cache_len)
    out = gqa_scores_apply(q, ck, cv, valid[:, None, None, None, :], impl)
    out = out.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return out, {"k": ck, "v": cv}
