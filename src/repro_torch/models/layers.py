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
  * only what the ported families use: no packed projections (`fused`),
    no `impl="repeat"`, bf16 softmax or `seq_shard` (no config sets them;
    `models.transformer` raises on them), and self-attention is roped.
    Non-causal self-attention (the audio encoder's) and cross-attention
    take the grouped expression with no mask, never kernel 8, which is
    causal only: as in the reference, which reaches no kernel there.
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
                   bias: bool = False,
                   kv_input_dim: Optional[int] = None) -> dict:
    """QKVO projections, with zero `bq`/`bk`/`bv` biases when `bias`.
    `kv_input_dim` (default d_model) is the width K and V are projected
    from: a cross-attention memory's."""
    kv_in = kv_input_dim or d_model
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device,
                         stack),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device,
                         stack),
        "wk": dense_init(gen, kv_in, n_kv_heads * head_dim, dtype, device,
                         stack),
        "wv": dense_init(gen, kv_in, n_kv_heads * head_dim, dtype, device,
                         stack),
    }
    if bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = torch.zeros((*stack, width * head_dim), dtype=dtype,
                                  device=device)
    return p


def init_mlp(gen: torch.Generator | None, d_model: int, d_ff: int,
             dtype: torch.dtype, device: torch.device,
             stack: tuple[int, ...] = (), act: str = "swiglu") -> dict:
    if act == "swiglu":
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
    """SwiGLU, or GELU in its tanh form (`jax.nn.gelu`'s default)."""
    if act == "swiglu":
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
    `x.dtype`."""
    q = x @ p["wq"].to(x.dtype)
    k = kv_src @ p["wk"].to(x.dtype)
    v = kv_src @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    B, S = x.shape[:2]
    T = kv_src.shape[1]
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, T, n_kv_heads, head_dim)
    v = v.reshape(B, T, n_kv_heads, head_dim)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _attn_scale(Dh: int, dtype: torch.dtype) -> float:
    """1/sqrt(Dh) in float32, rounded to `dtype`, as the reference; a host
    number computed once per (Dh, dtype), so no copy to the device waits
    on the stream."""
    return float(torch.tensor(fa_ops.scale(Dh)).to(dtype))


def gqa_scores_apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped-query attention core (the reference's `impl="grouped"`).

    q: (B, S, Hq, Dh), k/v: (B, T, Hkv, Dh), mask: broadcastable to
    (B, Hkv, R, S, T), or plain (S, T).  Returns (B, S, Hq, Dh).  Scores
    of q * 1/sqrt(Dh), masked with NEG_INF, float32 softmax."""
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    scale = _attn_scale(Dh, q.dtype)
    R = Hq // Hkv
    qg = q.reshape(B, S, Hkv, R, Dh)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg * scale, k)
    scores = scores.to(torch.float32)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
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
                   return_kv: bool = False, use_kernel: bool = True):
    """Full-sequence self-attention with rope (training, encoder,
    prefill); causal unless `causal=False` (then unmasked, and `window`
    is not read).

    Causal with no window and `use_kernel`, the core goes to
    `kernels.flash_attn.ops.causal_attention` on transposed views of the
    (B, S, H, Dh) projections (no copy); the output comes back as a view
    of a (B, S, Hq, Dh) tensor.  With return_kv=True also returns the
    post-rope (k, v), which the prefill turns into the decode cache."""
    q, k, v = _project_qkv(p, x, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    B, S = x.shape[:2]
    if not causal:
        out = gqa_scores_apply(q, k, v, None)
    elif use_kernel and window is None:
        out = fa_ops.causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2)).transpose(1, 2)
    else:
        out = gqa_scores_apply(q, k, v,
                               causal_mask(S, S, window, device=x.device))
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
                    n_heads: int, n_kv_heads: int,
                    head_dim: int) -> torch.Tensor:
    """Cross-attention of x (B, S, D) over a memory sequence (B, T, D_kv):
    no mask, no rope."""
    q, k, v = _project_qkv(p, x, memory, n_heads, n_kv_heads, head_dim)
    out = gqa_scores_apply(q, k, v, None)
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype)


def cross_attention_cached(p: dict, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                           head_dim: int) -> torch.Tensor:
    """Cross-attention against precomputed (B, T, Hkv, Dh) K/V (decode,
    and the prefill once the memory's K/V are projected)."""
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    B, S = x.shape[:2]
    q = q.reshape(B, S, n_heads, head_dim)
    out = gqa_scores_apply(q, k, v, None)
    return out.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def project_cross_kv(p: dict, memory: torch.Tensor, *, n_kv_heads: int,
                     head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A memory's (B, T, Hkv, Dh) K and V, in `memory.dtype`."""
    k = memory @ p["wk"].to(memory.dtype)
    v = memory @ p["wv"].to(memory.dtype)
    if "bk" in p:
        k = k + p["bk"].to(memory.dtype)
        v = v + p["bv"].to(memory.dtype)
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
                          window: Optional[int] = None
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
    out = gqa_scores_apply(q, ck, cv, valid[:, None, None, None, :])
    out = out.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return out, {"k": ck, "v": cv}
