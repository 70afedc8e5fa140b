"""Plain dense decoder (Llama-style: pre-norm RMSNorm blocks, grouped-query
causal attention with rotary position embeddings on the two halves of
each head, SwiGLU MLP), in float32.

The rotary angles are taken in float64 and their cosines and sines
rounded once; attention is the textbook softmax(q k^T / sqrt(d) + causal
mask) v with each key/value head shared by its group of query heads.
"""
from __future__ import annotations

import math

import torch

F64 = torch.float64


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): each head's two halves rotated by position s times
    theta^(-2i/D)."""
    s, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=F64, device=x.device) / d)
    ang = torch.arange(s, dtype=F64, device=x.device)[:, None] * inv
    cos = ang.cos().to(x.dtype)[None, :, None]
    sin = ang.sin().to(x.dtype)[None, :, None]
    a, b = x.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(p: dict, h: torch.Tensor, model: dict) -> torch.Tensor:
    bsz, s, _ = h.shape
    hq, hkv = model["n_heads"], model["n_kv_heads"]
    d = model.get("head_dim") or model["d_model"] // hq
    theta = model.get("rope_theta", 1e6)
    q = rope((h @ p["wq"]).view(bsz, s, hq, d), theta)
    k = rope((h @ p["wk"]).view(bsz, s, hkv, d), theta)
    v = (h @ p["wv"]).view(bsz, s, hkv, d)
    q = q.view(bsz, s, hkv, hq // hkv, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q, k) / math.sqrt(d)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    weights = scores.masked_fill(~causal, -torch.inf).softmax(-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", weights, v)
    return out.reshape(bsz, s, hq * d) @ p["wo"]


def mlp(p: dict, h: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(h @ p["w_gate"]) * (h @ p["w_up"])) \
        @ p["w_down"]


def layers(params: dict) -> list[dict]:
    """Each layer's leaves, every stacked leaf split once."""
    blocks = params["blocks"]
    parts = {f"{g}/{k}": v.unbind(0) for g, sub in blocks.items()
             for k, v in sub.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def hidden(model: dict, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The last block's output (B, S, D), before the final norm."""
    x = params["embed"][tokens]
    for lp in layers(params):
        a = {k.split("/", 1)[1]: v for k, v in lp.items()
             if k.startswith("attn/")}
        m = {k.split("/", 1)[1]: v for k, v in lp.items()
             if k.startswith("mlp/")}
        x = x + attention(a, rmsnorm(x, lp["attn_norm/scale"]), model)
        x = x + mlp(m, rmsnorm(x, lp["mlp_norm/scale"]))
    return x


def forward(model: dict, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (float32) of every position."""
    head = params.get("lm_head")
    return rmsnorm(hidden(model, params, tokens),
                   params["final_norm"]["scale"]) @ (
        head if head is not None else params["embed"].T)
