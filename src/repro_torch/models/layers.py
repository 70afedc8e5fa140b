"""Building blocks of the ssm path (counterpart of
`repro/models/layers.py`): the dense initialiser, the norm parameters
and RMSNorm.  Attention, MLPs, rotary embeddings and the KV cache come
with the families that use them.

Params are plain dicts of tensors; `dtype` controls storage and the
products run in `x.dtype` (the caller casts activations).
"""
from __future__ import annotations

import math

import torch


def normal(gen: torch.Generator | None, shape: tuple[int, ...], std: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, std^2) entries from `gen`, drawn in float32 and cast to
    `dtype`; on the meta device (shape checks) nothing is drawn."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=device)
    return (out * std).to(dtype)


def dense_init(gen: torch.Generator | None, in_dim: int, out_dim: int,
               dtype: torch.dtype, device: torch.device,
               stack: tuple[int, ...] = ()) -> torch.Tensor:
    """(*stack, in_dim, out_dim) weights, N(0, 1) x 1/sqrt(in_dim)."""
    return normal(gen, (*stack, in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                  dtype, device)


def init_norm(d: int, dtype: torch.dtype, device: torch.device,
              stack: tuple[int, ...] = ()) -> dict:
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, in the reference's order: square
    in `x.dtype`, take the mean in float32, scale in `x.dtype`."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)
