"""Plain PyTorch versions of the weighted parity encodings."""
from __future__ import annotations

import torch

from .prng import generator_values


def encode_parity(g: torch.Tensor, w: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """P = G @ (diag(w) X).  g: (C, L), w: (L,), x: (L, D) -> (C, D)."""
    return g @ (w[:, None] * x)


def encode_parity_prng(key, w: torch.Tensor, x: torch.Tensor, c: int,
                       kind: str = "normal") -> torch.Tensor:
    """P = G @ (diag(w) X) with G = `prng.generator_values(key, c, L,
    kind)` materialized on x's device.  w: (L,), x: (L, D) -> (C, D)."""
    g = generator_values(key, c, x.shape[0], kind, device=x.device)
    return encode_parity(g, w, x)
