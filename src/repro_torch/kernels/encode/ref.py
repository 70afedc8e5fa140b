"""Plain PyTorch version of the weighted parity encoding."""
from __future__ import annotations

import torch


def encode_parity(g: torch.Tensor, w: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """P = G @ (diag(w) X).  g: (C, L), w: (L,), x: (L, D) -> (C, D)."""
    return g @ (w[:, None] * x)
