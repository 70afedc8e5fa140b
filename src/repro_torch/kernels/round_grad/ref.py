"""Plain PyTorch version of the masked round gradient.

The two-pass expression `core.aggregation` uses on the reference path:
the oracle the CUDA kernel is held against on the card, and what the
wrapper computes for tensors on the CPU.
"""
from __future__ import annotations

import torch


def masked_round_gradient(x: torch.Tensor, y: torch.Tensor,
                          w: torch.Tensor | None,
                          beta: torch.Tensor) -> torch.Tensor:
    """g = (w * (X beta - y)) @ X.  x: (M, D), y/w: (M,), beta: (D,);
    w=None means unweighted."""
    resid = x @ beta - y
    if w is None:
        return resid @ x
    return (resid * w) @ x
