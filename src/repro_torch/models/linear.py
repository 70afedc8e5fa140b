"""The paper's workload: linear regression y = X beta + z (§II;
counterpart of `repro/models/linear.py`)."""
from __future__ import annotations

import torch


def linreg_predict(beta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ beta


def linreg_loss(beta: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """Squared-error cost f(beta) = ||X beta - y||^2 (Eq. 1)."""
    r = x @ beta - y
    return torch.sum(r * r)
