"""Plain PyTorch versions of the round gradients.

The two-pass expressions `core.aggregation` uses on the reference path
(the counterparts of `repro/kernels/round_grad/ref.py`): the oracles the
CUDA kernels are held against on the card, and what the wrappers compute
for tensors on the CPU.
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


def coded_round_gradient(x: torch.Tensor, y: torch.Tensor,
                         w: torch.Tensor | None, x_par: torch.Tensor,
                         y_par: torch.Tensor, w_par: torch.Tensor,
                         beta: torch.Tensor) -> torch.Tensor:
    """Systematic + parity blocks, two masked gradients summed; w_par
    (C,) or a scalar broadcast over the parity rows."""
    w_par = torch.broadcast_to(torch.as_tensor(w_par, dtype=y_par.dtype,
                                               device=y_par.device),
                               y_par.shape)
    return masked_round_gradient(x, y, w, beta) \
        + masked_round_gradient(x_par, y_par, w_par, beta)


def tier_masked_round_gradient(x: torch.Tensor, y: torch.Tensor,
                               w: torch.Tensor | None,
                               tier_masks: torch.Tensor,
                               beta: torch.Tensor) -> torch.Tensor:
    """(T, D) tier partials, each the full-width masked gemv
    (contrib * mask_t) @ X, taken tier after tier (the semantics of
    `core.aggregation.tier_reduce`).  At T = 1 with an all-ones mask it
    is bit-equal to `masked_round_gradient`."""
    resid = x @ beta - y
    contrib = resid if w is None else resid * w
    return torch.stack([(contrib * mask) @ x for mask in tier_masks])
