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


def encode_fleet(gs: torch.Tensor, ws: torch.Tensor, xs: torch.Tensor,
                 ys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite parity from an explicit generator stack (a test oracle).

    gs: (n, c, ell), ws: (n, ell), xs: (n, ell, d), ys: (n, ell)
    -> (X~ (c, d), y~ (c,)) = (sum_i G_i W_i X_i, sum_i G_i W_i y_i)."""
    xp = torch.einsum("ncl,nl,nld->cd", gs, ws, xs)
    yp = torch.einsum("ncl,nl,nl->c", gs, ws, ys)
    return xp, yp
