"""Synthetic dataset generators (counterpart of `repro/data/synthetic.py`).

`linreg_dataset` is the paper §IV setup — X iid N(0,1), beta ~ N(0,1)^d,
y = X beta + z with unit-variance noise — drawn from an explicit
`torch.Generator` on its device.  The distributions are the reference's;
the numbers are not (torch's generators are not `jax.random`), so parity
tests hand both packages the same NumPy arrays instead.
"""
from __future__ import annotations

import torch


def linreg_dataset(generator: torch.Generator, n_clients: int, ell: int,
                   d: int, noise_std: float = 1.0):
    """Returns (xs (n, ell, d), ys (n, ell), beta_true (d,)), float32, on
    the generator's device."""
    dev = generator.device
    xs = torch.randn((n_clients, ell, d), generator=generator, device=dev,
                     dtype=torch.float32)
    beta = torch.randn((d,), generator=generator, device=dev,
                       dtype=torch.float32)
    zs = noise_std * torch.randn((n_clients, ell), generator=generator,
                                 device=dev, dtype=torch.float32)
    ys = torch.einsum("nld,d->nl", xs, beta) + zs
    return xs, ys, beta
