"""Client-side random linear encoding of data (paper §III-A, Eqs. 9-12).

The counterpart of `repro/core/encoding.py`.  Each client i draws a
private generator matrix G_i in R^{c x ell_i} with iid N(0,1) entries
(Rademacher ±1 also supported) and a diagonal weight matrix W_i (Eq. 17),
then uploads only

    X~_i = G_i W_i X_i,      y~_i = G_i W_i y_i.

The server sums the client parities into the composite parity dataset
(X~, y~) = (sum_i X~_i, sum_i y~_i).

The fleet encoder streams clients one at a time: one (c, ell) generator and
one (c, d+1) accumulator live at a time, never the (n, c, ell) generator
stack or the (n, c, d) parity stack.  The labels ride along as column d+1,
so X~ and y~ come out of one `client_encode(g, w, x)` call per client —
the plain product, or the hand-written kernel `kernels.encode` with
`use_kernel=True`.  Generators are drawn from an explicit
`torch.Generator`; `jax.random`'s numbers are not reproduced, so parity
tests hand both packages the same G_i through `encode_fleet_streamed`.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from repro_torch.kernels.encode import ops as encode_ops
from repro_torch.kernels.encode import ref as encode_ref


@dataclasses.dataclass(frozen=True)
class ClientParity:
    """Parity shards produced by one client."""

    x_parity: torch.Tensor  # (c, d)
    y_parity: torch.Tensor  # (c,)


def generator_matrix(generator: torch.Generator, c: int, ell: int,
                     kind: str = "normal",
                     dtype=torch.float32) -> torch.Tensor:
    """Random generator matrix G in R^{c x ell} on the generator's device."""
    dev = generator.device
    if kind == "normal":
        return torch.randn((c, ell), generator=generator, device=dev,
                           dtype=dtype)
    if kind == "bernoulli":
        # ±1 with prob 1/2 each: E[G^T G]/c = I still holds.
        bits = torch.randint(0, 2, (c, ell), generator=generator, device=dev)
        return (2 * bits - 1).to(dtype)
    raise ValueError(f"unknown generator kind: {kind}")


def encode_client(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor, use_kernel: bool = False,
                  block="auto") -> ClientParity:
    """(X~, y~) = (G W X, G W y) for one client.

    g: (c, ell), w: (ell,), x: (ell, d), y: (ell,); `block` is the
    kernel's tile where `use_kernel` (see `kernels.encode.ops`).
    """
    x_parity = encode_ops.encode_parity(g, w, x, block=block) if use_kernel \
        else encode_ref.encode_parity(g, w, x)
    return ClientParity(x_parity=x_parity, y_parity=g @ (w * y))


def encode_fleet_streamed(g_source: Callable[[int], torch.Tensor],
                          xs: torch.Tensor, ys: torch.Tensor,
                          weights: torch.Tensor, c: int,
                          client_encode) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared streaming core behind the fleet encoders.

    g_source(i) returns client i's (c, ell) generator, called once per
    client in order; client_encode(g, w, x) returns G diag(w) X.  The
    labels ride along as an extra column of x.  Returns (X~ (c, d),
    y~ (c,)), each the client-ordered sum of the per-client parities.
    """
    n, ell, d = xs.shape
    xa = torch.cat([xs, ys[..., None]], dim=-1).contiguous()  # (n, ell, d+1)
    acc = torch.zeros((c, d + 1), dtype=xs.dtype, device=xs.device)
    for i in range(n):
        acc = acc + client_encode(g_source(i), weights[i].contiguous(), xa[i])
    return acc[:, :d].contiguous(), acc[:, d].contiguous()


def encode_fleet(generator: torch.Generator, xs: torch.Tensor,
                 ys: torch.Tensor, weights: torch.Tensor, c: int,
                 kind: str = "normal", use_kernel: bool = False,
                 block="auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Encode every client and return the composite parity dataset.

    xs: (n, ell, d), ys: (n, ell), weights: (n, ell) on the generator's
    device.  Client i's G_i is the i-th (c, ell) draw from `generator`
    (drawn locally and never shared, in the protocol).  `use_kernel`
    routes each client's product through the hand-written encode kernel
    at tile `block`.
    """
    ell = xs.shape[1]
    client_encode = partial(encode_ops.encode_parity, block=block) \
        if use_kernel else encode_ref.encode_parity
    return encode_fleet_streamed(
        lambda i: generator_matrix(generator, c, ell, kind=kind,
                                   dtype=xs.dtype),
        xs, ys, weights, c, client_encode)
