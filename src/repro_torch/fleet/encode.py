"""Fleet-scale streamed parity encoding, tier by tier.

The counterpart of `repro/fleet/encode.py`.  Each edge tier streams its
own partial composite parity through the in-kernel-generator encode
(`kernels.encode.ops.encode_fleet_prng_keys`): no client's (c, ell)
generator block ever exists in memory, since each tile is hashed from
the client's key inside the kernel, and no pass holds more than one
tier's client shards.  The cloud then adds the T tier partials in tier
order.

Key layout: the fleet key is split once into the (n, 2) per-client key
table (`kernels.encode.prng.split_keys`, `jax.random.split`'s layout)
and each tier takes its members' rows, so every client draws the same
G_i as in the flat pass whatever the partition:

  * a single all-client tier is bit-equal to `encode_fleet_prng(key,
    ...)` (the same launches into the same accumulator, in the same
    order);
  * a T-tier partition reassociates only the cross-client sum (tier
    partials, then a T-term sum), as `fleet.aggregate` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.encode import ops as encode_ops
from repro_torch.kernels.encode.prng import split_keys

from .topology import FleetTopology


def encode_fleet_tiered(key, xs: torch.Tensor, ys: torch.Tensor,
                        weights: torch.Tensor, c: int,
                        topology: FleetTopology, kind: str = "normal",
                        block="auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Composite parity (X~ (c, d), y~ (c,)), encoded tier by tier.

    key: the (2,) uint32 fleet key, split per client inside;
    xs: (n, ell, d), ys: (n, ell), weights: (n, ell) on one device;
    c: parity rows; topology: the tier partition, whose members stream
    in ascending client order within each tier; block: kernel 3's tile
    (`kernels.encode.ops.encode_fleet_prng_keys`)."""
    if topology.n != xs.shape[0]:
        raise ValueError(
            f"topology covers {topology.n} clients but xs has "
            f"{xs.shape[0]}")
    keys = split_keys(key, topology.n)
    x_par = y_par = None
    for members in topology.tier_members():
        idx = torch.as_tensor(members, dtype=torch.long, device=xs.device)
        x_t, y_t = encode_ops.encode_fleet_prng_keys(
            keys[members], xs[idx], ys[idx], weights[idx], c, kind=kind,
            block=block)
        if x_par is None:
            x_par, y_par = x_t, y_t
        else:  # cross-tier combine: the only reassociation vs the flat pass
            x_par, y_par = x_par + x_t, y_par + y_t
    return x_par, y_par
