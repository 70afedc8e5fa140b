"""Coded Federated Learning protocol state (paper §III).

The counterpart of `repro/core/cfl.py`.  In the order the protocol runs:

  1. The server collects delay statistics and local dataset sizes, runs
     the two-step redundancy optimization (Eqs. 14-16) and broadcasts
     (c, ell*_i, Pr{T_i >= t*}) to the clients.
  2. Each client builds its weight vector (Eq. 17), draws a private G_i
     and uploads parity (G_i W_i X_i, G_i W_i y_i) once; the server sums
     them into the composite parity dataset.
  3. Per epoch the server combines whatever arrived by t* (Eqs. 18-19);
     the per-epoch operands come from `fused_coded_device_state` (fused
     path) or `coded_device_state` (reference path); `epoch_gradient` is
     the legacy per-epoch API over the state itself.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from . import aggregation, encoding
from .delay_model import DeviceDelayParams
from .redundancy import RedundancyPlan, solve_redundancy, systematic_weights

if TYPE_CHECKING:
    from repro_torch.sim.network import FleetSpec


def parity_upload_bits(n: int, c: int, d: int, bits_per_value: int = 32,
                       header_overhead: float = 0.10) -> np.ndarray:
    """Bits each of n clients uploads for its (c, d+1) parity shard."""
    per_client = c * (d + 1) * bits_per_value * (1.0 + header_overhead)
    return np.full(n, per_client)


def sample_parity_upload_time(state, fleet: "FleetSpec",
                              rng: np.random.Generator) -> float:
    """One-time parity-upload wall time: each device ships its shard over
    its own link, in parallel, so the fleet-level delay is the slowest.
    The geometric retransmission draw happens even when c == 0, keeping
    the reference's generator order."""
    upload_bits = state.parity_upload_bits()
    packets = np.ceil(upload_bits / fleet.packet_bits)
    retrans = rng.geometric(1.0 - fleet.edge.p, size=fleet.edge.n)
    if state.c == 0:
        return 0.0
    return float(np.max(
        packets * retrans * (fleet.packet_bits / fleet.link_rates)))


def coded_uplink_bits(state, fleet: "FleetSpec", epochs: int,
                      packets_per_epoch: int = 2) -> float:
    """Total device->server bits: the one-time parity upload plus
    `packets_per_epoch` packets per device per epoch."""
    n = fleet.edge.n
    return float(np.sum(state.parity_upload_bits())) \
        + epochs * n * packets_per_epoch * fleet.packet_bits


# Packed row counts are padded up to a bucket multiple (as in the
# reference); padding rows replicate row 0 at weight 0.0 — exact-zero
# contributions.  Above PACK_DENSE_FRAC support density packing is skipped
# and the dense layout keeps the full (m, d) rows.
PACK_BLOCK = 512
PACK_MIN = 64
PACK_DENSE_FRAC = 0.85


def packed_row_indices(load_flat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Row indices of the plan's systematic support, bucket-padded.

    load_flat: (m,) flattened load mask.  Returns (idx, valid): int32
    indices of length ceil(k / PACK_BLOCK) * PACK_BLOCK (min PACK_MIN)
    where k rows have load > 0, and the bool validity mask that becomes
    the packed layout's base row weight."""
    keep = np.flatnonzero(np.asarray(load_flat) > 0).astype(np.int32)
    k = int(keep.size)
    target = max(PACK_MIN, PACK_BLOCK * -(-k // PACK_BLOCK)) if k \
        else PACK_MIN
    idx = np.zeros(target, dtype=np.int32)
    idx[:k] = keep
    valid = np.arange(target) < k
    return idx, valid


def fused_coded_device_state(state, data, parity_rows: bool = False
                             ) -> dict:
    """Per-run operands of the FUSED gradient path: systematic rows packed
    to the plan's support (zero-load rows dropped, the count
    bucket-padded at weight 0) and the parity block folded to its Gram
    factors.  At the paper's §IV point this streams 5632 of 7200 rows.

    When the padded support is dense (>= PACK_DENSE_FRAC * m rows) the
    dict keeps the full rows under "x"/"y"/"row_client" with the load mask
    as "sys_w" (consume through `aggregation.fused_sys_block`).

    parity_rows: ship the raw parity rows ("x_parity"/"y_parity") in
    place of the Gram factors, for schemes whose per-round parity masks
    need the rows themselves (StochasticCodedFL at sample_frac < 1).
    The reference computes the factors there too and never reads them."""
    n, ell = data.n, data.ell
    dev_ = data.xs.device
    x = data.xs.reshape(data.m, data.d)
    y = data.ys.reshape(data.m)
    load_flat = state.load_mask.reshape(data.m).cpu().numpy()
    idx, valid = packed_row_indices(load_flat)
    row_client = torch.arange(n, device=dev_).repeat_interleave(ell)
    if idx.size >= PACK_DENSE_FRAC * data.m:
        dev = {"x": x, "y": y, "row_client": row_client,
               "sys_w": torch.as_tensor(load_flat, dtype=x.dtype,
                                        device=dev_)}
    else:
        tidx = torch.as_tensor(idx, dtype=torch.long, device=dev_)
        dev = {"sys_x": x.index_select(0, tidx).contiguous(),
               "sys_y": y.index_select(0, tidx).contiguous(),
               "sys_w": torch.as_tensor(valid, dtype=x.dtype, device=dev_),
               "sys_client": row_client.index_select(0, tidx),
               "sys_rows": tidx}
    if state.c > 0:
        dev["par_c"] = torch.tensor(float(state.c), dtype=x.dtype,
                                    device=dev_)
        if parity_rows:
            dev["x_parity"] = state.x_parity
            dev["y_parity"] = state.y_parity
        else:
            gram, gramy = aggregation.parity_gram(state.x_parity,
                                                  state.y_parity)
            dev["par_gram"] = gram
            dev["par_gramy"] = gramy
    return dev


def coded_device_state(state, data) -> dict:
    """Per-run operands of the REFERENCE path: flat (m, d) data, the
    systematic load mask, per-row client ids and the parity shards."""
    n, ell = data.n, data.ell
    row_client = torch.arange(n, device=data.xs.device).repeat_interleave(ell)
    return {"x": data.xs.reshape(data.m, data.d),
            "y": data.ys.reshape(data.m),
            "w_sys": state.load_mask.reshape(data.m),
            "row_client": row_client,
            "x_parity": state.x_parity,
            "y_parity": state.y_parity}


@dataclasses.dataclass
class CFLState:
    """Frozen protocol state after setup (one-time encoding done)."""

    plan: RedundancyPlan
    weights: torch.Tensor     # (n, ell) Eq.-17 weight diagonals
    load_mask: torch.Tensor   # (n, ell) 1.0 on each client's processed points
    x_parity: torch.Tensor    # (c, d) composite parity features
    y_parity: torch.Tensor    # (c,)   composite parity labels
    edge: DeviceDelayParams
    server: DeviceDelayParams

    @property
    def c(self) -> int:
        return int(self.x_parity.shape[0])

    def parity_upload_bits(self, bits_per_value: int = 32,
                           header_overhead: float = 0.10) -> np.ndarray:
        """Bits each client uploads for its parity shard (one-time cost)."""
        return parity_upload_bits(self.edge.n, self.c,
                                  int(self.x_parity.shape[1]),
                                  bits_per_value, header_overhead)


def setup(key, xs: torch.Tensor, ys: torch.Tensor,
          edge: DeviceDelayParams, server: DeviceDelayParams,
          fixed_c: int | None = None, c_up: int | None = None,
          generator: str = "normal", use_kernel: bool = False,
          plan: RedundancyPlan | None = None) -> CFLState:
    """Run steps 1-2 of the protocol (optimization + one-time encoding).

    key: a `torch.Generator` on the data's device, or an int seed for one;
         the clients' private generators are drawn from it in order.
    xs: (n, ell, d) client features, ys: (n, ell) labels, on one device
        (the planner runs there too).
    fixed_c: sweep mode — force the coding redundancy.
    plan: a pre-solved redundancy plan; skips the solve.
    use_kernel: encode through the hand-written encode kernel.
    """
    n, ell, _ = xs.shape
    dev = xs.device
    data_sizes = np.full(n, ell, dtype=np.int64)
    if plan is None:
        plan = solve_redundancy(edge, server, data_sizes, c_up=c_up,
                                fixed_c=fixed_c, device=dev)

    w_list = systematic_weights(plan, data_sizes)
    weights = torch.as_tensor(np.stack(w_list), device=dev).to(xs.dtype)
    load_mask = torch.as_tensor(
        np.arange(ell)[None, :] < plan.loads[:, None], device=dev
    ).to(xs.dtype)

    if plan.c > 0:
        if not isinstance(key, torch.Generator):
            key = torch.Generator(device=dev).manual_seed(int(key))
        x_par, y_par = encoding.encode_fleet(
            key, xs, ys, weights, plan.c, kind=generator,
            use_kernel=use_kernel)
    else:  # delta = 0 degenerates to uncoded FL with deadline t*
        x_par = torch.zeros((0, xs.shape[-1]), dtype=xs.dtype, device=dev)
        y_par = torch.zeros((0,), dtype=xs.dtype, device=dev)

    return CFLState(plan=plan, weights=weights, load_mask=load_mask,
                    x_parity=x_par, y_parity=y_par, edge=edge, server=server)


def epoch_gradient(state: CFLState, xs: torch.Tensor, ys: torch.Tensor,
                   beta: torch.Tensor, received: torch.Tensor,
                   parity_received, use_kernel: bool = True
                   ) -> torch.Tensor:
    """One epoch's combined gradient given arrival masks (the legacy
    per-epoch API): per-client partials over the load mask, the parity
    gradient (`aggregation.parity_gradient`: its kernel on a CUDA tensor
    unless `use_kernel=False`), then the deadline-masked combine.
    received: (n,) {0,1}; parity_received: a {0,1} scalar; c == 0 drops
    the parity term."""
    partials = aggregation.client_partial_gradients(xs, ys, state.load_mask,
                                                    beta)
    if state.c > 0:
        g_par = aggregation.parity_gradient(
            state.x_parity, state.y_parity, beta, use_kernel=use_kernel)
    else:
        g_par = torch.zeros_like(beta)
        parity_received = torch.zeros((), dtype=beta.dtype,
                                      device=beta.device)
    return aggregation.combine(partials, received, g_par, parity_received)
