"""Low-latency coded federated learning over wireless edge networks
(counterpart of `repro/schemes/lowlatency.py`; arXiv:2011.06223 on the
source paper's substrate).

The scenario: heterogeneous wireless links — per-device rates tau_i AND
erasure probabilities p_i differ (`sim.network.wireless_fleet`) — and
devices upload PARTIAL work: an assignment of ell points goes out in
`chunks` incremental uploads, chunk q covering the first q*ell/chunks
points, so a straggler that finishes only half its load still contributes
half a gradient.

The load allocation and deadline come from the port's grid planner with
`edge_chunks = chunks` (the partial-return objective,
`E[R_i(t; ell)] = (ell/Q) * sum_q Pr{chunk q done by t}`).  Eq. 17
generalizes per chunk: the systematic rows of chunk q are encoded with
weight sqrt(1 - Pr{chunk q done by t*}) (`core.delay_model.partial_cdf`),
through the encode kernel's wrapper (the kernel on the card).

Per epoch a row contributes iff its chunk completed by t*: on the fused
path the chunk gate multiplies the packed rows' base weight in front of
one round-gradient launch (the tier-masked one under `HierarchicalCFL`),
and the parity term is Gram-folded as in `CodedFL`.  At `chunks = 1` the
scheme is `CodedFL`: the same weights, parity and arrival stream.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, ClassVar, Dict, Hashable, Optional, Union

import numpy as np
import torch

from repro_torch.api.strategy import EpochSchedule, TrainData
from repro_torch.core import aggregation, encoding
from repro_torch.core.delay_model import partial_cdf, sample_total
from repro_torch.core.redundancy import RedundancyPlan
from repro_torch.plan import PlanRequest, solve_redundancy_batched

from .base import (CodedSchemeState, coded_device_state, coded_uplink_bits,
                   fused_coded_device_state, sample_parity_upload_time)

if TYPE_CHECKING:
    from repro_torch.sim.network import FleetSpec


def row_chunks(loads: np.ndarray, ell: int, chunks: int) -> np.ndarray:
    """(n, ell) chunk index of every row: row j < ell_i belongs to chunk
    floor(j * Q / ell_i); rows at or beyond the load get `chunks` (a chunk
    id that never completes, so they can only be covered by parity)."""
    j = np.arange(ell)[None, :]                       # (1, ell)
    ell_i = np.maximum(loads[:, None], 1)             # (n, 1)
    q = (j * chunks) // ell_i
    return np.where(j < loads[:, None], q, chunks).astype(np.int32)


@dataclasses.dataclass
class LowLatencyState(CodedSchemeState):
    """`CodedSchemeState` + per-chunk completion probabilities at t*."""

    chunk_probs: np.ndarray   # (n, Q) Pr{chunk q done by t*}
    row_chunk: np.ndarray     # (n, ell) chunk id per row (Q = punctured)


@dataclasses.dataclass(frozen=True)
class LowLatencyCFL:
    """Partial-return CFL for heterogeneous wireless fleets.

    key:    int seed of the `torch.Generator` (on the data's device) that
            draws the clients' private generator matrices, or that
            generator itself
    chunks: incremental uploads per device per epoch (1 = all-or-nothing,
            which is `CodedFL` bit for bit)
    fixed_c / c_up / include_upload_delay / generator: as in `CodedFL`
    redundancy_plan: pre-solved plan; `plan` then only encodes
    grad_path: "fused" (default) or "reference"
    """

    key: Union[int, torch.Generator]
    chunks: int = 8
    fixed_c: Optional[int] = None
    c_up: Optional[int] = None
    include_upload_delay: bool = True
    generator: str = "normal"
    label: str = "lowlat"
    redundancy_plan: Optional[RedundancyPlan] = None
    grad_path: str = aggregation.FUSED

    # every knob (chunks included) reaches the epoch program only through
    # operand values — the chunk ids, the completed-chunk counts, the
    # plan — so a chunking or heterogeneity sweep shares one engine
    engine_value_fields: ClassVar[frozenset] = frozenset(
        {"key", "chunks", "fixed_c", "c_up", "include_upload_delay",
         "generator"})
    # data-only operands (one copy per sweep); the chunk ids are
    # plan-derived and stay per lane
    data_device_keys: ClassVar[frozenset] = frozenset(
        {"x", "y", "row_client"})

    def __post_init__(self):
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")

    def _grad_path(self) -> str:
        return aggregation.resolve_grad_path(self.grad_path)

    # -- planning -----------------------------------------------------------

    def plan_request(self, fleet: "FleetSpec",
                     data: TrainData) -> PlanRequest:
        """The partial-return redundancy problem `plan` would solve."""
        return PlanRequest(edge=fleet.edge, server=fleet.server,
                           data_sizes=np.full(data.n, data.ell,
                                              dtype=np.int64),
                           c_up=self.c_up, fixed_c=self.fixed_c,
                           edge_chunks=self.chunks)

    def plan_with(self, fleet: "FleetSpec", data: TrainData,
                  plan: Optional[RedundancyPlan]) -> LowLatencyState:
        """`plan` with the redundancy solve already done (None: solve it
        on the data's device), then the per-chunk Eq.-17 encode."""
        dev = data.device
        if plan is None:
            plan = solve_redundancy_batched(
                [self.plan_request(fleet, data)], device=dev)[0]
        n, ell, d = data.n, data.ell, data.d
        dtype = data.xs.dtype
        q = self.chunks
        # per-chunk Eq. 17: chunk-q rows weighted sqrt(1 - Pr{chunk done});
        # punctured rows carry chunk id Q, which indexes the appended
        # zero-probability column and so gets weight sqrt(1 - 0) = 1
        probs = partial_cdf(fleet.edge, plan.loads, plan.t_star, q)  # (n, Q)
        rc = row_chunks(plan.loads, ell, q)                       # (n, ell)
        probs_ext = np.concatenate([probs, np.zeros((n, 1))], axis=1)
        w_np = np.sqrt(np.maximum(
            0.0, 1.0 - np.take_along_axis(probs_ext, rc, axis=1)))
        weights = torch.as_tensor(w_np, device=dev).to(dtype)
        load_mask = torch.as_tensor(
            np.arange(ell)[None, :] < plan.loads[:, None], device=dev
        ).to(dtype)

        if plan.c > 0:
            gen = self.key if isinstance(self.key, torch.Generator) \
                else torch.Generator(device=dev).manual_seed(int(self.key))
            x_par, y_par = encoding.encode_fleet(
                gen, data.xs, data.ys, weights, plan.c,
                kind=self.generator, use_kernel=True)
        else:  # delta = 0 degenerates to uncoded FL with deadline t*
            x_par = torch.zeros((0, d), dtype=dtype, device=dev)
            y_par = torch.zeros((0,), dtype=dtype, device=dev)

        return LowLatencyState(plan=plan, load_mask=load_mask,
                               x_parity=x_par, y_parity=y_par,
                               edge=fleet.edge, server=fleet.server,
                               chunk_probs=probs, row_chunk=rc)

    def plan(self, fleet: "FleetSpec", data: TrainData) -> LowLatencyState:
        return self.plan_with(fleet, data, self.redundancy_plan)

    # -- epoch sampling -----------------------------------------------------

    def sample_epochs(self, state: LowLatencyState, fleet: "FleetSpec",
                      epochs: int, rng: np.random.Generator) -> EpochSchedule:
        """Per epoch: each client's completed-chunk count, then (c > 0)
        the server's delay.  The component draws mirror `sample_total`'s
        order (exponential, geometric down, geometric up), so chunks = 1
        reproduces CodedFL's arrival stream."""
        plan = state.plan
        n = fleet.edge.n
        t_star = plan.t_star
        q = self.chunks
        upload_time = sample_parity_upload_time(state, fleet, rng)

        edge = fleet.edge
        loads = plan.loads.astype(np.float64)
        shift = loads * edge.a                               # (n,)
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = np.where(loads > 0, loads / edge.mu, 0.0)
        comm = edge.tau > 0
        p = np.where(comm, edge.p, 0.0)
        fracs = np.arange(1, q + 1, dtype=np.float64) / q     # (Q,)

        chunks_done = np.empty((epochs, n), dtype=np.float32)
        parity_ok = np.ones(epochs, dtype=np.float32)
        for e in range(epochs):
            t_stoch = rng.exponential(1.0, size=n) * scale
            n_d = rng.geometric(1.0 - p, size=n)
            n_u = rng.geometric(1.0 - p, size=n)
            t_comm = np.where(comm, (n_d + n_u) * edge.tau, 0.0)
            t_q = (fracs[None, :] * shift[:, None] + t_stoch[:, None]) \
                + t_comm[:, None]                             # (n, Q)
            chunks_done[e] = np.where(
                loads > 0, np.sum(t_q <= t_star, axis=1), 0.0)
            if state.c > 0:
                t_srv = sample_total(fleet.server, np.array([state.c]),
                                     rng)[0]
                parity_ok[e] = float(t_srv <= t_star)

        return EpochSchedule(
            durations=np.full(epochs, t_star),
            arrivals={"chunks_done": chunks_done, "parity_ok": parity_ok},
            setup_time=upload_time,
            t0=upload_time if self.include_upload_delay else 0.0)

    # -- epoch hooks --------------------------------------------------------

    def device_state(self, state: LowLatencyState,
                     data: TrainData) -> Dict[str, torch.Tensor]:
        if self._grad_path() == aggregation.FUSED:
            # copy: the layout is memoized on the state and must not
            # absorb per-strategy extras
            dev = dict(fused_coded_device_state(state, data))
            rc = torch.as_tensor(state.row_chunk.reshape(data.m),
                                 device=data.device)
            if "sys_rows" in dev:
                rc = rc.index_select(0, dev["sys_rows"])
            dev["sys_chunk"] = rc
            return dev
        dev = coded_device_state(state, data)
        dev["row_chunk"] = torch.as_tensor(state.row_chunk.reshape(data.m),
                                           device=data.device)
        return dev

    def _fused_weights(self, dev, arrivals) -> torch.Tensor:
        # a row contributes iff its chunk completed by t*
        x, _, w0, client = aggregation.fused_sys_block(dev)
        done = arrivals["chunks_done"][client]
        return w0 * (dev["sys_chunk"] < done).to(x.dtype)

    def _reference_weights(self, dev, arrivals, dtype) -> torch.Tensor:
        done = arrivals["chunks_done"][dev["row_client"]]
        return dev["w_sys"] * (dev["row_chunk"] < done).to(dtype)

    def round_contributions(self, state, dev, beta, arrivals):
        if self._grad_path() == aggregation.FUSED:
            x, y, _, _ = aggregation.fused_sys_block(dev)
            w = self._fused_weights(dev, arrivals)
            if state.c == 0:
                return aggregation.round_gradient(
                    x, y, beta, w=w, path=aggregation.FUSED)
            return aggregation.fused_coded_gradient(
                dev, w, arrivals["parity_ok"], beta)
        resid = dev["x"] @ beta - dev["y"]
        w = self._reference_weights(dev, arrivals, resid.dtype)
        g_sys = (resid * w) @ dev["x"]
        if state.c == 0:
            return g_sys
        g_par = aggregation.parity_gradient(
            dev["x_parity"], dev["y_parity"], beta, use_kernel=False)
        return g_sys + arrivals["parity_ok"] * g_par

    def tiered_contributions(self, state, dev, beta, arrivals, tier_masks):
        # chunk-gated systematic partials reduce per edge tier; the parity
        # gradient is server-resident and rides as the server-side term
        if self._grad_path() == aggregation.FUSED:
            x, y, _, _ = aggregation.fused_sys_block(dev)
            masks = aggregation.fused_tier_masks(dev, tier_masks)
            w = self._fused_weights(dev, arrivals)
            partials = aggregation.tiered_round_gradient(
                x, y, beta, w, masks, path=aggregation.FUSED)
            if state.c == 0:
                return partials, None
            g_par = aggregation.gram_parity_gradient(
                dev["par_gram"], dev["par_gramy"], beta, dev["par_c"])
            return partials, arrivals["parity_ok"] * g_par
        resid = dev["x"] @ beta - dev["y"]
        w = self._reference_weights(dev, arrivals, resid.dtype)
        partials = aggregation.tier_reduce(resid * w, dev["x"], tier_masks)
        if state.c == 0:
            return partials, None
        g_par = aggregation.parity_gradient(
            dev["x_parity"], dev["y_parity"], beta, use_kernel=False)
        return partials, arrivals["parity_ok"] * g_par

    def uplink_bits(self, state: LowLatencyState, fleet: "FleetSpec",
                    epochs: int) -> float:
        # Q incremental chunk packets + 1 completion packet per device-epoch
        return coded_uplink_bits(state, fleet, epochs,
                                 packets_per_epoch=self.chunks + 1)

    def engine_key(self, state: LowLatencyState) -> Hashable:
        return (state.c > 0,)

    def sweep_inputs(self, state: LowLatencyState, fleet: "FleetSpec",
                     epochs: int, rng: np.random.Generator) -> EpochSchedule:
        """One sweep lane's inputs: `chunks_done (epochs, n)` and
        `parity_ok (epochs,)`; draws are exactly `sample_epochs`."""
        return self.sample_epochs(state, fleet, epochs, rng)

    def report_extras(self, state: LowLatencyState) -> Dict[str, float]:
        return {"chunks": float(self.chunks),
                "mean_chunk_prob": float(np.mean(state.chunk_probs)),
                "t_star": float(state.plan.t_star)}
