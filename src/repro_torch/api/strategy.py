"""The `Strategy` protocol and the §IV strategies (counterpart of
`repro/api/strategy.py`: `TrainData`, `EpochSchedule`, `UncodedFL`,
`CodedFL`).

A strategy answers two questions:

  1. `plan(fleet, data)` — one-time host-side setup (load allocation,
     deadline, encoding); returns an opaque strategy state.
  2. `round_contributions(state, dev, beta, arrivals)` — one epoch's
     combined gradient from that epoch's arrival tensors.  It runs once per
     epoch inside `Session.run`'s loop, so it reads only static structure
     from `state`; every tensor comes in through `dev` (per-run device
     operands from `device_state`) or `arrivals` (this epoch's slice of
     `sample_epochs`' tensors).

`sample_epochs` pre-samples every epoch's delays and arrivals on the host
with NumPy, in exactly the reference's draw order, so both packages give
identical schedules and clocks from the same `np.random.Generator`.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Any, Dict, Optional, Protocol,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core import aggregation, cfl
from repro_torch.core.delay_model import sample_total
from repro_torch.core.redundancy import RedundancyPlan
from repro_torch.data.synthetic import linreg_dataset
from repro_torch.device import resolve_device

if TYPE_CHECKING:
    from repro_torch.sim.network import FleetSpec


@dataclasses.dataclass(frozen=True)
class TrainData:
    """The decentralized training problem: client-sharded linear regression.

    xs: (n, ell, d) client-resident features
    ys: (n, ell)    client-resident labels
    beta_true: (d,) ground truth (for the NMSE trace only)
    All three live on one device.
    """

    xs: torch.Tensor
    ys: torch.Tensor
    beta_true: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.xs.shape[0])

    @property
    def ell(self) -> int:
        return int(self.xs.shape[1])

    @property
    def d(self) -> int:
        return int(self.xs.shape[2])

    @property
    def m(self) -> int:
        return self.n * self.ell

    @property
    def model_dim(self) -> int:
        return int(self.beta_true.shape[0])

    @property
    def device(self) -> torch.device:
        return self.xs.device

    @classmethod
    def linreg(cls, key, n: int, ell: int, d: int, noise_std: float = 1.0,
               device=None) -> "TrainData":
        """Paper §IV data: X iid N(0,1), beta ~ N(0,1)^d, y = X beta + z.

        key: an int seed or a `torch.Generator` (whose device is used);
        device: where an int seed's generator lives (None: the card)."""
        if not isinstance(key, torch.Generator):
            key = torch.Generator(device=resolve_device(device)) \
                .manual_seed(int(key))
        xs, ys, beta = linreg_dataset(key, n, ell, d, noise_std)
        return cls(xs=xs, ys=ys, beta_true=beta)


@dataclasses.dataclass
class EpochSchedule:
    """Pre-sampled per-epoch randomness for one full training run.

    durations: (epochs,) wall time of each epoch (host-side bookkeeping)
    arrivals:  dict of per-epoch NumPy arrays, each with leading dim
               `epochs`; `Session.run` moves them to the device once
    setup_time: one-time setup wall time to report (0 if none)
    t0:        wall-clock offset at which epoch 0 starts
    """

    durations: np.ndarray
    arrivals: Dict[str, np.ndarray]
    setup_time: float = 0.0
    t0: float = 0.0


@runtime_checkable
class Strategy(Protocol):
    """Pluggable federated-training scheme (see module docstring)."""

    label: str

    def plan(self, fleet: "FleetSpec", data: TrainData) -> Any:
        """One-time host-side setup; returns the strategy state."""
        ...

    def sample_epochs(self, state: Any, fleet: "FleetSpec", epochs: int,
                      rng: np.random.Generator) -> EpochSchedule:
        """Pre-sample every epoch's delays/arrival masks (NumPy, host)."""
        ...

    def device_state(self, state: Any,
                     data: TrainData) -> Dict[str, torch.Tensor]:
        """Per-run device-resident operands, including the strategy's
        preferred layout of the training data."""
        ...

    def round_contributions(self, state: Any, dev: Dict[str, torch.Tensor],
                            beta: torch.Tensor,
                            arrivals: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One epoch's combined gradient estimate (no host sync)."""
        ...

    def uplink_bits(self, state: Any, fleet: "FleetSpec",
                    epochs: int) -> float:
        """Total device->server bits for a run of `epochs` epochs."""
        ...

    # Optional hooks (looked up with getattr, not part of the protocol):
    #   * report_extras(state) -> dict: knobs and diagnostics copied onto
    #     TraceReport.extras;
    #   * plan_with(fleet, data, plan) -> state: `plan` with a pre-solved
    #     redundancy plan (None: solve);
    #   * tiered_contributions(state, dev, beta, arrivals, tier_masks) ->
    #     ((T, d) tier partials, optional (d,) server term): the
    #     hierarchical form of `round_contributions` that
    #     `fleet.HierarchicalCFL` consumes.  Each partial is the
    #     full-width masked gemv (`aggregation.tier_reduce`), and the
    #     server term (parity gradients) bypasses the tiers, so
    #     `cross_tier_combine(partials) + server` equals
    #     `round_contributions` bit for bit for one all-ones tier.


# ---------------------------------------------------------------------------
# Uncoded synchronous FL
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UncodedState:
    loads: np.ndarray  # (n,) full local dataset size per client


@dataclasses.dataclass(frozen=True)
class UncodedFL:
    """Synchronous uncoded FL: every epoch waits for all n clients (Eq. 2)."""

    label: str = "uncoded"
    grad_path: str = aggregation.FUSED

    def plan(self, fleet: "FleetSpec", data: TrainData) -> UncodedState:
        return UncodedState(loads=np.full(data.n, data.ell))

    def sample_epochs(self, state: UncodedState, fleet: "FleetSpec",
                      epochs: int, rng: np.random.Generator) -> EpochSchedule:
        durations = np.empty(epochs)
        # per-epoch host loop keeps the reference's generator draw order
        for e in range(epochs):
            t_i = sample_total(fleet.edge, state.loads, rng)
            durations[e] = float(np.max(t_i))  # wait for all stragglers
        return EpochSchedule(durations=durations,
                             arrivals={"epoch": np.zeros(epochs, np.float32)})

    def device_state(self, state: UncodedState,
                     data: TrainData) -> Dict[str, torch.Tensor]:
        return {"x": data.xs.reshape(data.m, data.d),
                "y": data.ys.reshape(data.m)}

    def round_contributions(self, state, dev, beta, arrivals):
        # exact full gradient (Eq. 2); the fused path runs the round
        # gradient kernel with w = 1
        return aggregation.round_gradient(
            dev["x"], dev["y"], beta,
            path=aggregation.resolve_grad_path(self.grad_path))

    def tiered_contributions(self, state, dev, beta, arrivals, tier_masks):
        # (T, d) tier partials of the full gradient; no server-side term
        return aggregation.tiered_round_gradient(
            dev["x"], dev["y"], beta, None, tier_masks,
            path=aggregation.resolve_grad_path(self.grad_path)), None

    def uplink_bits(self, state: UncodedState, fleet: "FleetSpec",
                    epochs: int) -> float:
        return epochs * state.loads.shape[0] * 2 * fleet.packet_bits


# ---------------------------------------------------------------------------
# Coded Federated Learning (the paper's protocol)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CodedFL:
    """CFL (paper §III): deadline t*, systematic + parity gradients.

    key:        int seed of the `torch.Generator` (on the data's device)
                that draws the clients' private generator matrices
    fixed_c:    force the coding redundancy (delta-sweep mode) instead of
                running the Eq. 14-16 optimization
    c_up:       cap on the server's parity budget
    include_upload_delay: charge the one-time parity upload to the clock
    server_always_returns: ablation — parity gradient always lands
    use_kernel: route the one-time parity encode through the encode
                kernel; also forces grad_path "fused", as in the reference
    redundancy_plan: pre-solved `RedundancyPlan`; `plan` then only encodes
    grad_path:  "fused" (default — packed one-pass round gradient, Gram
                parity) or "reference" (the two-pass expressions)
    """

    key: int
    fixed_c: Optional[int] = None
    c_up: Optional[int] = None
    include_upload_delay: bool = True
    server_always_returns: bool = False
    use_kernel: bool = False
    generator: str = "normal"
    label: str = "cfl"
    redundancy_plan: Optional[RedundancyPlan] = None
    grad_path: str = aggregation.FUSED

    def _grad_path(self) -> str:
        return aggregation.resolve_grad_path(self.grad_path,
                                             self.use_kernel)

    def plan(self, fleet: "FleetSpec", data: TrainData) -> cfl.CFLState:
        """Solve the redundancy plan (unless `redundancy_plan` is given)
        and run the one-time encode on the data's device."""
        return self.plan_with(fleet, data, self.redundancy_plan)

    def plan_with(self, fleet: "FleetSpec", data: TrainData,
                  plan: Optional[RedundancyPlan]) -> cfl.CFLState:
        """`plan` with the redundancy solve already done (None: solve)."""
        return cfl.setup(self.key, data.xs, data.ys, fleet.edge, fleet.server,
                         fixed_c=self.fixed_c, c_up=self.c_up,
                         generator=self.generator, use_kernel=self.use_kernel,
                         plan=plan)

    def sample_epochs(self, state: cfl.CFLState, fleet: "FleetSpec",
                      epochs: int, rng: np.random.Generator) -> EpochSchedule:
        plan = state.plan
        n = fleet.edge.n
        t_star = plan.t_star

        # one-time parity upload, drawn FIRST (the reference's order)
        upload_time = cfl.sample_parity_upload_time(state, fleet, rng)

        received = np.empty((epochs, n), dtype=np.float32)
        parity_ok = np.empty(epochs, dtype=np.float32)
        for e in range(epochs):
            t_i = sample_total(fleet.edge, plan.loads, rng)
            received[e] = (t_i <= t_star) & (plan.loads > 0)
            if self.server_always_returns or state.c == 0:
                parity_ok[e] = 1.0
            else:
                t_srv = sample_total(fleet.server, np.array([state.c]), rng)[0]
                parity_ok[e] = float(t_srv <= t_star)

        return EpochSchedule(
            durations=np.full(epochs, t_star),
            arrivals={"received": received, "parity_ok": parity_ok},
            setup_time=upload_time,
            t0=upload_time if self.include_upload_delay else 0.0)

    def device_state(self, state: cfl.CFLState,
                     data: TrainData) -> Dict[str, torch.Tensor]:
        if self._grad_path() == aggregation.FUSED:
            return cfl.fused_coded_device_state(state, data)
        return cfl.coded_device_state(state, data)

    def round_contributions(self, state, dev, beta, arrivals):
        if self._grad_path() == aggregation.FUSED:
            # fused layout (packed support or dense fallback): the base
            # row weight carries the load support, parity is Gram-folded
            x, y, w0, client = aggregation.fused_sys_block(dev)
            w = w0 * arrivals["received"][client]
            if state.c == 0:
                return aggregation.round_gradient(
                    x, y, beta, w=w, path=aggregation.FUSED)
            return aggregation.fused_coded_gradient(
                dev, w, arrivals["parity_ok"], beta)
        resid = dev["x"] @ beta - dev["y"]
        # row weight = (point within client's systematic load) AND
        # (client's partial gradient arrived by t*)
        w = dev["w_sys"] * arrivals["received"][dev["row_client"]]
        g_sys = (resid * w) @ dev["x"]
        if state.c == 0:  # delta = 0 degenerates to uncoded FL w/ deadline
            return g_sys
        g_par = aggregation.parity_gradient(
            dev["x_parity"], dev["y_parity"], beta, use_kernel=False)
        return g_sys + arrivals["parity_ok"] * g_par

    def tiered_contributions(self, state, dev, beta, arrivals, tier_masks):
        # systematic partials reduce per edge tier; the parity gradient is
        # computed AT the server, so it rides as the server-side term and
        # bypasses the tier stage
        if self._grad_path() == aggregation.FUSED:
            x, y, w0, client = aggregation.fused_sys_block(dev)
            masks = aggregation.fused_tier_masks(dev, tier_masks)
            w = w0 * arrivals["received"][client]
            partials = aggregation.tiered_round_gradient(
                x, y, beta, w, masks, path=aggregation.FUSED)
            if state.c == 0:
                return partials, None
            g_par = aggregation.gram_parity_gradient(
                dev["par_gram"], dev["par_gramy"], beta, dev["par_c"])
            return partials, arrivals["parity_ok"] * g_par
        resid = dev["x"] @ beta - dev["y"]
        w = dev["w_sys"] * arrivals["received"][dev["row_client"]]
        partials = aggregation.tier_reduce(resid * w, dev["x"], tier_masks)
        if state.c == 0:
            return partials, None
        g_par = aggregation.parity_gradient(
            dev["x_parity"], dev["y_parity"], beta, use_kernel=False)
        return partials, arrivals["parity_ok"] * g_par

    def uplink_bits(self, state: cfl.CFLState, fleet: "FleetSpec",
                    epochs: int) -> float:
        return cfl.coded_uplink_bits(state, fleet, epochs)
