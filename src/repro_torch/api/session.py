"""`Session`: runs one strategy over one fleet (counterpart of
`repro/api/session.py`: `make_epoch_step` and `Session.run`).

The strategy pre-samples every epoch's delays and arrivals on the host
(NumPy, in the reference's draw order); `Session.run` moves them to the
device once and runs the epoch loop there: gradient round, GD update
(Eq. 3), NMSE.  β, the arrival tensors and the NMSE trace stay on the
device, and nothing inside the loop reads a value back to the host — no
`.item()`, no `.cpu()` — so the host only enqueues work.  The run syncs
once, at the end, to fetch the trace.  The reference's `lax.scan`
becomes this Python loop; CUDA graphs and the sweep engine are later
work.

    fleet   = paper_fleet(0.2, 0.2, seed=0)
    data    = TrainData.linreg(0, n=24, ell=300, d=500)   # on the card
    session = Session(strategy=CodedFL(key=1, fixed_c=2016),
                      fleet=fleet, lr=0.0085, epochs=600)
    report  = session.run(data)          # -> TraceReport
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.device import resolve_device

from .report import TraceReport
from .strategy import EpochSchedule, Strategy, TrainData

if TYPE_CHECKING:
    from repro_torch.sim.network import FleetSpec


def make_epoch_step(strategy: Strategy, state: Any, m: int) -> Callable:
    """Build the per-epoch training program for one strategy state.

    Returns `step(beta, dev, lr, beta_true, arr_t) -> (beta', nmse')`:
    one gradient round (`round_contributions`), one GD update (Eq. 3),
    one NMSE probe — all tensors, no host sync."""

    def step(beta: torch.Tensor, dev: Dict[str, torch.Tensor],
             lr: torch.Tensor, beta_true: torch.Tensor,
             arr_t: Dict[str, torch.Tensor]) -> tuple:
        g = strategy.round_contributions(state, dev, beta, arr_t)
        beta = aggregation.gd_update(beta, g, lr, m)
        return beta, aggregation.nmse(beta, beta_true)

    return step


@dataclasses.dataclass
class Session:
    """Runs one strategy over one fleet with an on-device epoch loop.

    strategy: the coding scheme (UncodedFL / CodedFL / any user Strategy)
    fleet:    delay + link parameters of the simulated fleet
    lr:       GD step size (Eq. 3)
    epochs:   number of training epochs per run
    seed:     default NumPy seed for delay sampling when `run` is not
              handed an explicit generator
    device:   where the run executes (None: the CUDA device, which must
              exist); `run` requires the data to live there
    """

    strategy: Strategy
    fleet: "FleetSpec"
    lr: float
    epochs: int
    seed: int = 0
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.epochs < 0:
            raise ValueError(f"epochs must be >= 0, got {self.epochs}")
        self.device = resolve_device(self.device)

    def plan(self, data: TrainData):
        """Run the strategy's one-time setup."""
        return self.strategy.plan(self.fleet, data)

    def run(self, data: TrainData,
            rng: Optional[np.random.Generator] = None,
            label: Optional[str] = None, state=None) -> TraceReport:
        """Plan (unless a pre-planned `state` is given), pre-sample, and
        execute the full training trace on the session's device."""
        if data.device != self.device:
            raise ValueError(f"data lives on {data.device}, the session "
                             f"runs on {self.device}")
        if rng is None:
            rng = np.random.default_rng(self.seed)
        if state is None:
            state = self.strategy.plan(self.fleet, data)
        sched: EpochSchedule = self.strategy.sample_epochs(
            state, self.fleet, self.epochs, rng)
        dev = self.strategy.device_state(state, data)
        nmse_trace, beta = self._train(state, dev, sched, data)
        times = sched.t0 + np.concatenate([[0.0], np.cumsum(sched.durations)])
        # optional hook: strategy knobs and diagnostics for the report
        extras_fn = getattr(self.strategy, "report_extras", None)
        return TraceReport(
            times=times,
            nmse=nmse_trace,
            epoch_durations=np.asarray(sched.durations),
            label=label if label is not None else self.strategy.label,
            setup_time=sched.setup_time,
            uplink_bits_total=self.strategy.uplink_bits(
                state, self.fleet, self.epochs),
            extras=dict(extras_fn(state)) if extras_fn is not None else {},
            beta=beta)

    def _train(self, state, dev, sched: EpochSchedule,
               data: TrainData) -> tuple[np.ndarray, np.ndarray]:
        """The epoch loop: device-resident from the first epoch to the one
        sync that fetches the ((epochs+1,) NMSE trace, final beta)."""
        arrivals = {k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in sched.arrivals.items()}
        dtype = data.xs.dtype
        lr = torch.tensor(self.lr, dtype=dtype, device=self.device)
        beta = torch.zeros(data.model_dim, dtype=dtype, device=self.device)
        trace = torch.empty(self.epochs + 1, dtype=dtype, device=self.device)
        trace[0] = aggregation.nmse(beta, data.beta_true)
        step = make_epoch_step(self.strategy, state, data.m)
        for e in range(self.epochs):
            arr_t = {k: v[e] for k, v in arrivals.items()}
            beta, trace[e + 1] = step(beta, dev, lr, data.beta_true, arr_t)
        return trace.cpu().numpy(), beta.cpu().numpy()
