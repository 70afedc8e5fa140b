"""Stochastic Coded Federated Learning (counterpart of
`repro/schemes/stochastic.py`; arXiv:2201.10092 on the source paper's
linear-regression and §II-A delay substrate).

SCFL's two departures from the base CFL protocol:

  1. **Privacy noise on the shared coded dataset.**  The composite parity
     is uploaded as (X~ + N_x, y~ + n_y) with iid Gaussian noise
     calibrated to the coded data's RMS (`noise_multiplier` = noise std
     over coded-entry RMS).  The scales are computed in float64 on the
     host, the reference's expression term for term.
  2. **Per-round stochastic parity.**  Each epoch the server samples a
     Bernoulli(`sample_frac`) subset of parity rows and computes the
     inverse-probability-weighted (unbiased) parity gradient on that
     subset only.

Both discount what one parity row is worth to the aggregate expected
return, so the plan runs the port's grid solver with `srv_weight =
sample_frac / (1 + noise_multiplier^2)` (`plan.effective_srv_weight`).
Only the value is discounted; the deadline still evaluates the server at
the full parity load, so every sampled round stays feasible.

Randomness: the generator matrices and then the noise are drawn, in that
order, from one explicit `torch.Generator` (`key`: an int seed of one on
the data's device, or the generator itself).  At `noise_multiplier = 0`
no noise is drawn and the parity equals `CodedFL`'s for the same key.
The one-time encode runs through the encode kernel's wrapper (the
kernel on the card, its plain version on the CPU).

On the fused gradient path at `sample_frac < 1` the systematic and
parity row streams share one launch of the coded round-gradient kernel,
the 1/(c*rho) normalization folded into the parity row weights; at
`sample_frac == 1` the parity term is Gram-folded as in `CodedFL`.

Privacy accounting (`repro_torch.privacy`): construct by budget —
`StochasticCodedFL(key=..., epsilon_target=2.0, delta=1e-5, rounds=600)`
— and the smallest adequate `noise_multiplier` is calibrated at
construction (`privacy.calibrate_noise`, float64 on `device`); or set
`noise_multiplier` and pass `rounds=` to have the spend priced.  Either
way `report_extras` carries the cumulative per-round `epsilon_schedule`
and the composed `epsilon_spent`, the reference's schema.  Each training
round is one release of a Poisson-subsampled Gaussian mechanism at
`(noise_multiplier, sample_frac)`.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Any, ClassVar, Dict, Hashable, Optional,
                    Union)

import numpy as np
import torch

from repro_torch.api.strategy import EpochSchedule, TrainData
from repro_torch.core import aggregation, encoding
from repro_torch.core.delay_model import sample_total
from repro_torch.core.redundancy import RedundancyPlan, systematic_weights
from repro_torch.plan import (PlanRequest, effective_srv_weight,
                              solve_redundancy_batched)
from repro_torch.privacy import calibrate_noise, epsilon_schedule

from .base import (CodedSchemeState, coded_device_state, coded_uplink_bits,
                   fused_coded_device_state, sample_parity_upload_time)

if TYPE_CHECKING:
    from repro_torch.sim.network import FleetSpec


@dataclasses.dataclass
class StochasticState(CodedSchemeState):
    """`CodedSchemeState` + the calibrated noise actually injected."""

    noise_scale_x: float
    noise_scale_y: float
    srv_weight: float


def noise_scales(xs: np.ndarray, ys: np.ndarray, weights: np.ndarray,
                 noise_multiplier: float) -> tuple[float, float]:
    """Per-entry noise stds calibrated to the coded dataset's RMS, float64
    on the host: `noise_multiplier` times the RMS over columns of the
    coded entries' std (sum over clients and rows of w^2 x^2), and of the
    label column's.  xs (n, ell, d), ys (n, ell), weights (n, ell)."""
    d = xs.shape[-1]
    w2 = np.asarray(weights, dtype=np.float64) ** 2
    xs64 = np.asarray(xs, dtype=np.float64)
    ys64 = np.asarray(ys, dtype=np.float64)
    scale_x = noise_multiplier * float(
        np.sqrt(np.sum(w2[..., None] * xs64 ** 2) / d))
    scale_y = noise_multiplier * float(np.sqrt(np.sum(w2 * ys64 ** 2)))
    return scale_x, scale_y


@dataclasses.dataclass(frozen=True)
class StochasticCodedFL:
    """SCFL: noisy shared parity + per-round stochastic parity sampling.

    key:              int seed of the `torch.Generator` (on the data's
                      device) that draws the generator matrices and then
                      the privacy noise, or that generator itself
    noise_multiplier: privacy-noise std relative to the coded data's RMS
                      (0 = no noise); defaults to 0.5 when neither it nor
                      `epsilon_target` is given
    sample_frac:      per-round Bernoulli parity-row sampling probability
                      (1 = every row every round, with no extra draws
                      from the epoch generator)
    fixed_c / c_up / include_upload_delay / generator: as in `CodedFL`
    redundancy_plan:  pre-solved plan; `plan` then only encodes
    epsilon_target:   (epsilon, delta)-DP budget to train within; the
                      noise multiplier is then calibrated at construction
                      (requires `rounds`)
    delta:            DP delta for accounting and calibration
    rounds:           accounting horizon (training rounds composed); when
                      set, `report_extras` prices the run
    grad_path:        "fused" (default) or "reference"
    device:           where the calibration and the accounting run
                      (None: the card)
    """

    key: Union[int, torch.Generator]
    noise_multiplier: Optional[float] = None
    sample_frac: float = 1.0
    fixed_c: Optional[int] = None
    c_up: Optional[int] = None
    include_upload_delay: bool = True
    generator: str = "normal"
    label: str = "scfl"
    redundancy_plan: Optional[RedundancyPlan] = None
    epsilon_target: Optional[float] = None
    delta: float = 1e-5
    rounds: Optional[int] = None
    grad_path: str = aggregation.FUSED
    device: Optional[Union[str, torch.device]] = None

    # noise and budget knobs feed the plan, the encoded values and the DP
    # accounting report — never the epoch program — so a whole
    # noise/epsilon frontier shares ONE engine; so do the int seed `key`
    # and `device`, where the calibration and the accounting run.
    # sample_frac stays keyed: the program reads it (1/(c*rho), and the
    # coded kernel against the Gram fold).
    engine_value_fields: ClassVar[frozenset] = frozenset(
        {"key", "fixed_c", "c_up", "include_upload_delay", "generator",
         "noise_multiplier", "epsilon_target", "delta", "rounds",
         "device"})
    # data-only operands (one copy per sweep); the noised parity and the
    # load mask stay per lane
    data_device_keys: ClassVar[frozenset] = frozenset(
        {"x", "y", "row_client"})

    def __post_init__(self):
        if not (0.0 < self.sample_frac <= 1.0):
            raise ValueError(
                f"sample_frac must be in (0, 1], got {self.sample_frac}")
        if not (0.0 < self.delta < 1.0):
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if self.rounds is not None and int(self.rounds) < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.epsilon_target is not None:
            if self.rounds is None:
                raise ValueError(
                    "epsilon_target needs rounds=<training rounds>: the "
                    "budget composes over the whole run")
            sigma = float(calibrate_noise(
                self.epsilon_target, delta=self.delta, rounds=self.rounds,
                sample_frac=self.sample_frac, device=self.device))
            # noise_multiplier equal to the calibrated value is what
            # `dataclasses.replace` on a budget-built strategy passes
            if self.noise_multiplier is not None \
                    and self.noise_multiplier != sigma:
                raise ValueError(
                    "pass either epsilon_target= (calibrated noise) or "
                    "noise_multiplier= (manual noise), not both; to "
                    "recalibrate after changing the budget fields, pass "
                    "noise_multiplier=None explicitly")
            object.__setattr__(self, "noise_multiplier", sigma)
        elif self.noise_multiplier is None:
            object.__setattr__(self, "noise_multiplier", 0.5)
        if self.noise_multiplier < 0:
            raise ValueError(
                f"noise_multiplier must be >= 0, got {self.noise_multiplier}")

    def _grad_path(self) -> str:
        return aggregation.resolve_grad_path(self.grad_path)

    @property
    def srv_weight(self) -> float:
        """Effective rows per parity row: rho / (1 + sigma^2)."""
        return float(effective_srv_weight(self.noise_multiplier,
                                          self.sample_frac))

    # -- planning -----------------------------------------------------------

    def plan_request(self, fleet: "FleetSpec",
                     data: TrainData) -> PlanRequest:
        """The weighted-server redundancy problem `plan` would solve."""
        return PlanRequest(edge=fleet.edge, server=fleet.server,
                           data_sizes=np.full(data.n, data.ell,
                                              dtype=np.int64),
                           c_up=self.c_up, fixed_c=self.fixed_c,
                           srv_weight=self.srv_weight)

    def plan_with(self, fleet: "FleetSpec", data: TrainData,
                  plan: Optional[RedundancyPlan]) -> StochasticState:
        """`plan` with the redundancy solve already done (None: solve it
        on the data's device), then the noisy one-time encode."""
        dev = data.device
        if plan is None:
            plan = solve_redundancy_batched(
                [self.plan_request(fleet, data)], device=dev)[0]
        n, ell, d = data.n, data.ell, data.d
        dtype = data.xs.dtype
        w_np = np.stack(systematic_weights(plan, np.full(n, ell)))
        weights = torch.as_tensor(w_np, device=dev).to(dtype)
        load_mask = torch.as_tensor(
            np.arange(ell)[None, :] < plan.loads[:, None], device=dev
        ).to(dtype)
        scale_x, scale_y = noise_scales(data.xs.cpu().numpy(),
                                        data.ys.cpu().numpy(), w_np,
                                        self.noise_multiplier)

        if plan.c > 0:
            gen = self.key if isinstance(self.key, torch.Generator) \
                else torch.Generator(device=dev).manual_seed(int(self.key))
            x_par, y_par = encoding.encode_fleet(
                gen, data.xs, data.ys, weights, plan.c,
                kind=self.generator, use_kernel=True)
            if self.noise_multiplier > 0:
                def noise(scale, shape):
                    return torch.tensor(scale, dtype=dtype, device=dev) \
                        * torch.randn(shape, generator=gen, dtype=dtype,
                                      device=dev)
                x_par = x_par + noise(scale_x, x_par.shape)
                y_par = y_par + noise(scale_y, y_par.shape)
        else:  # c = 0 degenerates to uncoded FL with deadline t*
            x_par = torch.zeros((0, d), dtype=dtype, device=dev)
            y_par = torch.zeros((0,), dtype=dtype, device=dev)

        return StochasticState(plan=plan, load_mask=load_mask,
                               x_parity=x_par, y_parity=y_par,
                               edge=fleet.edge, server=fleet.server,
                               noise_scale_x=scale_x, noise_scale_y=scale_y,
                               srv_weight=self.srv_weight)

    def plan(self, fleet: "FleetSpec", data: TrainData) -> StochasticState:
        return self.plan_with(fleet, data, self.redundancy_plan)

    # -- epoch sampling -----------------------------------------------------

    def sample_epochs(self, state: StochasticState, fleet: "FleetSpec",
                      epochs: int, rng: np.random.Generator) -> EpochSchedule:
        """Per epoch: the clients' delays, then (c > 0) the parity-row
        sample (rho < 1 only) and the server's delay at the sampled row
        count — the reference's draw order."""
        plan = state.plan
        n = fleet.edge.n
        t_star = plan.t_star
        c = state.c
        upload_time = sample_parity_upload_time(state, fleet, rng)

        received = np.empty((epochs, n), dtype=np.float32)
        parity_mask = np.ones((epochs, c), dtype=np.float32)
        parity_ok = np.ones(epochs, dtype=np.float32)
        for e in range(epochs):
            t_i = sample_total(fleet.edge, plan.loads, rng)
            received[e] = (t_i <= t_star) & (plan.loads > 0)
            if c == 0:
                continue
            if self.sample_frac < 1.0:
                parity_mask[e] = rng.random(c) < self.sample_frac
            rows = int(parity_mask[e].sum())
            t_srv = sample_total(fleet.server, np.array([rows]), rng)[0]
            parity_ok[e] = float(t_srv <= t_star)

        return EpochSchedule(
            durations=np.full(epochs, t_star),
            arrivals={"received": received, "parity_mask": parity_mask,
                      "parity_ok": parity_ok},
            setup_time=upload_time,
            t0=upload_time if self.include_upload_delay else 0.0)

    # -- epoch hooks --------------------------------------------------------

    def device_state(self, state: StochasticState,
                     data: TrainData) -> Dict[str, torch.Tensor]:
        if self._grad_path() == aggregation.FUSED:
            # rho < 1 ships the raw parity rows in place of the Gram
            # factors: the per-round Bernoulli mask needs the rows
            return fused_coded_device_state(
                state, data, parity_rows=self.sample_frac < 1.0)
        return coded_device_state(state, data)

    def _parity_row_weights(self, dev, arrivals) -> torch.Tensor:
        """(c,) inverse-probability parity row weights with the 1/(c*rho)
        Eq.-18 divisor folded in: E[mask / rho] = 1 per row."""
        return arrivals["parity_mask"] \
            * (arrivals["parity_ok"] / (dev["par_c"] * self.sample_frac))

    def _reference_parity(self, state, dev, beta, arrivals) -> torch.Tensor:
        resid_par = dev["x_parity"] @ beta - dev["y_parity"]
        w_par = arrivals["parity_mask"] * arrivals["parity_ok"]
        return ((resid_par * w_par) @ dev["x_parity"]) \
            / (state.c * self.sample_frac)

    def round_contributions(self, state, dev, beta, arrivals):
        if self._grad_path() == aggregation.FUSED:
            x, y, w0, client = aggregation.fused_sys_block(dev)
            w = w0 * arrivals["received"][client]
            if state.c == 0:
                return aggregation.round_gradient(
                    x, y, beta, w=w, path=aggregation.FUSED)
            if self.sample_frac < 1.0:
                # systematic and parity streams share ONE kernel launch
                return aggregation.coded_round_gradient(
                    x, y, w, dev["x_parity"], dev["y_parity"],
                    self._parity_row_weights(dev, arrivals), beta,
                    path=aggregation.FUSED)
            # rho == 1: static parity, the Gram-folded Eq. 18
            return aggregation.fused_coded_gradient(
                dev, w, arrivals["parity_ok"], beta)
        resid = dev["x"] @ beta - dev["y"]
        w = dev["w_sys"] * arrivals["received"][dev["row_client"]]
        g_sys = (resid * w) @ dev["x"]
        if state.c == 0:
            return g_sys
        return g_sys + self._reference_parity(state, dev, beta, arrivals)

    def tiered_contributions(self, state, dev, beta, arrivals, tier_masks):
        """Systematic partials reduce per edge tier; the stochastic parity
        gradient is server-resident and rides as the server-side term."""
        if self._grad_path() == aggregation.FUSED:
            x, y, w0, client = aggregation.fused_sys_block(dev)
            masks = aggregation.fused_tier_masks(dev, tier_masks)
            w = w0 * arrivals["received"][client]
            partials = aggregation.tiered_round_gradient(
                x, y, beta, w, masks, path=aggregation.FUSED)
            if state.c == 0:
                return partials, None
            if self.sample_frac < 1.0:
                g_par = aggregation.round_gradient(
                    dev["x_parity"], dev["y_parity"], beta,
                    w=self._parity_row_weights(dev, arrivals),
                    path=aggregation.FUSED)
            else:  # rho == 1: the Gram-folded Eq. 18
                g_par = arrivals["parity_ok"] \
                    * aggregation.gram_parity_gradient(
                        dev["par_gram"], dev["par_gramy"], beta,
                        dev["par_c"])
            return partials, g_par
        resid = dev["x"] @ beta - dev["y"]
        w = dev["w_sys"] * arrivals["received"][dev["row_client"]]
        partials = aggregation.tier_reduce(resid * w, dev["x"], tier_masks)
        if state.c == 0:
            return partials, None
        return partials, self._reference_parity(state, dev, beta, arrivals)

    def uplink_bits(self, state: StochasticState, fleet: "FleetSpec",
                    epochs: int) -> float:
        return coded_uplink_bits(state, fleet, epochs)

    def engine_key(self, state: StochasticState) -> Hashable:
        # the program reads sample_frac (1/(c*rho)) and whether c > 0
        return (state.c > 0, float(self.sample_frac))

    def sweep_inputs(self, state: StochasticState, fleet: "FleetSpec",
                     epochs: int, rng: np.random.Generator) -> EpochSchedule:
        """One sweep lane's inputs: `received (epochs, n)`, `parity_mask
        (epochs, c)` and `parity_ok (epochs,)` (c is an operand shape, so
        mixed-c sweeps bucket apart); draws are exactly `sample_epochs`."""
        return self.sample_epochs(state, fleet, epochs, rng)

    def serve_convergence(self, state: StochasticState, criterion):
        """The serving engine's hook: epsilon-budget exhaustion.  With a
        calibrated (epsilon, delta) budget every round past the accounting
        horizon overspends the target, so the served epoch budget is
        capped at `rounds`; the lane frees its slot when the budget is
        spent."""
        if self.epsilon_target is None or self.rounds is None:
            return criterion
        cap = int(self.rounds) if criterion.max_epochs is None \
            else min(int(criterion.max_epochs), int(self.rounds))
        return dataclasses.replace(criterion, max_epochs=cap)

    def report_extras(self, state: StochasticState) -> Dict[str, Any]:
        """The privacy/accuracy knobs on every TraceReport and, with an
        accounting horizon, the composed (epsilon, delta) spend: `delta`,
        `accounting_rounds`, the cumulative `epsilon_schedule` (rounds,),
        `epsilon_spent`, and `epsilon_target` when calibrated."""
        extras = {"noise_multiplier": float(self.noise_multiplier),
                  "sample_frac": float(self.sample_frac),
                  "srv_weight": float(state.srv_weight),
                  "noise_scale_x": float(state.noise_scale_x),
                  "noise_scale_y": float(state.noise_scale_y)}
        if self.rounds is not None:
            sched = epsilon_schedule(self.noise_multiplier,
                                     self.sample_frac, self.rounds,
                                     self.delta, device=self.device)
            extras["delta"] = float(self.delta)
            extras["accounting_rounds"] = int(self.rounds)
            extras["epsilon_schedule"] = sched   # cumulative, per round
            extras["epsilon_spent"] = float(sched[-1])
            if self.epsilon_target is not None:
                extras["epsilon_target"] = float(self.epsilon_target)
        return extras
