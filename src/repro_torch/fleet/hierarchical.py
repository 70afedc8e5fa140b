"""`HierarchicalCFL` — the two-stage edge -> cloud wrapper strategy
(counterpart of `repro/fleet/hierarchical.py`).

Wraps any strategy implementing the `tiered_contributions` hook
(`UncodedFL`, `CodedFL`, `GradientCodingFL`, `StochasticCodedFL`,
`LowLatencyCFL`, `CodedFedL`) and runs its gradient round
hierarchically over a `FleetTopology`:

  1. **edge stage** — per-tier weighted reduce: each tier partial is the
     full-width masked contraction (on the card and the fused path, one
     launch of the tier-masked round-gradient kernel for all T tiers);
  2. **cloud stage** — `cross_tier_combine` sums the T tier partials in
     order (the only reassociation the hierarchy adds) and adds the
     wrapped strategy's server-side term (parity gradients live at the
     server and never traverse an edge tier).

Per-round client subsampling rides on the same path: the topology's
inverse-probability gates (`FleetTopology.sample_gates`) multiply into the
tier masks, and at `sample_frac == 1` the gates are exactly 1.0 and no
gate is drawn, so a single-tier topology gives the base strategy's flat
trace bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, ClassVar, Dict, Hashable

import numpy as np
import torch

from repro_torch.api.session import _static_strategy_key
from repro_torch.api.strategy import EpochSchedule, TrainData
from repro_torch.core.aggregation import cross_tier_combine

from .topology import FleetTopology

if TYPE_CHECKING:
    from repro_torch.sim.network import FleetSpec


@dataclasses.dataclass
class HierState:
    """The wrapped strategy's state plus the (validated) topology."""

    base: Any
    topology: FleetTopology


# Optional hooks forwarded verbatim to the wrapped strategy WHEN it has
# them, so `hasattr` on the wrapper mirrors `hasattr` on the base — the
# capability check `api.plan_sweep` keys on.  (`plan_with` is a real
# method below: it must re-wrap the base state in a HierState.)
_FORWARDED = frozenset({"plan_request", "redundancy_plan"})


@dataclasses.dataclass(frozen=True)
class HierarchicalCFL:
    """Hierarchical edge -> cloud wrapper around a tiered-capable strategy.

    base:     the wrapped strategy; must implement `tiered_contributions`
    topology: tier assignment + per-tier participation (`FleetTopology`)
    label:    display label (default: "hier[<base label>]")
    """

    base: Any
    topology: FleetTopology
    label: str = ""

    # the wrapper adds no primitive knobs of its own; its static identity
    # (base structure + tier structure) is carried by `engine_key`
    engine_value_fields: ClassVar[frozenset] = frozenset()

    def __post_init__(self):
        if not hasattr(self.base, "tiered_contributions"):
            raise TypeError(
                f"{type(self.base).__name__} does not implement the "
                "tiered_contributions hook and cannot run hierarchically")
        if not isinstance(self.topology, FleetTopology):
            raise TypeError(
                f"topology must be a FleetTopology, got "
                f"{type(self.topology).__name__}")
        if not self.label:
            object.__setattr__(self, "label", f"hier[{self.base.label}]")

    def __getattr__(self, name: str):
        if name in _FORWARDED:
            return getattr(object.__getattribute__(self, "base"), name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    # -- planning -----------------------------------------------------------

    def _check_fleet(self, n: int) -> None:
        if self.topology.n != n:
            raise ValueError(
                f"topology covers {self.topology.n} clients but the fleet "
                f"has {n}")

    def plan(self, fleet: "FleetSpec", data: TrainData) -> HierState:
        self._check_fleet(data.n)
        return HierState(base=self.base.plan(fleet, data),
                         topology=self.topology)

    def plan_with(self, fleet: "FleetSpec", data: TrainData,
                  plan) -> HierState:
        """Wrap the base's state for a pre-solved redundancy plan."""
        self._check_fleet(data.n)
        return HierState(base=self.base.plan_with(fleet, data, plan),
                         topology=self.topology)

    # -- epoch sampling -----------------------------------------------------

    def sample_epochs(self, state: HierState, fleet: "FleetSpec",
                      epochs: int, rng: np.random.Generator) -> EpochSchedule:
        """Base draws FIRST, then the participation gates — so at
        `sample_frac == 1` (no gate draws) the generator stream is the
        base strategy's exactly.  Durations remain the base's."""
        sched = self.base.sample_epochs(state.base, fleet, epochs, rng)
        arrivals = dict(sched.arrivals)
        arrivals["tier_gate"] = state.topology.sample_gates(epochs, rng)
        return dataclasses.replace(sched, arrivals=arrivals)

    def sweep_inputs(self, state: HierState, fleet: "FleetSpec",
                     epochs: int, rng: np.random.Generator) -> EpochSchedule:
        """One sweep lane's inputs: the base lane's plus the `(epochs, n)`
        gate tensor; draws are exactly `sample_epochs`."""
        sample = getattr(self.base, "sweep_inputs", self.base.sample_epochs)
        sched = sample(state.base, fleet, epochs, rng)
        arrivals = dict(sched.arrivals)
        arrivals["tier_gate"] = state.topology.sample_gates(epochs, rng)
        return dataclasses.replace(sched, arrivals=arrivals)

    # -- epoch hooks --------------------------------------------------------

    @property
    def data_device_keys(self) -> frozenset:
        """The base's data-only operands plus the wrapper's row -> client
        index (a function of the data's shape).  `tier_masks` comes from
        the topology and stays per lane."""
        base_keys = getattr(self.base, "data_device_keys", frozenset())
        return frozenset(base_keys) | {"hier_row_client"}

    def device_state(self, state: HierState,
                     data: TrainData) -> Dict[str, torch.Tensor]:
        dev = dict(self.base.device_state(state.base, data))
        dev["tier_masks"] = torch.as_tensor(
            state.topology.tier_masks(data.ell), device=data.device
        ).to(data.xs.dtype)
        dev["hier_row_client"] = torch.arange(
            data.n, device=data.device).repeat_interleave(data.ell)
        return dev

    def round_contributions(self, state: HierState,
                            dev: Dict[str, torch.Tensor], beta: torch.Tensor,
                            arrivals: Dict[str, torch.Tensor]) -> torch.Tensor:
        # fold the per-client gates into the tier masks (exact at
        # sample_frac == 1: every gate is 1.0), run the base's tiered
        # round, and combine the edge partials at the cloud
        gate = arrivals["tier_gate"][dev["hier_row_client"]]      # (m,)
        masks = dev["tier_masks"] * gate[None, :]                 # (T, m)
        partials, server = self.base.tiered_contributions(
            state.base, dev, beta, arrivals, masks)
        out = cross_tier_combine(partials)
        if server is not None:
            out = out + server
        return out

    def engine_key(self, state: HierState) -> Hashable:
        """The wrapper's own fields are not primitive, so the module-level
        static key sees only the class: the base's whole static structure,
        its own engine key and the tier structure go here, so hierarchies
        over different bases or tier counts never share an engine."""
        return ("hier", _static_strategy_key(self.base),
                self.base.engine_key(state.base),
                self.topology.structure_key())

    def uplink_bits(self, state: HierState, fleet: "FleetSpec",
                    epochs: int) -> float:
        return self.base.uplink_bits(state.base, fleet, epochs)

    def serve_convergence(self, state: HierState, criterion):
        """The base's serving hook, on the base's state."""
        hook = getattr(self.base, "serve_convergence", None)
        return criterion if hook is None else hook(state.base, criterion)

    def report_extras(self, state: HierState) -> Dict[str, Any]:
        """The base's extras plus the tier structure."""
        extras_fn = getattr(self.base, "report_extras", None)
        extras = dict(extras_fn(state.base)) if extras_fn is not None else {}
        topo = state.topology
        extras["n_tiers"] = int(topo.n_tiers)
        extras["tier_sample_frac_min"] = float(topo.sample_frac.min())
        extras["expected_participants"] = float(
            np.sum(topo.sample_frac[topo.tier_of]))
        return extras
