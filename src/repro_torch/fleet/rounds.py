"""Fleet-scale round scheduling: O(participants) per round.

A NumPy copy of `repro/fleet/rounds.py` over the port's
`core.delay_model.sample_total`: the same draws in the same order, so
the statistics are bit-equal for the same `np.random.Generator`.

The epoch engine pre-samples a DENSE (epochs, n) arrival tensor — the
right substrate for training traces, but linear in fleet size per round.
A production scheduler over 1e5+ clients with per-tier subsampling only
ever touches the sampled participants: `sample_tier_rounds` draws, per
round and per tier, a Binomial participant count, picks that many member
indices, and samples delays for THOSE devices only — so the per-round
cost is O(expected participants), independent of n.  This is the
sublinearity `benchmarks/perf_fleet.py` gates and `chip_smoke.py`
checks (wall time at a fixed round budget growing far slower than the
fleet).

Semantics notes (this is the scheduling/wall-clock path, not the
gradient path — the training engine's unbiased IP-weighted gates live in
`FleetTopology.sample_gates`):

  * participant indices are drawn WITH replacement within a tier
    (duplicates collapse; at sample_frac << 1 collisions are rare) —
    that is what keeps selection O(k) instead of O(n_tier);
  * a tier with sample_frac == 1 always includes all members;
  * round duration = max over tiers of the tier's straggler maximum
    (each edge node waits for its own slowest sampled client; the cloud
    waits for the slowest edge node).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.delay_model import DeviceDelayParams, sample_total

from .topology import FleetTopology


@dataclasses.dataclass(frozen=True)
class TierRoundStats:
    """Per-round scheduling statistics for a hierarchical fleet.

    durations:    (epochs,) round wall time (slowest tier's straggler)
    tier_max:     (epochs, T) per-tier straggler maximum (0 where a tier
                  sampled no participants)
    participants: (epochs, T) sampled participant counts per tier
    """

    durations: np.ndarray
    tier_max: np.ndarray
    participants: np.ndarray

    @property
    def total_participants(self) -> int:
        return int(self.participants.sum())


def sample_tier_rounds(topology: FleetTopology, edge: DeviceDelayParams,
                       loads: np.ndarray, epochs: int,
                       rng: np.random.Generator) -> TierRoundStats:
    """Sample `epochs` hierarchical rounds at O(participants) cost.

    topology: tier partition + per-tier sample_frac
    edge:     (n,) device delay parameters
    loads:    (n,) per-device assigned loads (e.g. `RedundancyPlan.loads`)
    """
    if edge.n != topology.n:
        raise ValueError(
            f"topology covers {topology.n} clients but edge params "
            f"describe {edge.n}")
    loads = np.asarray(loads)
    if loads.shape != (topology.n,):
        raise ValueError(
            f"loads must have shape ({topology.n},), got {loads.shape}")

    members = topology.tier_members()
    n_tiers = topology.n_tiers
    tier_max = np.zeros((epochs, n_tiers))
    participants = np.zeros((epochs, n_tiers), dtype=np.int64)

    for e in range(epochs):
        for t, mem in enumerate(members):
            frac = float(topology.sample_frac[t])
            if frac >= 1.0:
                idx = mem
            else:
                k = int(rng.binomial(mem.size, frac))
                if k == 0:
                    continue
                # with-replacement pick keeps selection O(k), not O(n_tier)
                idx = mem[rng.integers(0, mem.size, size=k)]
            sub = DeviceDelayParams(a=edge.a[idx], mu=edge.mu[idx],
                                    tau=edge.tau[idx], p=edge.p[idx])
            delays = sample_total(sub, loads[idx], rng)
            tier_max[e, t] = float(delays.max(initial=0.0))
            participants[e, t] = idx.size

    return TierRoundStats(durations=tier_max.max(axis=1),
                          tier_max=tier_max, participants=participants)
