"""Hierarchical edge -> cloud aggregation at fleet scale (counterpart of
`repro.fleet`).

  * `FleetTopology` — tier assignment and per-tier participation;
  * `HierarchicalCFL` — the two-stage wrapper strategy, with the tier
    aggregation `tier_reduce` / `cross_tier_combine`;
  * `solve_fleet` — the redundancy solve for fleets too large for the
    batched planner's `(t_grid, n, L)` tensor, chunk-streamed on one
    device;
  * `encode_fleet_tiered` — composite-parity encoding tier by tier
    through the in-kernel-generator encode kernel;
  * `sample_tier_rounds` — round scheduling at O(participants) cost.
"""
from .aggregate import cross_tier_combine, tier_reduce
from .encode import encode_fleet_tiered
from .hierarchical import HierarchicalCFL, HierState
from .plan import solve_fleet
from .rounds import TierRoundStats, sample_tier_rounds
from .topology import FleetTopology

__all__ = ["FleetTopology", "HierarchicalCFL", "HierState", "solve_fleet",
           "encode_fleet_tiered", "tier_reduce", "cross_tier_combine",
           "sample_tier_rounds", "TierRoundStats"]
