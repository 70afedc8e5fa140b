"""Hierarchical edge -> cloud aggregation (counterpart of `repro.fleet`).

Ported so far: `FleetTopology` (tier assignment and per-tier
participation), `HierarchicalCFL` (the two-stage wrapper strategy) and
the tier aggregation (`tier_reduce`, `cross_tier_combine`).  Still to
port (ROADMAP item 10): `solve_fleet`, `encode_fleet_tiered` (with the
in-kernel-generator encode) and `sample_tier_rounds`.
"""
from .aggregate import cross_tier_combine, tier_reduce
from .hierarchical import HierarchicalCFL, HierState
from .topology import FleetTopology

__all__ = ["FleetTopology", "HierarchicalCFL", "HierState", "tier_reduce",
           "cross_tier_combine"]
