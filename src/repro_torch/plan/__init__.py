"""Batched redundancy planning (paper §III-B) on the device.

`solve_redundancy_batched` evaluates the `(t_grid, n, L)` expected-return
tensor in torch and plans a batch of fleets per call; `PlanRequest`
describes one fleet and parity budget.  Single-fleet callers use the shim
`core.redundancy.solve_redundancy`.
"""
from .solver import (GRID_POINTS, MAX_DOUBLINGS, MAX_ROUNDS, PlanRequest,
                     solve_redundancy_batched)

__all__ = ["PlanRequest", "solve_redundancy_batched", "GRID_POINTS",
           "MAX_ROUNDS", "MAX_DOUBLINGS"]
