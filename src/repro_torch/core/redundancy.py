"""Two-step coding-redundancy optimization (paper §III-B, Eqs. 14-16).

Given delay parameters for n edge devices + the central server (device n+1),
find:

  * per-device systematic loads  ell*_i(t*)   (points each device processes),
  * the epoch deadline           t*,
  * the coding redundancy        c = ell*_{n+1}(t*)  (parity rows the server
    processes each epoch == row dimension of every client generator matrix).

t* = argmin_t { m <= E[R(t; ell*(t))] <= m + eps }  (Eq. 16); the aggregate
expected return E[R] = sum_i ell*_i(t) Pr{T_i <= t} is nondecreasing in t.

The module also supports a *fixed redundancy* mode used by the paper's Fig. 2
and Fig. 5 sweeps: given c (equivalently delta = c/m), cap the server load at
c and solve only for t*.

`solve_redundancy` is a thin single-fleet shim over the port's grid solver
(`repro_torch.plan.solver`, torch on the device).  `RedundancyPlan` and
`systematic_weights` are NumPy copies of `repro/core/redundancy.py`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .delay_model import DeviceDelayParams


@dataclasses.dataclass(frozen=True)
class RedundancyPlan:
    """Output of the two-step optimization.

    loads:           (n,) systematic points each edge device processes/epoch
    c:               parity rows processed by the server per epoch
                     (coding redundancy)
    t_star:          epoch deadline in seconds
    p_return:        (n+1,) Pr{T_i <= t*} at the optimized loads (server last)
    expected_agg:    aggregate expected return at t* (should be ~ m)
    loads_cap_total: m = total edge-resident points (the delta denominator)
    """

    loads: np.ndarray
    c: int
    t_star: float
    p_return: np.ndarray
    expected_agg: float
    loads_cap_total: int

    @property
    def delta(self) -> float:
        """Redundancy metric delta = c / m over the edge devices' total data."""
        if self.loads_cap_total <= 0:
            raise ValueError(
                "delta is undefined: loads_cap_total must be the positive "
                f"total edge dataset size m, got {self.loads_cap_total}")
        return float(self.c) / float(self.loads_cap_total)


def _fleet_with_server(edge: DeviceDelayParams,
                       server: DeviceDelayParams) -> DeviceDelayParams:
    if server.n != 1:
        raise ValueError("server params must describe exactly one device")
    return DeviceDelayParams(
        np.concatenate([edge.a, server.a]),
        np.concatenate([edge.mu, server.mu]),
        np.concatenate([edge.tau, server.tau]),
        np.concatenate([edge.p, server.p]),
    )


def solve_redundancy(edge: DeviceDelayParams, server: DeviceDelayParams,
                     data_sizes: np.ndarray, c_up: int | None = None,
                     eps_rel: float = 1e-3, t_hi: float | None = None,
                     fixed_c: int | None = None,
                     device=None) -> RedundancyPlan:
    """Run the two-step optimization for ONE fleet (shim over
    `repro_torch.plan`).

    edge:       delay params of the n client devices
    server:     delay params of the central server (tau=0: no comm leg)
    data_sizes: (n,) local dataset sizes ell_i
    c_up:       max parity rows the server may receive (default: m)
    fixed_c:    if given, skip the redundancy search and use exactly this c
                (delta-sweep mode for Fig. 2 / Fig. 5); the server cap is
                fixed_c and the target return stays m.
    device:     where the grid solve runs (None: the CUDA device)
    """
    from repro_torch.plan.solver import PlanRequest, solve_redundancy_batched
    req = PlanRequest(edge=edge, server=server, data_sizes=data_sizes,
                      c_up=c_up, fixed_c=fixed_c, t_hi=t_hi)
    return solve_redundancy_batched([req], eps_rel=eps_rel,
                                    device=device)[0]


def systematic_weights(plan: RedundancyPlan, data_sizes: np.ndarray) -> list[np.ndarray]:
    """Per-device diagonal weight vectors (Eq. 17).

    For device i: the first ell*_i points (the ones it will process) get
    w = sqrt(Pr{T_i >= t*}); the remaining (punctured) points get w = 1.
    Returns a list of (ell_i,) arrays — devices may have unequal data sizes.
    """
    data_sizes = np.asarray(data_sizes, dtype=np.int64)
    out = []
    for i, ell_i in enumerate(data_sizes):
        w = np.ones(int(ell_i), dtype=np.float64)
        k = int(plan.loads[i])
        w[:k] = np.sqrt(max(0.0, 1.0 - plan.p_return[i]))
        out.append(w)
    return out
