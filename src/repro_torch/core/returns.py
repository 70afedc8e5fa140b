"""Expected-return metric and per-device load optimization (paper §III-B).

NumPy copy of `repro/core/returns.py`, bit-for-bit on the same inputs.

R_i(t; ell~) = ell~ * 1{T_i <= t}  (indicator return metric),
E[R_i(t; ell~)] = ell~ * Pr{T_i <= t},  concave in ell~ (paper Fig. 1).

Step 1 of the two-step optimization (Eqs. 14-15):

    ell*_i(t) = argmax_{0 <= ell~ <= ell_i}  E[R_i(t; ell~)]

ell~ is an integer number of training points; the per-device cap is the local
dataset size ell_i (or c_up for the server's parity budget).  Loads are small
(hundreds to a few thousand) so an exact vectorized grid search is both exact
and fast — the whole (L, n) expected-return grid is one `total_cdf` call, not
one call per integer load (the batched multi-fleet solver, on the device,
lives in `repro_torch.plan.solver`).
"""
from __future__ import annotations

import numpy as np

from .delay_model import DeviceDelayParams, total_cdf


def expected_return(params: DeviceDelayParams, ell, t) -> np.ndarray:
    """E[R_i(t; ell)] = ell * Pr{T_i <= t}, vectorized over devices and any
    leading batch of loads (scalar, (n,), or (..., n) — e.g. an (L, 1) column
    broadcasts to the full (L, n) load grid in one shot)."""
    ell = np.asarray(ell, dtype=np.float64)
    ell = np.broadcast_to(ell, np.broadcast_shapes(ell.shape, params.a.shape))
    return ell * total_cdf(params, ell, t)


def optimal_loads(params: DeviceDelayParams, caps: np.ndarray, t: float,
                  chunk: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Exact integer argmax of E[R_i(t; ell)] over 0..caps[i] per device.

    Returns (ell_star (n,) int array, expected return at ell_star (n,)).

    Grid-searches all integer loads at once: each chunk evaluates an
    (L, n) expected-return matrix in ONE vectorized call.  Memory is
    chunked along the load axis so server caps of ~10^5 stay cheap.
    """
    caps = np.asarray(caps, dtype=np.int64)
    n = params.n
    l_max = int(caps.max())
    best_val = np.zeros(n, dtype=np.float64)
    best_ell = np.zeros(n, dtype=np.int64)
    for lo in range(1, l_max + 1, chunk):
        hi = min(lo + chunk - 1, l_max)
        loads = np.arange(lo, hi + 1, dtype=np.float64)  # (L,)
        # E[R] for every device at every load in this chunk: (L, n)
        vals = expected_return(params, loads[:, None], t)
        # mask loads above each device's cap
        mask = loads[:, None] <= caps[None, :]
        vals = np.where(mask, vals, -np.inf)
        idx = np.argmax(vals, axis=0)  # (n,)
        chunk_best = vals[idx, np.arange(n)]
        better = chunk_best > best_val
        best_val = np.where(better, chunk_best, best_val)
        best_ell = np.where(better, loads[idx].astype(np.int64), best_ell)
    return best_ell, best_val
