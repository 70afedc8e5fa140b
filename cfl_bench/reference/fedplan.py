"""The straggler-aware federated round of the CFL paper's protocol for a
deep model, in NumPy: the Eq. 14-16 load allocation over sequences and
the deadline-masked, 1/p-weighted aggregation of each round.

Delay model (paper §II-A): T_i = ell a_i + Exp(mean ell / mu_i) + (N_d +
N_u) tau_i with N ~ Geometric(1 - p_i); Pr{T_i <= t} is the negative
binomial mixture over the transmission count (64 terms).  The loads are
the integer argmax of ell Pr{T_i <= t} up to each client's data, t* the
bisected smallest deadline whose expected return reaches the target
batch.  Each round draws T_i for every client (one exponential, then the
two geometric counts, for all clients at once); a client whose T_i <= t*,
whose load is positive and whose Pr{T_i <= t*} is at least
`min_return_prob` returns, weighted 1 / max(p_i, min_return_prob).
"""
from __future__ import annotations

import numpy as np

K_MAX = 64


def return_prob(edge: dict, ell: np.ndarray, t: float) -> np.ndarray:
    """Pr{T_i <= t} at loads `ell` ((..., n))."""
    ell = np.broadcast_to(np.asarray(ell, dtype=np.float64), np.broadcast_shapes(
        np.shape(ell), edge["a"].shape))
    ks = np.arange(2, 2 + K_MAX, dtype=np.float64)
    p = edge["p"][:, None]
    pmf = (ks - 1.0) * p ** (ks - 2.0) * (1.0 - p) ** 2          # (n, K)
    resid = t - ks[None, :] * edge["tau"][:, None]                 # (n, K)
    s = resid - (ell * edge["a"])[..., None]
    rate = (edge["mu"] / np.maximum(ell, 1.0))[..., None]
    cdf = np.where(s > 0, -np.expm1(-np.minimum(rate * np.maximum(s, 0), 700)),
                   0.0)
    cdf = np.where((ell <= 0)[..., None], (resid >= 0).astype(float), cdf)
    return np.sum(pmf * cdf, axis=-1)


def best_loads(edge: dict, caps: np.ndarray, t: float):
    """(loads, expected returns): the integer argmax of ell Pr{T <= t}
    over 1..cap (0 where no load returns anything)."""
    grid = np.arange(1, int(caps.max()) + 1, dtype=np.float64)[:, None]
    vals = grid * return_prob(edge, grid, t)
    vals = np.where(grid <= caps[None, :], vals, -np.inf)
    idx = np.argmax(vals, axis=0)
    best = vals[idx, np.arange(caps.size)]
    take = best > 0
    return (np.where(take, grid[idx, 0], 0).astype(np.int64),
            np.where(take, best, 0.0))


def plan(edge: dict, sizes: np.ndarray, target: int) -> dict:
    """{"loads", "t_star", "p_return"} of the smallest deadline whose
    expected return reaches `target` sequences (bisection to 1e-4
    relative, at most 48 halvings)."""
    n_target = min(target, int(sizes.sum()))
    comm = np.where(edge["tau"] > 0, 2 * edge["tau"] / (1 - edge["p"]), 0)
    hi = float(np.max(sizes * (edge["a"] + 1 / edge["mu"]) + comm)) + 1.0
    loads, vals = best_loads(edge, sizes, hi)
    for _ in range(61):
        if vals.sum() >= n_target:
            break
        hi *= 2
        loads, vals = best_loads(edge, sizes, hi)
    else:
        raise RuntimeError("the fleet cannot reach the target batch")
    lo = 0.0
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        l_mid, v_mid = best_loads(edge, sizes, mid)
        if v_mid.sum() >= n_target:
            hi, loads = mid, l_mid
        else:
            lo = mid
        if hi - lo < 1e-4 * max(hi, 1e-9):
            break
    return {"loads": loads, "t_star": hi,
            "p_return": return_prob(edge, loads, hi)}


def sample_total(edge: dict, loads, gen: np.random.Generator) -> np.ndarray:
    """One draw of T_i for every device: the exponential memory-access
    times, then the downlink and uplink transmission counts."""
    loads = np.broadcast_to(np.asarray(loads, dtype=np.float64),
                            edge["a"].shape)
    n = loads.size
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(loads > 0, loads / edge["mu"], 0.0)
    t_c = loads * edge["a"] + gen.exponential(1.0, size=n) * scale
    comm = edge["tau"] > 0
    p = np.where(comm, edge["p"], 0.0)
    n_d = gen.geometric(1.0 - p, size=n)
    n_u = gen.geometric(1.0 - p, size=n)
    return t_c + np.where(comm, (n_d + n_u) * edge["tau"], 0.0)


def round_client_weights(edge: dict, fed: dict, gen: np.random.Generator,
                         min_return_prob: float = 1e-3) -> np.ndarray:
    """One round's weight of each client: 0 if it misses the deadline,
    else 1 / p."""
    loads = fed["loads"]
    t = sample_total(edge, loads, gen)
    ok = ((t <= fed["t_star"]) & (loads > 0)
          & (fed["p_return"] >= min_return_prob))
    p_ret = np.clip(fed["p_return"], min_return_prob, 1.0)
    return np.where(ok, 1.0 / p_ret, 0.0)
