"""Rényi-DP accountant for the subsampled Gaussian mechanism
(counterpart of `repro/privacy/accountant.py`), in float64 torch.

Maps `StochasticCodedFL`'s two knobs — `noise_multiplier` (Gaussian noise
std relative to the coded data's RMS) and `sample_frac` (per-round
Bernoulli parity-row sampling rate) — to a composed (epsilon, delta)
budget.  Each training round is one release of a Poisson-subsampled
Gaussian mechanism with sampling probability `q = sample_frac` and noise
multiplier `sigma`; rounds compose additively in the RDP domain and the
total converts to (epsilon, delta) at the end.

Order grid (`DEFAULT_ORDERS`), as in the reference:

  * integer orders 2..64 — the exact subsampled-Gaussian RDP through the
    binomial expansion, in log space:

        A_alpha = sum_k C(alpha,k) (1-q)^(alpha-k) q^k e^(k(k-1)/(2 sigma^2))
        rdp(alpha) = log(A_alpha) / (alpha - 1)

  * large orders 80..4096 — the unsubsampled Gaussian bound
    `alpha / (2 sigma^2)` (subsampling only lowers RDP).

RDP -> (epsilon, delta) is the improved conversion (Balle et al. 2020):

    epsilon = min_alpha [ rdp(alpha) + log1p(-1/alpha)
                          - (log(delta) + log(alpha)) / (alpha - 1) ]

Every expression is the reference's, term for term, in float64 on the
device the caller names (None: the card).  `_LOG_BINOM` marks k > alpha
with -inf; `torch.logsumexp` drops those terms exactly (a row mixing -inf
with finite terms stays finite).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

# Exact-subsampled integer orders (binomial sum over k = 0..alpha).
SMALL_ORDERS = np.arange(2, 65, dtype=np.float64)
# Gaussian-bounded large orders: push the epsilon floor down for
# tight-privacy calibrations while keeping the k axis at 65 entries.
LARGE_ORDERS = np.array([80.0, 96.0, 128.0, 192.0, 256.0, 384.0, 512.0,
                         768.0, 1024.0, 1536.0, 2048.0, 3072.0, 4096.0])
DEFAULT_ORDERS = np.concatenate([SMALL_ORDERS, LARGE_ORDERS])

_KS = np.arange(0, int(SMALL_ORDERS[-1]) + 1, dtype=np.float64)
# log C(alpha, k) for the small integer orders; -inf marks k > alpha so
# logsumexp drops those terms exactly.
_LOG_BINOM = np.full((SMALL_ORDERS.size, _KS.size), -np.inf)
for _i, _alpha in enumerate(SMALL_ORDERS):
    for _k in range(int(_alpha) + 1):
        _LOG_BINOM[_i, _k] = (math.lgamma(_alpha + 1.0)
                              - math.lgamma(_k + 1.0)
                              - math.lgamma(_alpha - _k + 1.0))


def _f64(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.float64),
                           device=device)


def _rdp_all_orders(sigma: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-round RDP at every `DEFAULT_ORDERS` order.

    sigma, q: broadcast-compatible float64 tensors -> (..., A).  sigma == 0
    produces non-finite values here; callers mask it to +inf (zero noise
    means no privacy)."""
    dev = sigma.device
    small = _f64(SMALL_ORDERS, dev)
    ks = _f64(_KS, dev)
    sig2 = (sigma * sigma)[..., None, None]
    logq = torch.log(q)[..., None, None]
    # 0 * log(0) -> 0: at q == 1 the k < alpha terms carry log(1-q) = -inf
    # and vanish, while the k == alpha term (coefficient exactly 0) takes
    # the where's 0 branch — the pure Gaussian RDP alpha / (2 sigma^2)
    log1mq = torch.where(q < 1.0, torch.log1p(-q),
                         torch.full_like(q, -math.inf))[..., None, None]
    coef = small[:, None] - ks[None, :]
    terms = (_f64(_LOG_BINOM, dev) + ks * logq
             + torch.where(coef > 0.0, coef * log1mq,
                           torch.zeros((), dtype=torch.float64, device=dev))
             + ks * (ks - 1.0) / (2.0 * sig2))
    log_a = torch.logsumexp(terms, dim=-1)                      # (..., As)
    rdp_small = log_a / (small - 1.0)
    rdp_large = _f64(LARGE_ORDERS, dev) / (2.0 * sig2[..., 0])  # (..., Al)
    return torch.cat([rdp_small, rdp_large], dim=-1)


def _eps_from_total_rdp(rdp_total: torch.Tensor,
                        delta: torch.Tensor) -> torch.Tensor:
    """Improved RDP -> (epsilon, delta) conversion, min over the grid.

    rdp_total: (..., A) composed RDP;  delta: (...,) broadcastable."""
    a = _f64(DEFAULT_ORDERS, rdp_total.device)
    eps = (rdp_total + torch.log1p(-1.0 / a)
           - (torch.log(delta)[..., None] + torch.log(a)) / (a - 1.0))
    return torch.clamp(torch.amin(eps, dim=-1), min=0.0)


def _validate(sample_frac, rounds, delta) -> None:
    sample_frac = np.asarray(sample_frac, dtype=np.float64)
    if np.any(sample_frac <= 0.0) or np.any(sample_frac > 1.0):
        raise ValueError(
            f"sample_frac must be in (0, 1], got {sample_frac}")
    rounds = np.asarray(rounds)
    if np.any(rounds < 1):
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    delta = np.asarray(delta, dtype=np.float64)
    if np.any(delta <= 0.0) or np.any(delta >= 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")


def epsilon_spent(noise_multiplier, sample_frac=1.0, rounds=1, delta=1e-5,
                  device=None):
    """Composed (epsilon, delta)-DP cost of `rounds` subsampled-Gaussian
    releases at noise `noise_multiplier` and sampling rate `sample_frac`,
    evaluated on `device` (None: the card).

    All four arguments broadcast; scalars in -> Python float out, else a
    NumPy array.  Zero noise costs epsilon = +inf."""
    _validate(sample_frac, rounds, delta)
    nm = np.asarray(noise_multiplier, dtype=np.float64)
    if np.any(nm < 0.0):
        raise ValueError(f"noise_multiplier must be >= 0, got {nm}")
    dev = resolve_device(device)
    sigma, q, t, dl = (_f64(v, dev) for v in np.broadcast_arrays(
        nm, np.asarray(sample_frac, dtype=np.float64),
        np.asarray(rounds, dtype=np.float64),
        np.asarray(delta, dtype=np.float64)))
    rdp = _rdp_all_orders(sigma, q) * t[..., None]
    eps = torch.where(sigma > 0.0, _eps_from_total_rdp(rdp, dl),
                      torch.full_like(sigma, math.inf))
    out = eps.cpu().numpy()
    return float(out) if out.ndim == 0 else out


def epsilon_schedule(noise_multiplier, sample_frac=1.0, rounds=1,
                     delta=1e-5, device=None) -> np.ndarray:
    """(rounds,) cumulative epsilon spent after rounds 1..rounds, on
    `device` (None: the card).  Scalar arguments only: the trajectory
    `StochasticCodedFL.report_extras` puts on
    `TraceReport.extras["epsilon_schedule"]`."""
    _validate(sample_frac, rounds, delta)
    nm = float(noise_multiplier)
    if nm < 0.0:
        raise ValueError(f"noise_multiplier must be >= 0, got {nm}")
    dev = resolve_device(device)
    sigma = _f64(nm, dev)
    grid = _f64(np.arange(1, int(rounds) + 1, dtype=np.float64), dev)
    rdp = _rdp_all_orders(sigma, _f64(sample_frac, dev))         # (A,)
    total = grid[:, None] * rdp[None, :]                        # (T, A)
    eps = _eps_from_total_rdp(
        total, _f64(delta, dev).expand(grid.shape))
    if nm <= 0.0:
        eps = torch.full_like(eps, math.inf)
    return eps.cpu().numpy()
