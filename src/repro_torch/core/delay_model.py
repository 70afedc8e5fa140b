"""Compute & communication delay model (paper §II-A).

NumPy copy of `repro/core/delay_model.py` (the parts the §IV path, the
low-latency scheme and CodedFedL's MEC model need), bit-for-bit on the
same inputs and generators.

Per-device total round-trip time for one epoch:

    T_i = T_c_i + T_d_i + T_u_i                                   (Eq. 7)

* Compute:  T_c_i = ell*a_i + Exp(gamma_i),  gamma_i = mu_i / ell  (Eq. 4)
  (deterministic MAC time per point `a_i`, plus a stochastic memory-access
  component whose mean grows linearly with the assigned load `ell`).
* Communication:  T_d + T_u = (N_d + N_u) * tau_i, with N ~ Geometric(1-p)
  (number of transmissions until first success, Eq. 5-6).  N_d + N_u =: K has
  a negative-binomial distribution: Pr{K=k} = (k-1) p^{k-2} (1-p)^2, k>=2.

The server is modelled as device n+1 with *no* communication leg (the parity
data is already resident), i.e. T_{n+1} = T_c_{n+1} only.

Everything is expressed both as an analytic CDF (used by the redundancy
optimizer — Eqs. 14-16 need Pr{T_i <= t} exactly) and as a sampler (used by
the wall-clock simulator).  All functions are vectorized over devices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Number of retransmission terms kept in the negative-binomial series of the
# analytic CDF.  With p <= 0.5 the tail Pr{K > 2+K_MAX} is < p^K_MAX * K_MAX,
# i.e. negligible at 64 terms for any p used in the paper (p = 0.1).
K_MAX = 64


@dataclasses.dataclass(frozen=True)
class DeviceDelayParams:
    """Delay parameters for a fleet of devices (vectorized, shape (n,)).

    a:   seconds of deterministic compute per training point (d MACs / MAC rate)
    mu:  memory access rate (points/sec) for the stochastic compute component;
         gamma = mu / ell for an assigned load of ell points
    tau: seconds per packet on the device<->server link (x / (r_i W));
         tau = 0 disables the communication legs (used for the server)
    p:   packet erasure probability per transmission attempt
    """

    a: np.ndarray
    mu: np.ndarray
    tau: np.ndarray
    p: np.ndarray

    def __post_init__(self):
        for f in ("a", "mu", "tau", "p"):
            object.__setattr__(self, f, np.asarray(getattr(self, f), dtype=np.float64))
        n = self.a.shape[0]
        if not (self.mu.shape == self.tau.shape == self.p.shape == (n,)):
            raise ValueError("all delay parameter arrays must share shape (n,)")
        if np.any(self.p < 0) or np.any(self.p >= 1):
            raise ValueError("erasure probability must be in [0, 1)")

    @property
    def n(self) -> int:
        return int(self.a.shape[0])

    def mean_total(self, ell: np.ndarray) -> np.ndarray:
        """E[T_i] for an assigned load `ell` (Eq. 8); ell=0 => comm only."""
        ell = np.asarray(ell, dtype=np.float64)
        compute = ell * (self.a + 1.0 / self.mu)
        has_comm = self.tau > 0
        comm = np.where(has_comm, 2.0 * self.tau / (1.0 - self.p), 0.0)
        return compute + comm


def _nbinom_pmf(p: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Pr{N_d + N_u = k} = (k-1) p^(k-2) (1-p)^2 for k >= 2."""
    k = np.asarray(k, dtype=np.float64)
    return (k - 1.0) * np.power(p, k - 2.0) * (1.0 - p) ** 2


def compute_cdf(params: DeviceDelayParams, ell, t) -> np.ndarray:
    """Pr{T_c_i <= t} for assigned load ell (shifted exponential).

    ell = 0 means no compute: the CDF is a step at t = 0.
    Broadcasts (n,) devices against scalar-or-(n,) ell and scalar t.
    """
    ell = np.asarray(ell, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    shift = ell * params.a
    # gamma = mu / ell; ell == 0 rows are masked to a step function below.
    gamma = params.mu / np.maximum(ell, 1.0)
    s = t - shift
    cdf = np.where(s > 0, -np.expm1(-np.minimum(gamma * np.maximum(s, 0.0), 700.0)), 0.0)
    return np.where(ell > 0, cdf, (t >= 0).astype(np.float64))


def total_cdf(params: DeviceDelayParams, ell, t) -> np.ndarray:
    """Pr{T_i <= t}: negative-binomial mixture over retransmission counts.

    Pr{T <= t} = sum_{k>=2} Pr{K=k} * Pr{T_c <= t - k*tau}   (tau > 0)
               = Pr{T_c <= t}                                 (tau = 0, server)

    `ell` may be scalar, (n,), or carry leading batch axes (..., n) — e.g. an
    (L, n) grid of candidate loads — and the CDF is evaluated for the whole
    batch in one vectorized pass (this is what makes the load optimization a
    single tensor expression instead of one call per integer load).
    """
    ell = np.asarray(ell, dtype=np.float64)
    ell = np.broadcast_to(ell, np.broadcast_shapes(ell.shape, params.a.shape))
    t = float(t)

    comm = params.tau > 0
    # compute-only CDF, used directly for tau == 0 (server-style) devices
    base = compute_cdf(params, ell, t)  # (..., n)
    if not np.any(comm):
        return base

    ks = np.arange(2, 2 + K_MAX, dtype=np.float64)      # (K,)
    pmf = _nbinom_pmf(params.p[:, None], ks[None, :])   # (n, K)
    # residual time after k transmissions: s_k = t - k * tau_i
    t_resid = t - ks[None, :] * params.tau[:, None]     # (n, K)
    shift = (ell * params.a)[..., None]                 # (..., n, 1)
    gamma = (params.mu / np.maximum(ell, 1.0))[..., None]  # ell=0 masked below
    s = t_resid - shift                                 # (..., n, K)
    cdf_k = np.where(s > 0,
                     -np.expm1(-np.minimum(gamma * np.maximum(s, 0.0), 700.0)),
                     0.0)
    # ell == 0 rows: compute CDF is a step at zero -> 1 whenever t_resid >= 0
    zero_load = (ell <= 0)[..., None]
    cdf_k = np.where(zero_load, (t_resid >= 0).astype(np.float64), cdf_k)
    mix = np.sum(pmf * cdf_k, axis=-1)                  # (..., n)
    return np.where(comm, mix, base)


def partial_cdf(params: DeviceDelayParams, ell, t, chunks: int) -> np.ndarray:
    """Pr{chunk q of an assignment `ell` is done by t}, for q = 1..chunks.

    The low-latency wireless model (arXiv:2011.06223 as reproduced here):
    a device assigned `ell` points uploads `chunks` incremental partial
    results; chunk q covers its first q*ell/chunks points, so its compute
    shift is (q/chunks)*ell*a_i while the stochastic memory-access rate
    stays mu_i/ell (the slowdown scales with the FULL assignment — this is
    what keeps over-assignment costly and the load allocation nontrivial).
    The communication legs (retransmission mixture) are shared by every
    chunk exactly as in `total_cdf`.

    ell: (n,) assignments; t scalar.  Returns (n, chunks); `chunks == 1`
    reduces to `total_cdf` exactly.
    """
    ell = np.broadcast_to(np.asarray(ell, dtype=np.float64), params.a.shape)
    t = float(t)
    fracs = np.arange(1, chunks + 1, dtype=np.float64) / chunks    # (Q,)
    shift = fracs[None, :] * (ell * params.a)[:, None]             # (n, Q)
    gamma = (params.mu / np.maximum(ell, 1.0))[:, None, None]      # (n, 1, 1)

    comm = params.tau > 0
    # compute-only CDF (tau == 0, server-style devices)
    s0 = t - shift
    base = np.where(
        s0 > 0,
        -np.expm1(-np.minimum(gamma[..., 0] * np.maximum(s0, 0.0), 700.0)),
        0.0)
    base = np.where((ell > 0)[:, None], base, (t >= 0.0))
    if not np.any(comm):
        return base

    ks = np.arange(2, 2 + K_MAX, dtype=np.float64)       # (K,)
    pmf = _nbinom_pmf(params.p[:, None], ks[None, :])    # (n, K)
    t_resid = t - ks[None, :] * params.tau[:, None]      # (n, K)
    s = t_resid[:, None, :] - shift[:, :, None]          # (n, Q, K)
    cdf_k = np.where(
        s > 0,
        -np.expm1(-np.minimum(gamma * np.maximum(s, 0.0), 700.0)),
        0.0)
    zero_load = (ell <= 0)[:, None, None]
    cdf_k = np.where(zero_load, (t_resid >= 0.0)[:, None, :], cdf_k)
    mix = np.sum(pmf[:, None, :] * cdf_k, axis=-1)       # (n, Q)
    return np.where(comm[:, None], mix, base)


def sample_total(params: DeviceDelayParams, ell, rng: np.random.Generator,
                 size: Optional[int] = None) -> np.ndarray:
    """Draw T_i for every device.  Returns (n,) or (size, n)."""
    ell = np.broadcast_to(np.asarray(ell, dtype=np.float64), params.a.shape)
    shape = (params.n,) if size is None else (size, params.n)
    shift = ell * params.a
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(ell > 0, ell / params.mu, 0.0)  # mean of Exp(gamma)
    t_c = shift + rng.exponential(1.0, size=shape) * scale
    # communication: two independent geometric draws (down + up)
    comm = params.tau > 0
    p = np.where(comm, params.p, 0.0)
    n_d = rng.geometric(1.0 - p, size=shape)
    n_u = rng.geometric(1.0 - p, size=shape)
    t_comm = np.where(comm, (n_d + n_u) * params.tau, 0.0)
    return t_c + t_comm


def mec_total_cdf(params: DeviceDelayParams, ell, t) -> np.ndarray:
    """Pr{T_i <= t} under the CodedFedL MEC delay model (arXiv:2007.03273).

    The compute leg is the base shifted exponential (shift ell*a, rate
    mu/ell); the communication leg is also a shifted exponential, shift
    `2 tau` and rate `gm = (1 - p) / (2 tau p)` (the geometric
    retransmission model's minimum and mean).  The total CDF is the
    closed-form convolution of the two exponentials at the residual
    u = t - ell*a - 2 tau:

        F(u) = 1 - (gm e^{-gc u} - gc e^{-gm u}) / (gm - gc)

    with the equal-rate limit `1 - (1 + g u) e^{-g u}` where the rates
    collide, and the pure compute CDF at the same residual for devices
    whose communication leg is deterministic (`p == 0` or `tau == 0`).
    The float64 host mirror of the planner's `mec_comm` evaluator, term
    for term: the Eq.-17 weights see the probabilities the solve
    optimized.  `ell` broadcasts as in `total_cdf`.
    """
    ell = np.asarray(ell, dtype=np.float64)
    ell = np.broadcast_to(ell, np.broadcast_shapes(ell.shape, params.a.shape))
    t = float(t)

    shift = ell * params.a
    gc = params.mu / np.maximum(ell, 1.0)
    gm = (1.0 - params.p) / np.maximum(2.0 * params.tau * params.p, 1e-30)
    u = t - shift - 2.0 * params.tau
    up = np.maximum(u, 0.0)
    e_c = np.exp(-np.minimum(gc * up, 700.0))
    e_m = np.exp(-np.minimum(gm * up, 700.0))
    denom = gm - gc
    close = np.abs(denom) <= 1e-8 * np.maximum(gm, gc)
    safe = np.where(close, 1.0, denom)
    f_neq = 1.0 - (gm * e_c - gc * e_m) / safe
    gbar = 0.5 * (gm + gc)
    arg = np.minimum(gbar * up, 700.0)
    f_eq = -np.expm1(-arg) - arg * np.exp(-arg)
    cdf = np.where(close, f_eq, f_neq)
    cdf = np.where(u > 0.0, cdf, 0.0)
    det = np.logical_or(params.p <= 0.0, params.tau <= 0.0)
    cdf_det = np.where(
        u > 0.0, -np.expm1(-np.minimum(gc * up, 700.0)), 0.0)
    cdf = np.where(det, cdf_det, cdf)
    return np.where(ell > 0, cdf, (u >= 0.0).astype(np.float64))


def sample_total_mec(params: DeviceDelayParams, ell,
                     rng: np.random.Generator,
                     size: Optional[int] = None) -> np.ndarray:
    """Draw T_i under the MEC delay model (see `mec_total_cdf`).

    The compute draw of `sample_total`; the communication leg is ONE
    exponential excess over the deterministic `2 tau` floor.  Always
    consumes two generator draws per device per call (compute, then the
    excess), whatever the loads and parameters, so schedules match the
    reference draw for draw."""
    ell = np.broadcast_to(np.asarray(ell, dtype=np.float64), params.a.shape)
    shape = (params.n,) if size is None else (size, params.n)
    shift = ell * params.a
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(ell > 0, ell / params.mu, 0.0)
    t_c = shift + rng.exponential(1.0, size=shape) * scale
    comm = params.tau > 0
    stochastic = np.logical_and(comm, params.p > 0)
    gm = (1.0 - params.p) / np.maximum(2.0 * params.tau * params.p, 1e-30)
    excess = rng.exponential(1.0, size=shape) / gm
    t_comm = np.where(comm, 2.0 * params.tau, 0.0) \
        + np.where(stochastic, excess, 0.0)
    return t_c + t_comm
