"""Inverse privacy calibration: epsilon target -> noise multiplier
(counterpart of `repro/privacy/calibrate.py`), in float64 torch.

`calibrate_noise(epsilon_target, delta, rounds, sample_frac)` finds the
smallest noise multiplier whose composed budget (`accountant.
epsilon_spent`) stays within the target.  epsilon is strictly decreasing
in sigma, so a bracket-expansion phase (doubling steps) finds a feasible
upper end, then monotone grid refinement shrinks the bracket by
`GRID_POINTS` per round until it is `eps_rel`-relative tight.  Targets
batch: each round evaluates epsilon on a (B, S) sigma grid as one tensor
expression, and a finished row is frozen while others refine, so a
target calibrates the same solo or batched.

The reference's `while_loop`s become Python loops whose conditions read
one boolean from the device per iteration (calibration is one-time
set-up).  The returned sigma is the bracket's feasible end, so
`epsilon_spent(sigma) <= epsilon_target` by construction.  Targets below
the order grid's achievable floor (~5e-4 at delta = 1e-5) raise
RuntimeError.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .accountant import _eps_from_total_rdp, _rdp_all_orders, _validate

GRID_POINTS = 16    # sigma-grid resolution per refinement round
MAX_ROUNDS = 24     # refinement cap (16^24 of dynamic range)
MAX_DOUBLINGS = 60  # bracket-expansion cap (matches the planner's)


def _calibrate_grid(target, delta, rounds, q, sig_hi0, eps_rel: float,
                    frac):
    """Batched grid-then-polish solve for the minimal feasible sigma.

    target/delta/rounds/q: (B,) float64    sig_hi0: (B,) initial bracket
    eps_rel: relative sigma tolerance       frac: (S,) grid fractions
    Returns (sigma, eps_at_sigma, feasible), each (B,)."""
    def eps_at(sig):                                            # (B, S')
        rdp = _rdp_all_orders(sig, q[:, None]) * rounds[:, None, None]
        return _eps_from_total_rdp(rdp, delta[:, None])

    # --- bracket expansion: grow sig_hi until eps(sig_hi) <= target ------
    hi, step = sig_hi0, sig_hi0
    eps = eps_at(sig_hi0[:, None])[:, 0]
    i = 0
    while i < MAX_DOUBLINGS and bool((eps > target).any()):
        need = eps > target
        hi_new = torch.where(need, hi + step, hi)
        step = torch.where(need, 2.0 * step, step)
        eps = torch.where(need, eps_at(hi_new[:, None])[:, 0], eps)
        hi = hi_new
        i += 1
    feasible = eps <= target

    # --- monotone grid refinement on sigma -------------------------------
    def active(lo, hi):
        wide = (hi - lo) > eps_rel * torch.clamp(hi, min=1e-30)
        return wide & feasible

    lo = torch.zeros_like(hi)
    r = 0
    while r < MAX_ROUNDS and bool(active(lo, hi).any()):
        grid = lo[:, None] + frac[None, :] * (hi - lo)[:, None]
        grid[:, -1] = hi  # exact upper edge: invariant
        ok = eps_at(grid) <= target[:, None]
        idx = torch.argmax(ok.to(grid.dtype), dim=1)  # first feasible point
        hi_new = grid.gather(1, idx[:, None])[:, 0]
        lo_prev = grid.gather(1, torch.clamp(idx - 1, min=0)[:, None])[:, 0]
        lo_new = torch.where(idx == 0, lo, lo_prev)
        act = active(lo, hi)
        lo = torch.where(act, lo_new, lo)
        hi = torch.where(act, hi_new, hi)
        r += 1
    return hi, eps_at(hi[:, None])[:, 0], feasible


def calibrate_noise(epsilon_target, delta=1e-5, rounds=1, sample_frac=1.0,
                    eps_rel: float = 1e-6, device=None):
    """Smallest noise multiplier with epsilon_spent <= epsilon_target,
    solved on `device` (None: the card).

    The four budget arguments broadcast; array targets calibrate in one
    batched solve.  Scalars in -> float out, else a NumPy array.  Raises
    RuntimeError when a target sits below the order grid's achievable
    epsilon floor (no finite noise reaches it)."""
    _validate(sample_frac, rounds, delta)
    tgt = np.asarray(epsilon_target, dtype=np.float64)
    if np.any(tgt <= 0.0):
        raise ValueError(f"epsilon_target must be > 0, got {tgt}")
    args = np.broadcast_arrays(
        tgt, np.asarray(delta, dtype=np.float64),
        np.asarray(rounds, dtype=np.float64),
        np.asarray(sample_frac, dtype=np.float64))
    shape = args[0].shape
    flat = [np.ascontiguousarray(a).reshape(-1) for a in args]
    dev = resolve_device(device)
    t, dl, rd, q = (torch.as_tensor(a, device=dev) for a in flat)
    frac = torch.arange(1, GRID_POINTS + 1, dtype=torch.float64,
                        device=dev) / GRID_POINTS
    sigma, eps, feasible = (o.cpu().numpy() for o in _calibrate_grid(
        t, dl, rd, q, torch.ones_like(t), float(eps_rel), frac))

    if not feasible.all():
        bad = np.flatnonzero(~feasible)
        detail = "; ".join(
            f"target epsilon {flat[0][j]:.2e} (delta {flat[1][j]:.0e}, "
            f"rounds {flat[2][j]:.0f}): best achievable {eps[j]:.2e}"
            for j in bad)
        raise RuntimeError(
            "epsilon target below the accountant's achievable floor — no "
            f"finite noise multiplier reaches it: {detail}")

    out = sigma.reshape(shape)
    return float(out) if out.ndim == 0 else out
