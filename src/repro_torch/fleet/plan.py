"""`solve_fleet` — the redundancy solve at fleet scale (1e5+ clients).

The counterpart of `repro/fleet/plan.py`, in float64 torch on one
device.  `plan.solve_redundancy_batched` evaluates the whole
`(t_grid, n, L)` expected-return tensor per deadline probe; at n = 1e5
that tensor and its K-term retransmission mixture no longer fit a sane
working set.  This solves the same problem with the same per-device
expressions and the same monotone grid refinement, with the device axis
chunk-streamed: each probe evaluates `(t_grid, CHUNK, L)` slabs, one
device chunk at a time, and sums the chunk partials in chunk order, so
peak memory is O(t_grid * CHUNK * L) whatever n is.

The reference shards the device axis over a mesh and `psum`s the shard
sums; the port runs on one card, so there is one shard and no psum.  As
there:

  * everything is float64 (no float32 scout: its saturation pathology
    is what giant fleets hit), the K retransmission terms of
    `_k_terms(p_max, tol=1e-12)` are added in index order, and the
    truncated mixture snaps to 1.0 within 1e-13 of its mass;
  * the chosen loads are each device's independent argmax at t*, so they
    match the batched solver's wherever t* agrees; the aggregate is
    reassociated (chunk partials), so t* may differ from the batched
    solver's by the refinement tolerance, not bit for bit;
  * the load axis is a power-of-two bucket (floor 8), padded devices
    carry cap 0 and add exactly 0.0, and `srv_weight` weighs the
    server's return as in `PlanRequest`.  `edge_chunks > 1` raises
    `NotImplementedError` (from `PlanRequest`, as for the batched
    planner); partial CDFs come with `LowLatencyCFL`.

The reference's `while_loop`s become Python loops that read one scalar
per probe from the device: planning is one-time set-up.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delay_model import total_cdf
from repro_torch.core.redundancy import RedundancyPlan
from repro_torch.device import resolve_device
from repro_torch.plan.solver import (GRID_POINTS, MAX_DOUBLINGS, MAX_ROUNDS,
                                     PlanRequest, _k_terms,
                                     _shifted_exp_cdf)

# Device-chunk length of the streamed evaluation: one slab is
# (GRID_POINTS, CHUNK, L) float64.
CHUNK = 4096
_SNAP_TOL = 1e-13


def _pow2_bucket(value: int, floor: int = 8) -> int:
    out = floor
    while out < value:
        out *= 2
    return out


def solve_fleet(request: PlanRequest, eps_rel: float = 1e-3,
                grid_points: int = GRID_POINTS, chunk: int = CHUNK,
                device=None) -> RedundancyPlan:
    """Solve one fleet-scale redundancy problem, chunk-streamed, on
    `device` (None: the CUDA device).

    Takes the batched solver's `PlanRequest` and returns the same
    `RedundancyPlan`; see the module docstring for how it relates to
    `solve_redundancy_batched`.  Raises RuntimeError when the fleet
    cannot reach its target."""
    dev = resolve_device(device)
    req = request
    n = req.edge.n
    chunk = max(8, min(int(chunk), _pow2_bucket(n)))
    n_pad = -(-n // chunk) * chunk

    def padded(vec, fill) -> torch.Tensor:
        out = np.full(n_pad, fill, dtype=np.float64)
        out[:n] = vec
        return torch.as_tensor(out, device=dev)

    def f64(values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=np.float64),
                               device=dev)

    a, mu = padded(req.edge.a, 1.0), padded(req.edge.mu, 1.0)
    tau, p = padded(req.edge.tau, 0.0), padded(req.edge.p, 0.0)
    caps = padded(req.data_sizes.astype(np.float64), 0.0)
    ell_e = f64(np.arange(_pow2_bucket(int(req.data_sizes.max()) + 1)))
    ell_s = f64(np.arange(_pow2_bucket(req.server_cap + 1)))
    ks = f64(np.arange(2, 2 + _k_terms(float(req.edge.p.max()), tol=1e-12)))
    frac = f64(np.arange(1, grid_points + 1) / grid_points)
    srv_a, srv_mu = float(req.server.a[0]), float(req.server.mu[0])
    srv_w, srv_cap = float(req.srv_weight), float(req.server_cap)
    target = float(req.m)
    one = torch.ones((), dtype=torch.float64, device=dev)
    neg_inf = torch.full((), float("-inf"), dtype=torch.float64, device=dev)

    # per-device terms that do not depend on t, for all chunks at once
    shift = ell_e[None, :] * a[:, None]                         # (n_pad, L)
    gamma = mu[:, None] / torch.clamp(ell_e, min=1.0)           # (n_pad, L)
    load_ok = ell_e[None, :] <= caps[:, None]                   # (n_pad, L)
    has_comm = tau > 0.0                                        # (n_pad,)
    pmf = (ks - 1.0) * p[:, None] ** (ks - 2.0) \
        * (1.0 - p[:, None]) ** 2                               # (n_pad, K)
    pmf_total = torch.zeros_like(a)
    for i in range(ks.shape[0]):
        pmf_total = pmf_total + pmf[:, i]
    snap_ok = pmf_total >= 1.0 - _SNAP_TOL
    s_ok = ell_s <= srv_cap                                     # (Ls,)

    def server_returns(t: torch.Tensor) -> torch.Tensor:
        """Weighted server E[R(t; ell)].  t: (T',) -> (T', Ls)."""
        s = t[:, None] - ell_s[None, :] * srv_a
        cdf = _shifted_exp_cdf(srv_mu / torch.clamp(ell_s, min=1.0), s)
        cdf = torch.where(ell_s > 0.0, cdf,
                          (t[:, None] >= 0.0).to(torch.float64))
        return torch.where(s_ok[None, :], srv_w * ell_s * cdf, neg_inf)

    def chunk_returns(t: torch.Tensor, lo: int) -> torch.Tensor:
        """Masked return grid of devices [lo, lo + chunk).  t: (T',) ->
        (T', chunk, L): the streamed slab of the batched solver's
        (t_grid, n, L) tensor."""
        sl = slice(lo, lo + chunk)
        shift_c, gamma_c = shift[sl], gamma[sl]

        def load_cdf(t_res):
            """(T', chunk) residual times -> (T', chunk, L) per-load CDF."""
            cdf = _shifted_exp_cdf(gamma_c[None], t_res[..., None]
                                   - shift_c[None])
            return torch.where(ell_e > 0.0, cdf,
                               (t_res[..., None] >= 0.0).to(torch.float64))

        mix = torch.zeros((t.shape[0], chunk, ell_e.shape[0]),
                          dtype=torch.float64, device=dev)
        for i in range(ks.shape[0]):
            t_res = t[:, None] - ks[i] * tau[sl][None, :]
            mix = mix + pmf[sl][None, :, i, None] * load_cdf(t_res)
        mix = torch.where((mix >= pmf_total[sl][None, :, None])
                          & snap_ok[sl][None, :, None], one, mix)
        nocomm = load_cdf(t[:, None].expand(t.shape[0], chunk))
        mix = torch.where(has_comm[sl][None, :, None], mix, nocomm)
        return torch.where(load_ok[sl][None], ell_e * mix, neg_inf)

    def best_agg(t: torch.Tensor) -> torch.Tensor:
        """(T',) aggregate best return over the fleet and the server."""
        edge = torch.zeros_like(t)
        for lo in range(0, n_pad, chunk):
            edge = edge + chunk_returns(t, lo).amax(dim=-1).sum(dim=-1)
        return edge + server_returns(t).amax(dim=-1)

    def agg_at(t: float) -> float:
        return float(best_agg(f64([t]))[0])

    # --- bracket expansion ---------------------------------------------------
    t_hi0 = float(req.t_hi) if req.t_hi is not None else req.default_t_hi()
    t_hi, step, agg_hi = t_hi0, t_hi0, agg_at(t_hi0)
    i = 0
    while i < MAX_DOUBLINGS and agg_hi < target:
        t_hi, step = t_hi + step, 2.0 * step
        agg_hi = agg_at(t_hi)
        i += 1
    feasible = agg_hi >= target

    # --- monotone grid refinement ------------------------------------------
    def active(t_lo_c: float, t_hi_c: float) -> bool:
        return feasible and (t_hi_c - t_lo_c) > eps_rel * max(t_hi_c, 1e-12)

    t_lo, r = 0.0, 0
    while r < MAX_ROUNDS and active(t_lo, t_hi):
        grid = t_lo + frac * (t_hi - t_lo)
        grid[-1] = t_hi  # exact upper edge: invariant
        ok = (best_agg(grid) >= target).cpu().numpy()
        idx = int(np.argmax(ok))  # first deadline over the target
        grid_h = grid.cpu().numpy()
        t_lo = t_lo if idx == 0 else float(grid_h[idx - 1])
        t_hi = float(grid_h[idx])
        r += 1
    t_star = t_hi

    # --- extraction at t* ----------------------------------------------------
    t_vec = f64([t_star])
    loads_c, best_sums = [], []
    for lo in range(0, n_pad, chunk):
        ev = chunk_returns(t_vec, lo)[0]                        # (chunk, L)
        arg = torch.argmax(ev, dim=-1)                          # first max
        loads_c.append(arg)
        best_sums.append(ev.gather(-1, arg[:, None])[:, 0].sum())
    sv = server_returns(t_vec)[0]                               # (Ls,)
    s_load = int(torch.argmax(sv))
    agg = float(torch.stack(best_sums).sum() + sv[s_load])

    if not feasible:
        raise RuntimeError(
            "cannot reach the aggregate expected return target — the "
            f"fleet cannot return the points in finite time: target "
            f"{req.m}, best achievable {agg:.1f}")

    dev_loads = torch.cat(loads_c)[:n].cpu().numpy().astype(np.int64)
    c = int(req.fixed_c) if req.fixed_c is not None else s_load
    p_return = np.append(
        total_cdf(req.edge, dev_loads, t_star),
        total_cdf(req.server, np.array([float(s_load)]), t_star))
    return RedundancyPlan(loads=dev_loads, c=c, t_star=t_star,
                          p_return=p_return, expected_agg=agg,
                          loads_cap_total=req.m)
