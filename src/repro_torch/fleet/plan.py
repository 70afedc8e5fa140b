"""`solve_fleet` — the redundancy solve at fleet scale (1e5+ clients).

The counterpart of `repro/fleet/plan.py`, in float64 torch.
`plan.solve_redundancy_batched` evaluates the whole
`(t_grid, n, L)` expected-return tensor per deadline probe; at n = 1e5
that tensor and its K-term retransmission mixture no longer fit a sane
working set.  This solves the same problem with the same per-device
expressions and the same monotone grid refinement, with the device axis
chunk-streamed: each probe evaluates `(t_grid, CHUNK, L)` slabs, one
device chunk at a time, and sums the chunk partials in chunk order, so
peak memory is O(t_grid * CHUNK * L) whatever n is.

The device chunks are split over the shard mesh
(`launch.mesh.make_shard_mesh`: every card of the solve's device type,
its device first), contiguous runs of chunks a card, as the reference
shards the device axis; each card evaluates its chunks' partials, and
the solve's device adds them in chunk order, the one-card order, so t*,
c and the loads are the same at every mesh size.  As there:

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
    server's return as in `PlanRequest`, and `edge_chunks > 1` takes the
    partial-return objective of `LowLatencyCFL` (the Q chunk CDFs added
    in index order, then divided by Q, as in the batched planner).

`mec_comm=True` raises `ValueError`: the streamed evaluator has only the
retransmission-mixture edge model.  The reference's `solve_fleet` never
reads `mec_comm` and quietly plans such a request with the base model
(ROADMAP "Reference state", R6); a MEC plan comes from
`plan.solve_redundancy_batched`.

The reference's `while_loop`s become Python loops that read one scalar
per probe from the device: planning is one-time set-up.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delay_model import total_cdf
from repro_torch.core.redundancy import RedundancyPlan
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import local_devices, make_shard_mesh
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
                device=None, devices=None) -> RedundancyPlan:
    """Solve one fleet-scale redundancy problem, chunk-streamed, on
    `device` (None: the CUDA device), its chunks over the shard mesh of
    `devices` (default: every card of `device`'s type, `device` first).

    Takes the batched solver's `PlanRequest` and returns the same
    `RedundancyPlan`; see the module docstring for how it relates to
    `solve_redundancy_batched`.  Raises RuntimeError when the fleet
    cannot reach its target, and ValueError on a `mec_comm` request."""
    if request.mec_comm:
        raise ValueError(
            "solve_fleet has no mec_comm objective (CodedFedL's MEC delay "
            "model); plan MEC requests with plan.solve_redundancy_batched")
    dev = resolve_device(device)
    cards = make_shard_mesh(local_devices(dev) if devices is None
                            else devices)
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
    edge_chunks = int(req.edge_chunks)
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

    # the shard mesh: card j owns a contiguous run of chunks, and holds
    # their rows of the per-device terms and its own copy of the rest
    n_chunks = n_pad // chunk
    owner = [c * len(cards) // n_chunks for c in range(n_chunks)]
    shards = {}
    for j, card in enumerate(cards):
        mine = [c for c in range(n_chunks) if owner[c] == j]
        if not mine:
            continue
        rows = slice(mine[0] * chunk, (mine[-1] + 1) * chunk)
        shards[j] = {
            "lo": rows.start, "card": card,
            **{k: v[rows].to(card) for k, v in (
                ("shift", shift), ("gamma", gamma), ("load_ok", load_ok),
                ("has_comm", has_comm), ("pmf", pmf),
                ("pmf_total", pmf_total), ("snap_ok", snap_ok),
                ("tau", tau))},
            **{k: v.to(card) for k, v in (
                ("ell_e", ell_e), ("ks", ks), ("one", one),
                ("neg_inf", neg_inf))}}

    def server_returns(t: torch.Tensor) -> torch.Tensor:
        """Weighted server E[R(t; ell)].  t: (T',) -> (T', Ls)."""
        s = t[:, None] - ell_s[None, :] * srv_a
        cdf = _shifted_exp_cdf(srv_mu / torch.clamp(ell_s, min=1.0), s)
        cdf = torch.where(ell_s > 0.0, cdf,
                          (t[:, None] >= 0.0).to(torch.float64))
        return torch.where(s_ok[None, :], srv_w * ell_s * cdf, neg_inf)

    def chunk_returns(t: torch.Tensor, c: int) -> torch.Tensor:
        """Masked return grid of chunk c's devices, on the card that owns
        it.  t: (T',) on that card -> (T', chunk, L): the streamed slab of
        the batched solver's (t_grid, n, L) tensor."""
        sh = shards[owner[c]]
        lo = c * chunk - sh["lo"]
        sl = slice(lo, lo + chunk)
        shift_c, gamma_c = sh["shift"][sl], sh["gamma"][sl]
        ell_e, ks, pmf, tau = sh["ell_e"], sh["ks"], sh["pmf"], sh["tau"]

        def load_cdf(t_res):
            """(T', chunk) residual times -> (T', chunk, L) per-load CDF
            (the mean of the Q chunk CDFs when edge_chunks = Q > 1)."""
            if edge_chunks == 1:
                cdf = _shifted_exp_cdf(gamma_c[None], t_res[..., None]
                                       - shift_c[None])
            else:
                cdf = torch.zeros(t_res.shape + (ell_e.shape[0],),
                                  dtype=torch.float64, device=t.device)
                for j in range(edge_chunks):
                    fq = (float(j) + 1.0) / edge_chunks
                    cdf = cdf + _shifted_exp_cdf(
                        gamma_c[None], t_res[..., None] - fq * shift_c[None])
                cdf = cdf / edge_chunks
            return torch.where(ell_e > 0.0, cdf,
                               (t_res[..., None] >= 0.0).to(torch.float64))

        mix = torch.zeros((t.shape[0], chunk, ell_e.shape[0]),
                          dtype=torch.float64, device=t.device)
        for i in range(ks.shape[0]):
            t_res = t[:, None] - ks[i] * tau[sl][None, :]
            mix = mix + pmf[sl][None, :, i, None] * load_cdf(t_res)
        mix = torch.where((mix >= sh["pmf_total"][sl][None, :, None])
                          & sh["snap_ok"][sl][None, :, None], sh["one"], mix)
        nocomm = load_cdf(t[:, None].expand(t.shape[0], chunk))
        mix = torch.where(sh["has_comm"][sl][None, :, None], mix, nocomm)
        return torch.where(sh["load_ok"][sl][None], ell_e * mix,
                           sh["neg_inf"])

    def on_cards(t: torch.Tensor) -> dict:
        """t on every card of the mesh."""
        return {j: t.to(sh["card"]) for j, sh in shards.items()}

    def best_agg(t: torch.Tensor) -> torch.Tensor:
        """(T',) aggregate best return over the fleet and the server: each
        card's chunk partials, all enqueued, then added on the solve's
        device in chunk order."""
        t_on = on_cards(t)
        parts = [chunk_returns(t_on[owner[c]], c).amax(dim=-1).sum(dim=-1)
                 for c in range(n_chunks)]
        edge = torch.zeros_like(t)
        for part in parts:
            edge = edge + part.to(dev)
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
    t_on = on_cards(t_vec)
    loads_c, best_sums = [], []
    for c in range(n_chunks):
        ev = chunk_returns(t_on[owner[c]], c)[0]                # (chunk, L)
        arg = torch.argmax(ev, dim=-1)                          # first max
        loads_c.append(arg)
        best_sums.append(ev.gather(-1, arg[:, None])[:, 0].sum())
    loads_c = [arg.to(dev) for arg in loads_c]
    best_sums = [total.to(dev) for total in best_sums]
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
