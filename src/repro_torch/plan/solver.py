"""Batched redundancy planning (paper §III-B, Eqs. 14-16) in torch.

The counterpart of `repro/plan/solver.py`: the same closed-over-grid
formulation, run as torch tensor expressions on the device instead of a
jitted JAX program.

  * the full `(t_grid, n, L)` expected-return tensor is evaluated in one
    shot — loads axis, devices axis and a batch of candidate deadlines at
    once — so a deadline probe is one tensor expression, not `L` CDF calls;
  * `t*` is recovered by monotone grid refinement: each round evaluates
    the aggregate best return on a `GRID_POINTS`-wide deadline grid and
    shrinks the bracket by that factor;
  * requests batch over fleets: `(B, n)` delay parameters, per-request
    caps and parity budgets.

The search runs a float32 scout, then a float64 polish from the scout's
bracket; the final load/aggregate extraction runs in float64 (see
`_solve_grid`).  Return probabilities are re-evaluated on the host with
`core.delay_model.total_cdf`, as the reference does.

The objective takes the base CFL form and two scheme evaluators:

  * `srv_weight`, the stochastic-CFL server discount (a `(B,)` input: a
    parity row counts `srv_weight` rows of value in the aggregate, while
    the server's completion probability is still evaluated at the full
    row load; 1.0 multiplies exactly, so it is the base objective bit for
    bit);
  * `edge_chunks`, the partial-return objective of `LowLatencyCFL`: a
    device assigned `ell` points uploads Q incremental chunks, and its
    expected return is `(ell/Q) * sum_q Pr{chunk q done by t}` — Q
    shifted copies of the base CDF grid, added one at a time in index
    order as in the reference.  `edge_chunks == 1` is the base code path;
  * `mec_comm`, CodedFedL's multi-access edge delay model: each device's
    communication leg is a shifted exponential (shift `2 tau`, rate
    `(1 - p) / (2 tau p)`) instead of the retransmission mixture, and
    the edge return is `ell * Pr{T_comp + T_comm <= t}` through the
    closed-form two-exponential convolution (`edge_returns_mec`, term for
    term the reference's, in the float32 scout and the float64 polish).
    Its return probabilities are re-evaluated on the host with
    `core.delay_model.mec_total_cdf`.

`edge_chunks` and `mec_comm` change the evaluator, so requests group by
`(padded n, edge_chunks, mec_comm)`.  The `while_loop`s of the reference
become Python loops whose conditions read one boolean from the device per
iteration — planning is one-time set-up, not the per-epoch hot loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.delay_model import (DeviceDelayParams, K_MAX,
                                          mec_total_cdf, total_cdf)
from repro_torch.core.redundancy import RedundancyPlan
from repro_torch.device import resolve_device

GRID_POINTS = 16    # deadline-grid resolution per refinement round
MAX_ROUNDS = 24     # refinement cap: 16^24 of dynamic range, never binding
MAX_DOUBLINGS = 60  # bracket-expansion cap (matches the legacy guard)

# Shape buckets, as in the reference: padded devices get cap 0 and
# contribute exactly 0.0 to the aggregate.
_N_BUCKET = 8
_L_BUCKET = 64


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One redundancy-planning problem: a fleet plus a parity budget.

    edge:       delay params of the n client devices
    server:     delay params of the central server (tau == 0 required)
    data_sizes: (n,) local dataset sizes ell_i
    c_up:       max parity rows the server may receive (default: m)
    fixed_c:    force the coding redundancy (delta-sweep mode)
    t_hi:       optional initial deadline bracket override
    srv_weight: effective rows per parity row in the aggregate return,
                in [0, 1] (the stochastic-CFL discount; 1.0 = base CFL)
    edge_chunks: per-epoch partial-upload chunks per device (the
                low-latency objective; 1 = all-or-nothing base CFL)
    mec_comm:   model each device's communication leg as CodedFedL's
                shifted-exponential MEC link instead of the retransmission
                mixture (False = base CFL); not with edge_chunks > 1
    """

    edge: DeviceDelayParams
    server: DeviceDelayParams
    data_sizes: np.ndarray
    c_up: Optional[int] = None
    fixed_c: Optional[int] = None
    t_hi: Optional[float] = None
    srv_weight: float = 1.0
    edge_chunks: int = 1
    mec_comm: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "data_sizes", np.asarray(self.data_sizes, dtype=np.int64))
        if not (0.0 <= float(self.srv_weight) <= 1.0):
            raise ValueError(
                f"srv_weight must be in [0, 1], got {self.srv_weight}")
        if int(self.edge_chunks) < 1:
            raise ValueError(
                f"edge_chunks must be >= 1, got {self.edge_chunks}")
        if self.mec_comm and int(self.edge_chunks) > 1:
            raise ValueError(
                "mec_comm models whole-assignment uploads; combining it "
                "with edge_chunks > 1 partial uploads is not defined")
        if self.server.n != 1:
            raise ValueError("server params must describe exactly one device")
        if float(self.server.tau[0]) != 0.0:
            raise ValueError(
                "the grid solver models the server without a communication "
                "leg; got server tau > 0")
        if self.data_sizes.shape != (self.edge.n,):
            raise ValueError(
                f"data_sizes must have shape ({self.edge.n},), "
                f"got {self.data_sizes.shape}")

    @property
    def m(self) -> int:
        return int(self.data_sizes.sum())

    @property
    def server_cap(self) -> int:
        if self.fixed_c is not None:
            return int(self.fixed_c)
        return int(self.c_up) if self.c_up is not None else self.m

    def default_t_hi(self) -> float:
        """Initial bracket: slowest device's mean epoch time at full load."""
        edge_mean = float(np.max(self.edge.mean_total(self.data_sizes)))
        srv_mean = float(self.server.mean_total(
            np.array([self.server_cap]))[0])
        return max(edge_mean, srv_mean) + 1.0


def _shifted_exp_cdf(gamma: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.where(
        s > 0.0,
        -torch.expm1(-torch.clamp(gamma * torch.clamp(s, min=0.0), max=700.0)),
        torch.zeros((), dtype=s.dtype, device=s.device))


def _solve_grid(a, mu, tau, p, srv_a, srv_mu, srv_w, caps, srv_cap, target,
                t_hi0, eps_rel, ell_e, ell_s, ks_search, ks_extract,
                mask_search, mask_extract, frac, search_f32=True,
                edge_chunks=1, mec_comm=False):
    """Batched grid solve.  All tensors float64 except integer caps.

    a/mu/tau/p: (B, n) edge delay params    srv_a/srv_mu: (B,) server params
    srv_w: (B,) server return weights (1.0 = base CFL objective)
    caps: (B, n) load caps                  srv_cap: (B,) parity budgets
    target: (B,) aggregate-return targets   t_hi0: (B,) initial brackets
    eps_rel: python float                   frac: (T,) refinement fractions
    ell_e: (L,) edge load grid 0..L-1       ell_s: (Ls,) server load grid
    ks_search / ks_extract: (K,) / (K',) retransmission counts for the
        deadline search and the final extraction, with (B, K) / (B, K')
        0/1 masks truncating each row's series at its own length (masked
        terms add exactly 0.0: a plan is the same solo or batched)
    edge_chunks: partial-return chunk count (1 = all-or-nothing)
    mec_comm: shifted-exponential MEC communication legs (CodedFedL)
        instead of the retransmission mixture

    Returns (t_star (B,), loads (B, n), s_load (B,), agg (B,),
    feasible (B,)).  Term for term the reference's `_solve_grid`.
    """
    has_comm = tau > 0.0                                        # (B, n)
    load_ok = ell_e[None, None, :] <= caps[..., None]           # (B, n, L)
    s_ok = ell_s[None, :] <= srv_cap[:, None]                   # (B, Ls)
    b, n = a.shape
    n_loads = ell_e.shape[0]

    def _make_returns(dtype, ks, k_mask):
        """Expected-return evaluators closing over params cast to `dtype`."""
        a_, mu_, tau_, p_ = (t.to(dtype) for t in (a, mu, tau, p))
        srv_a_, srv_mu_ = srv_a.to(dtype), srv_mu.to(dtype)
        srv_w_ = srv_w.to(dtype)
        ell_e_, ell_s_, ks_ = (t.to(dtype) for t in (ell_e, ell_s, ks))
        one = torch.ones((), dtype=dtype, device=a.device)
        zero = torch.zeros((), dtype=dtype, device=a.device)
        neg_inf = torch.full((), float("-inf"), dtype=dtype, device=a.device)
        pmf = (ks_ - 1.0) * p_[..., None] ** (ks_ - 2.0) \
            * (1.0 - p_[..., None]) ** 2                        # (B, n, K)
        pmf = pmf * k_mask.to(dtype)[:, None, :]  # per-row truncation
        shift = ell_e_[None, None, :] * a_[..., None]           # (B, n, L)
        gamma = mu_[..., None] / torch.clamp(ell_e_, min=1.0)   # (B, n, L)
        s_shift = ell_s_[None, :] * srv_a_[:, None]             # (B, Ls)
        s_gamma = srv_mu_[:, None] / torch.clamp(ell_s_, min=1.0)

        # truncated-series mass, summed in the mixture's order: where every
        # kept CDF term saturates at 1.0 the mixture equals it bitwise and
        # snaps to exactly 1.0 (see the reference for why only where ~1)
        pmf_total = torch.zeros((b, n), dtype=dtype, device=a.device)
        for i in range(ks.shape[0]):
            pmf_total = pmf_total + pmf[:, :, i]
        snap_tol = 1e-4 if dtype == torch.float32 else 1e-13
        snap_ok = pmf_total >= 1.0 - snap_tol                   # (B, n)
        # chunk q's share of the compute shift, q/Q, in `dtype`
        fqs = (torch.arange(edge_chunks, dtype=dtype, device=a.device)
               + 1.0) / edge_chunks

        def _load_cdf(t_res):
            """Per-load completion CDF at residual time `t_res`.

            edge_chunks == 1: Pr{the whole assignment is done}.
            edge_chunks == Q > 1: the mean over q of Pr{chunk q (the first
            q*ell/Q points) is done} — chunk q shifts the compute by
            (q/Q)*ell*a while the stochastic rate stays mu/ell; the Q
            terms are added in index order, then divided by Q.
            t_res: (B, T', n) -> (B, T', n, L)."""
            if edge_chunks == 1:
                s = t_res[..., None] - shift[:, None, :, :]
                cdf = _shifted_exp_cdf(gamma[:, None], s)
            else:
                cdf = torch.zeros(t_res.shape + (n_loads,), dtype=dtype,
                                  device=a.device)
                for j in range(edge_chunks):
                    s = t_res[..., None] - fqs[j] * shift[:, None, :, :]
                    cdf = cdf + _shifted_exp_cdf(gamma[:, None], s)
                cdf = cdf / edge_chunks
            return torch.where(ell_e_ > 0.0, cdf,
                               (t_res[..., None] >= 0.0).to(dtype))

        def edge_returns_mec(t):
            """Masked MEC E[R_i(t; ell)] grid.  t: (B, T') -> (B, T', n, L).

            The completion CDF of the compute exponential (rate
            gc = mu/ell) convolved with the communication exponential
            (rate gm = (1 - p) / (2 tau p)) at the residual
            u = t - ell*a - 2 tau, with the equal-rate limit where the
            rates collide within a relative 1e-8, and the pure compute
            CDF at u for devices with p == 0 or tau == 0."""
            gc = gamma                                          # (B, n, L)
            gm = (1.0 - p_) / torch.clamp(2.0 * tau_ * p_, min=1e-30)
            gm_l = gm[:, :, None]                               # (B, n, 1)
            u = t[:, :, None, None] - shift[:, None, :, :] \
                - 2.0 * tau_[:, None, :, None]                  # (B,T',n,L)
            up = torch.clamp(u, min=0.0)
            e_c = torch.exp(-torch.clamp(gc[:, None] * up, max=700.0))
            e_m = torch.exp(-torch.clamp(gm_l[:, None] * up, max=700.0))
            denom = gm_l - gc                                   # (B, n, L)
            close = torch.abs(denom) <= 1e-8 * torch.maximum(gm_l, gc)
            safe = torch.where(close, one, denom)
            f_neq = 1.0 - (gm_l[:, None] * e_c - gc[:, None] * e_m) \
                / safe[:, None]
            gbar = 0.5 * (gm_l + gc)
            arg = torch.clamp(gbar[:, None] * up, max=700.0)
            f_eq = -torch.expm1(-arg) - arg * torch.exp(-arg)
            cdf = torch.where(close[:, None], f_eq, f_neq)
            cdf = torch.where(u > 0.0, cdf, zero)
            # deterministic communication leg: pure compute CDF at u
            det = (p_ <= 0.0) | (tau_ <= 0.0)                   # (B, n)
            cdf = torch.where(det[:, None, :, None],
                              _shifted_exp_cdf(gc[:, None], u), cdf)
            cdf = torch.where(ell_e_ > 0.0, cdf, (u >= 0.0).to(dtype))
            return torch.where(load_ok[:, None], ell_e_ * cdf, neg_inf)

        def edge_returns_base(t):
            """Masked E[R_i(t; ell)] grid.  t: (B, T') -> (B, T', n, L)."""
            mix = torch.zeros(t.shape + (n, n_loads), dtype=dtype,
                              device=a.device)
            for i in range(ks.shape[0]):
                t_res = t[:, :, None] - ks_[i] * tau_[:, None, :]
                mix = mix + pmf[:, None, :, i, None] * _load_cdf(t_res)
            mix = torch.where(
                (mix >= pmf_total[:, None, :, None])
                & snap_ok[:, None, :, None], one, mix)
            # tau == 0 devices have no retransmission mixture: compute CDF
            nocomm = _load_cdf(t[:, :, None].expand(t.shape + (n,)))
            mix = torch.where(has_comm[:, None, :, None], mix, nocomm)
            return torch.where(load_ok[:, None], ell_e_ * mix, neg_inf)

        edge_returns = edge_returns_mec if mec_comm else edge_returns_base

        def server_returns(t):
            """Masked weighted server E[R(t; ell)].  (B, T') -> (B, T', Ls).

            srv_w discounts every parity row's value (1.0: exact)."""
            s = t[:, :, None] - s_shift[:, None, :]
            cdf = _shifted_exp_cdf(s_gamma[:, None], s)
            cdf = torch.where(ell_s_ > 0.0, cdf,
                              (t[:, :, None] >= 0.0).to(dtype))
            return torch.where(s_ok[:, None],
                               srv_w_[:, None, None] * ell_s_ * cdf, neg_inf)

        def best_agg(t):
            """Aggregate best return.  t: (B, T') -> (B, T')."""
            return edge_returns(t).amax(dim=-1).sum(dim=-1) \
                + server_returns(t).amax(dim=-1)

        return edge_returns, server_returns, best_agg

    def _search(best_agg, t_lo0, t_hi0_, target_, eps_, frac_, step0_frac):
        """Bracket-expand then grid-refine.  Returns (t_lo, t_hi, feasible).

        The bracket grows t_hi by a per-row step that doubles every
        iteration, starting at `step0_frac * t_hi` (1 = pure doubling
        from a cold start; the float64 polish passes eps)."""
        t_hi = t_hi0_
        step = step0_frac * t_hi0_
        agg = best_agg(t_hi0_[:, None])[:, 0]
        i = 0
        while i < MAX_DOUBLINGS and bool((agg < target_).any()):
            need = agg < target_
            t_new = torch.where(need, t_hi + step, t_hi)
            step = torch.where(need, 2.0 * step, step)
            agg = torch.where(need, best_agg(t_new[:, None])[:, 0], agg)
            t_hi = t_new
            i += 1
        feasible = agg >= target_

        def _active(t_lo, t_hi):
            wide = (t_hi - t_lo) > eps_ * torch.clamp(t_hi, min=1e-12)
            return wide & feasible

        t_lo = t_lo0
        r = 0
        while r < MAX_ROUNDS and bool(_active(t_lo, t_hi).any()):
            grid = t_lo[:, None] + frac_[None, :] * (t_hi - t_lo)[:, None]
            grid[:, -1] = t_hi  # exact upper edge: invariant
            ok = best_agg(grid) >= target_[:, None]
            idx = torch.argmax(ok.to(grid.dtype), dim=1)  # first over target
            hi_new = grid.gather(1, idx[:, None])[:, 0]
            prev = torch.clamp(idx - 1, min=0)
            lo_prev = grid.gather(1, prev[:, None])[:, 0]
            lo_new = torch.where(idx == 0, t_lo, lo_prev)
            act = _active(t_lo, t_hi)
            t_lo = torch.where(act, lo_new, t_lo)
            t_hi = torch.where(act, hi_new, t_hi)
            r += 1
        return t_lo, t_hi, feasible

    f64 = a.dtype
    # --- phase 1: float32 scout --------------------------------------------
    step0 = 1.0
    if search_f32:
        f32 = torch.float32
        _, _, best_agg32 = _make_returns(f32, ks_search, mask_search)
        lo32, hi32, _ = _search(
            best_agg32, torch.zeros_like(t_hi0, dtype=f32), t_hi0.to(f32),
            target.to(f32), torch.tensor(eps_rel, dtype=f32, device=a.device),
            frac.to(f32),
            1.0)
        t_lo0, t_hi0 = lo32.to(f64), hi32.to(f64)
        step0 = eps_rel
    else:
        t_lo0 = torch.zeros_like(t_hi0)

    # --- phase 2: float64 polish (re-brackets past the scout if needed) ----
    _, _, best_agg = _make_returns(f64, ks_search, mask_search)
    _, t_star, feasible = _search(
        best_agg, t_lo0, t_hi0, target,
        torch.tensor(eps_rel, dtype=f64, device=a.device), frac, step0)

    # --- recover loads / aggregate at t* (float64, half-ulp tail) ----------
    edge_returns, server_returns, _ = _make_returns(f64, ks_extract,
                                                    mask_extract)
    ev = edge_returns(t_star[:, None])[:, 0]                    # (B, n, L)
    loads = torch.argmax(ev, dim=-1)                            # (B, n)
    best = ev.gather(-1, loads[..., None])[..., 0]
    sv = server_returns(t_star[:, None])[:, 0]                  # (B, Ls)
    s_load = torch.argmax(sv, dim=-1)                           # (B,)
    s_best = sv.gather(1, s_load[:, None])[:, 0]
    agg = best.sum(dim=-1) + s_best
    return t_star, loads, s_load, agg, feasible


def _bucket(value: int, bucket: int) -> int:
    return max(bucket, -(-value // bucket) * bucket)


def _k_terms(p_max: float, tol: float = 5e-17) -> int:
    """Retransmission terms needed for a < `tol` negative-binomial tail
    (never beyond the reference's K_MAX; p = 0.1 needs 24 terms)."""
    ks = np.arange(2, 2 + K_MAX, dtype=np.float64)
    pmf = (ks - 1.0) * p_max ** (ks - 2.0) * (1.0 - p_max) ** 2
    tails = np.cumsum(pmf[::-1])[::-1]
    small = np.flatnonzero(tails < tol)
    k_eff = int(small[0]) + 1 if small.size else K_MAX
    return min(_bucket(k_eff, 8), K_MAX)


def solve_redundancy_batched(requests: Sequence[PlanRequest],
                             eps_rel: float = 1e-3,
                             grid_points: int = GRID_POINTS,
                             device=None) -> list[RedundancyPlan]:
    """Plan a whole sweep of fleets/budgets in one vectorized solve.

    Requests are grouped by (padded device count, edge_chunks, mec_comm);
    each group runs as one `(B, n)` solve on `device` (None: the CUDA
    device).
    Raises RuntimeError if any request's fleet cannot reach its target.
    """
    dev = resolve_device(device)
    requests = list(requests)
    plans: list[Optional[RedundancyPlan]] = [None] * len(requests)
    groups: dict[tuple[int, int, bool], list[int]] = {}
    for i, req in enumerate(requests):
        key = (_bucket(req.edge.n, _N_BUCKET), int(req.edge_chunks),
               bool(req.mec_comm))
        groups.setdefault(key, []).append(i)

    def f64(arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, dtype=np.float64), device=dev)

    frac = np.arange(1, grid_points + 1, dtype=np.float64) / grid_points

    for (n_pad, edge_chunks, mec_comm), idxs in groups.items():
        grp = [requests[i] for i in idxs]
        b = len(grp)

        def pad(vec, fill):
            out = np.full(n_pad, fill, dtype=np.float64)
            out[:vec.shape[0]] = vec
            return out

        a = np.stack([pad(r.edge.a, 1.0) for r in grp])
        mu = np.stack([pad(r.edge.mu, 1.0) for r in grp])
        tau = np.stack([pad(r.edge.tau, 0.0) for r in grp])
        p = np.stack([pad(r.edge.p, 0.0) for r in grp])
        caps = np.stack([pad(r.data_sizes.astype(np.float64), 0.0)
                         for r in grp]).astype(np.int64)
        srv_a = np.array([r.server.a[0] for r in grp])
        srv_mu = np.array([r.server.mu[0] for r in grp])
        srv_w = np.array([float(r.srv_weight) for r in grp])
        srv_cap = np.array([r.server_cap for r in grp], dtype=np.int64)
        target = np.array([float(r.m) for r in grp])
        t_hi0 = np.array([r.t_hi if r.t_hi is not None else r.default_t_hi()
                          for r in grp])

        l_edge = _bucket(int(caps.max()) + 1, _L_BUCKET)
        l_srv = _bucket(int(srv_cap.max()) + 1, _L_BUCKET)
        k_search = [_k_terms(float(r.edge.p.max()), tol=1e-12) for r in grp]
        k_extract = [_k_terms(float(r.edge.p.max())) for r in grp]

        def k_mask(k_effs):
            mask = np.zeros((b, max(k_effs)), dtype=np.float64)
            for j, k_eff in enumerate(k_effs):
                mask[j, :k_eff] = 1.0
            return mask

        # float32 search resolves t* to ~1e-6 relative; honor tighter eps
        # requests by keeping the whole solve in float64
        search_f32 = eps_rel >= 1e-5

        out = _solve_grid(
            f64(a), f64(mu), f64(tau), f64(p), f64(srv_a), f64(srv_mu),
            f64(srv_w), torch.as_tensor(caps, device=dev),
            torch.as_tensor(srv_cap, device=dev), f64(target), f64(t_hi0),
            float(eps_rel),
            torch.arange(l_edge, dtype=torch.float64, device=dev),
            torch.arange(l_srv, dtype=torch.float64, device=dev),
            torch.arange(2, 2 + max(k_search), dtype=torch.float64,
                         device=dev),
            torch.arange(2, 2 + max(k_extract), dtype=torch.float64,
                         device=dev),
            f64(k_mask(k_search)), f64(k_mask(k_extract)), f64(frac),
            search_f32=search_f32, edge_chunks=edge_chunks,
            mec_comm=mec_comm)
        t_star, loads, s_load, agg, feasible = \
            (o.cpu().numpy() for o in out)

        if not feasible.all():
            bad = np.flatnonzero(~feasible)
            detail = "; ".join(
                f"request {idxs[j]} (of the requests list): target "
                f"{target[j]:.0f}, best achievable {agg[j]:.1f}"
                for j in bad)
            raise RuntimeError(
                "cannot reach the aggregate expected return target — the "
                f"fleet cannot return the points in finite time: {detail}")

        for j, i in enumerate(idxs):
            req = requests[i]
            n = req.edge.n
            c = int(req.fixed_c) if req.fixed_c is not None \
                else int(s_load[j])
            dev_loads = loads[j, :n].astype(np.int64)
            # per-device return probs re-evaluated on the host: identical
            # to what every downstream consumer computes; MEC groups read
            # the MEC CDF (the server has no communication leg, so its
            # total_cdf is the same compute CDF either way)
            edge_cdf = mec_total_cdf if mec_comm else total_cdf
            p_return = np.append(
                edge_cdf(req.edge, dev_loads, float(t_star[j])),
                total_cdf(req.server, np.array([float(s_load[j])]),
                          float(t_star[j])))
            plans[i] = RedundancyPlan(
                loads=dev_loads,
                c=c,
                t_star=float(t_star[j]),
                p_return=p_return,
                expected_agg=float(agg[j]),
                loads_cap_total=req.m,
            )
    return plans
