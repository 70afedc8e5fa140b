"""Coded federated learning of a linear head (the CFL paper, §III-§IV),
in float64: the uncoded baseline that waits for every straggler, and the
coded run, on the same features.

  * Fleet (§IV): client i computes at MAC rate (1 - nu)^k 1536 KMAC/s and
    sends at (1 - nu)^k 216 kbit/s over links that erase a packet with
    probability 0.1 (the ladders randomly assigned); the server computes
    10x faster than the fastest client and has no link.
  * Plan at a fixed redundancy c (Eqs. 14-16): each device's load is the
    integer argmax of ell Pr{T <= t*} up to its data (the server's up to
    c); t* is the smallest deadline whose expected aggregate return
    reaches the m = n ell points.
  * Encoding (Eq. 17): client i weighs its first ell*_i points by
    sqrt(1 - Pr{T_i <= t*}), the rest by 1, and sends G_i W_i [X_i y_i]
    with G_i its i-th (c, ell) N(0, 1) draw from the generator seeded
    `key` on the device.
  * Epochs (Eqs. 18-19, 3): the gradient of the arrived clients' first
    ell*_i points, plus the parity gradient X~^T (X~ b - y~) / c when the
    server's T <= t*; the uncoded run takes the full gradient and lasts
    the slowest client's T.  b <- b - (lr / m) g from b = 0, and the NMSE
    ||b - b*||^2 / ||b*||^2 after each epoch.
  * Draws, from one NumPy generator: the uncoded run's T's, epoch by
    epoch; then the coded run's one-time upload retransmissions, then
    each epoch's clients' T's and the server's.
"""
from __future__ import annotations

import numpy as np
import torch

from cfl_bench import traffic
from cfl_bench.reference import fedplan

F64 = torch.float64


def fleet(n: int, d: int, nu: float, seed: int) -> tuple[dict, dict]:
    edge = traffic.paper_edge(seed, n, d, nu, nu)
    a_s = edge["a"].min() / 10.0
    server = {"a": np.array([a_s]), "mu": np.array([2.0 / a_s]),
              "tau": np.zeros(1), "p": np.zeros(1)}
    return edge, server


def _join(edge: dict, server: dict) -> dict:
    return {k: np.concatenate([edge[k], server[k]]) for k in edge}


def least_deadline(edge: dict, server: dict, ell: int, c: int) -> float:
    """The smallest t at which the expected return of every device at its
    best load (the server's capped at c) reaches n ell, to 1e-12."""
    both = _join(edge, server)
    caps = np.append(np.full(edge["a"].size, ell), c)
    m = ell * edge["a"].size
    lo, hi = 0.0, 1.0
    while fedplan.best_loads(both, caps, hi)[1].sum() < m:
        hi *= 2
    while hi - lo > 1e-12 * hi:
        mid = 0.5 * (lo + hi)
        if fedplan.best_loads(both, caps, mid)[1].sum() >= m:
            hi = mid
        else:
            lo = mid
    return hi


def heads(feats: torch.Tensor, ys: torch.Tensor, beta_true: torch.Tensor,
          t_star: float, setting: dict, epochs: int) -> dict:
    """Both runs on features (n, ell, d) and targets (n, ell) at the
    deadline `t_star`; returns each run's NMSE trace, times and final
    head ({"uncoded", "cfl"}), in float64 on the features' device."""
    n, ell, d = feats.shape
    m, c = n * ell, int(setting["parity_share"] * n * ell)
    dev = feats.device
    edge, server = fleet(n, d, setting["nu"], setting["fleet_seed"])
    gen = np.random.default_rng(setting["arrival_seed"])
    x = feats.to(F64).reshape(m, d)
    y = ys.to(F64).reshape(m)
    b_true = beta_true.to(F64)
    lr_m = float(np.float32(setting["lr"]) / np.float32(m))

    def run(grad, durations):
        b = torch.zeros(d, dtype=F64, device=dev)
        nmse = [1.0]
        for e in range(epochs):
            b = b - lr_m * grad(e, b)
            nmse.append(float(((b - b_true) ** 2).sum() / (b_true ** 2).sum()))
        return {"nmse": np.array(nmse), "beta": b,
                "times": np.concatenate([[0.0], np.cumsum(durations)])}

    full = np.full(n, ell)
    slowest = np.array([fedplan.sample_total(edge, full, gen).max()
                        for _ in range(epochs)])
    out = {"uncoded": run(lambda e, b: (x @ b - y) @ x, slowest)}

    loads = fedplan.best_loads(_join(edge, server),
                               np.append(full, c), t_star)[0][:n]
    p_ret = fedplan.return_prob(edge, loads, t_star)
    gen.geometric(1.0 - edge["p"], size=n)   # the parity upload's draw
    arrived = np.empty((epochs, n))
    parity_ok = np.empty(epochs)
    for e in range(epochs):
        arrived[e] = (fedplan.sample_total(edge, loads, gen) <= t_star) \
            & (loads > 0)
        parity_ok[e] = fedplan.sample_total(server, [c], gen)[0] <= t_star
    load_mask = torch.as_tensor(np.arange(ell)[None, :] < loads[:, None],
                                device=dev)
    w = torch.where(load_mask, torch.as_tensor(
        np.sqrt(np.maximum(0.0, 1.0 - p_ret)), device=dev)[:, None], 1.0)
    g = torch.Generator(device=dev).manual_seed(setting["key"])
    xa = torch.cat([feats.to(F64), ys.to(F64)[..., None]], dim=-1)
    parity = sum(torch.randn((c, ell), generator=g, device=dev).to(F64)
                 @ (w[i, :, None] * xa[i]) for i in range(n))
    xp, yp = parity[:, :d], parity[:, d]
    rows = load_mask.reshape(m).to(F64)
    client = torch.arange(n, device=dev).repeat_interleave(ell)
    got = torch.as_tensor(arrived, device=dev)

    def coded(e, b):
        r = (x @ b - y) * rows * got[e][client]
        g_e = r @ x
        if parity_ok[e]:
            g_e = g_e + (xp @ b - yp) @ xp / c
        return g_e

    out["cfl"] = run(coded, np.full(epochs, t_star))
    return out
