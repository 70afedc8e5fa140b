"""Gradient computation & straggler-masked aggregation (paper §II, §III-D).

The counterpart of `repro/core/aggregation.py` (the parts the §IV path
runs).  Two gradient sources arrive at the server each epoch:

  * systematic partial gradients over each client's first ell*_i points;
    only clients with T_i <= t* arrive (a row weight of 0 otherwise),
  * the parity gradient the server computes on the composite parity data,
    g_par = (1/c) X~^T (X~ beta - y~)                            (Eq. 18).

`path` picks how the round gradient is computed:

  REFERENCE — the two-pass torch expressions (residual, then the weighted
    back-contraction), the oracle the fused path is held against;
  FUSED     — one pass over X: on a CUDA tensor `round_gradient`,
    `coded_round_gradient` and `tiered_round_gradient` launch the
    hand-written kernels of `kernels.round_grad` (flat, coded, tier-
    masked); on a CPU tensor the kernel wrappers compute their plain
    versions.  Strategies feed them the packed systematic rows and
    Gram-folded parity of `core.cfl.fused_coded_device_state`.

The legacy per-epoch form (`core.cfl.epoch_gradient`) keeps the two
sources apart: `client_partial_gradients` per client, `parity_gradient`
(the least-squares gradient wrapper, which launches its kernel on a CUDA
tensor; `use_kernel=False` keeps the plain two-pass expression), then
`combine` over the arrival masks.

The hierarchical (edge -> cloud) form of the round gradient is a
per-tier reduce and a cross-tier combine: `tier_reduce` computes each
tier partial as the full-width masked gemv, tiers in sequence, so a
masked-out row adds an exact 0 and each partial is the flat contraction
restricted to its tier; `cross_tier_combine` sums the T partials in
order and is the identity at T = 1, so a single-tier fleet is bit-equal
to the flat path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.round_grad import ops as rg_ops

FUSED = "fused"
REFERENCE = "reference"
GRAD_PATHS = (FUSED, REFERENCE)


def resolve_grad_path(path: str, use_kernel: bool = False) -> str:
    """Validate a strategy's `grad_path`, folding in the `use_kernel` flag
    (use_kernel=True forces the fused path, as in the reference)."""
    if path not in GRAD_PATHS:
        raise ValueError(
            f"grad_path must be one of {GRAD_PATHS}, got {path!r}")
    return FUSED if use_kernel else path


def round_gradient(x: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                   w: torch.Tensor | None = None,
                   path: str = REFERENCE) -> torch.Tensor:
    """g = (w * (X beta - y)) @ X — the flat round gradient.

    The fused path goes through the round-gradient kernel wrapper (one
    pass over X on the card); the reference path is the two-pass
    expression."""
    if path == FUSED:
        return rg_ops.masked_round_gradient(x, y, w, beta)
    resid = x @ beta - y
    if w is None:
        return resid @ x
    return (resid * w) @ x


def coded_round_gradient(x: torch.Tensor, y: torch.Tensor,
                         w: torch.Tensor | None, x_par: torch.Tensor,
                         y_par: torch.Tensor, w_par,
                         beta: torch.Tensor,
                         path: str = REFERENCE) -> torch.Tensor:
    """Systematic + parity round gradient with per-row parity weights
    (Eq. 18's 1/(c*rho) normalization folded into w_par, which may be a
    scalar).  The fused path is one launch over both row streams on the
    card (the flat kernel when the parity block is empty)."""
    if path == FUSED:
        return rg_ops.coded_round_gradient(x, y, w, x_par, y_par, w_par,
                                           beta)
    g_sys = round_gradient(x, y, beta, w=w)
    g_par = ((x_par @ beta - y_par) * w_par) @ x_par
    return g_sys + g_par


def tiered_round_gradient(x: torch.Tensor, y: torch.Tensor,
                          beta: torch.Tensor, w: torch.Tensor | None,
                          tier_masks: torch.Tensor,
                          path: str = REFERENCE) -> torch.Tensor:
    """(T, d) tier partials of the masked round gradient — the fleet
    layer's edge stage.  Reference path: the residual once, then
    `tier_reduce`; fused path: one pass over X shared by all tiers on
    the card, bit-equal to the flat kernel at T = 1."""
    if path == FUSED:
        return rg_ops.tier_masked_round_gradient(x, y, w, tier_masks, beta)
    resid = x @ beta - y
    contrib = resid if w is None else resid * w
    return tier_reduce(contrib, x, tier_masks)


def tier_reduce(contrib: torch.Tensor, x: torch.Tensor,
                tier_masks: torch.Tensor) -> torch.Tensor:
    """(T, m) row masks x (m,) contrib x (m, d) x -> (T, d) tier partials,
    each the full-width masked gemv (contrib * mask_t) @ x, tier after
    tier: with 0/1 masks each partial equals the flat contraction with
    the other tiers' terms replaced by exact zeros."""
    return torch.stack([(contrib * mask) @ x for mask in tier_masks])


def cross_tier_combine(tier_partials: torch.Tensor) -> torch.Tensor:
    """(T, d) tier partials -> (d,) server aggregate: a sequential T-term
    sum in tier order, the only reassociation the hierarchy adds.  T == 1
    is the identity."""
    acc = tier_partials[0]
    for t in range(1, tier_partials.shape[0]):
        acc = acc + tier_partials[t]
    return acc


def fused_tier_masks(dev: dict, tier_masks: torch.Tensor) -> torch.Tensor:
    """(T, m) tier row masks gathered to the fused layout's rows: the
    packed layout selects its support columns, the dense one keeps the
    full-width masks."""
    if "sys_rows" in dev:
        return tier_masks.index_select(1, dev["sys_rows"])
    return tier_masks


def parity_gram(x_par: torch.Tensor, y_par: torch.Tensor):
    """Normal-equation factors of the parity block, computed ONCE at plan
    time: G = X~^T X~ (d, d) and b = y~ X~ (d,).  Eq. 18 then collapses to
    (G beta - b) / c — no pass over the (c, d) parity rows per epoch.
    A plain product outside any kernel, as in the reference."""
    return x_par.T @ x_par, y_par @ x_par


def gram_parity_gradient(gram: torch.Tensor, gramy: torch.Tensor,
                         beta: torch.Tensor, c_norm) -> torch.Tensor:
    """(G beta - b) / c_norm == Eq. 18 through precomputed Gram factors."""
    return (gram @ beta - gramy) / c_norm


def fused_sys_block(dev: dict) -> tuple:
    """(x, y, base_w, client_ids) of the fused systematic block, for both
    layouts of `core.cfl.fused_coded_device_state`: packed ("sys_*" keys)
    or the dense fallback (full rows, load mask as the base weight)."""
    if "sys_x" in dev:
        return (dev["sys_x"], dev["sys_y"], dev["sys_w"],
                dev["sys_client"])
    return dev["x"], dev["y"], dev["sys_w"], dev["row_client"]


def fused_coded_gradient(dev: dict, w: torch.Tensor, parity_gate,
                         beta: torch.Tensor) -> torch.Tensor:
    """The static-parity fused round: systematic rows through the fused
    `round_gradient` plus the Gram-folded parity matvec, gated by the
    scalar parity arrival.  The Eq.-18 divisor rides in as `par_c`."""
    x, y, _, _ = fused_sys_block(dev)
    g_sys = round_gradient(x, y, beta, w=w, path=FUSED)
    g_par = gram_parity_gradient(dev["par_gram"], dev["par_gramy"], beta,
                                 dev["par_c"])
    return g_sys + parity_gate * g_par


def client_partial_gradients(xs: torch.Tensor, ys: torch.Tensor,
                             load_mask: torch.Tensor,
                             beta: torch.Tensor) -> torch.Tensor:
    """Per-client partial gradients over their systematic loads.

    xs: (n, ell, d), ys: (n, ell); load_mask: (n, ell) 1.0 on the points
    each client processes (its first ell*_i), 0.0 on punctured points.
    Returns (n, d)."""
    resid = (torch.einsum("nld,d->nl", xs, beta) - ys) * load_mask
    return torch.einsum("nld,nl->nd", xs, resid)


def parity_gradient(x_par: torch.Tensor, y_par: torch.Tensor,
                    beta: torch.Tensor,
                    use_kernel: bool = True) -> torch.Tensor:
    """(1/c) X~^T (X~ beta - y~) — the server's redundant gradient (Eq. 18).

    use_kernel (the default): through the least-squares gradient wrapper,
    which makes one pass over X~ in its kernel on a CUDA tensor and
    computes its plain version on a CPU tensor; False: the plain two-pass
    expression on any device (the reference's `use_kernel=False`)."""
    if use_kernel:
        g = rg_ops.lsq_gradient(x_par, y_par, beta)
    else:
        g = (x_par @ beta - y_par) @ x_par
    return g / x_par.shape[0]


def combine(partial_grads: torch.Tensor, received: torch.Tensor,
            g_parity: torch.Tensor, parity_received) -> torch.Tensor:
    """Deadline-masked combination of both gradient sources (Eqs. 18-19).

    partial_grads: (n, d) per-client systematic gradients; received: (n,)
    {0,1}, client i's gradient arrived by t*; g_parity: (d,);
    parity_received: scalar {0,1}, the server's own parity computation
    finished by t*."""
    g_sys = torch.einsum("nd,n->d", partial_grads, received)
    return g_sys + parity_received * g_parity


def uncoded_full_gradient(xs: torch.Tensor, ys: torch.Tensor,
                          beta: torch.Tensor) -> torch.Tensor:
    """Baseline uncoded FL gradient: every client, every point (Eq. 2),
    over the flattened (m, d) layout."""
    x = xs.reshape(-1, xs.shape[-1])
    resid = x @ beta - ys.reshape(-1)
    return resid @ x


def gd_update(beta: torch.Tensor, grad: torch.Tensor, lr: torch.Tensor,
              m: int) -> torch.Tensor:
    """beta <- beta - (mu/m) * grad  (Eq. 3).  `lr` is a float32 tensor, so
    lr/m rounds in float32 as in the reference."""
    return beta - (lr / m) * grad


def nmse(beta_hat: torch.Tensor, beta_true: torch.Tensor) -> torch.Tensor:
    """Normalized mean-square error ||b^ - b||^2 / ||b||^2 (paper §IV)."""
    return torch.sum((beta_hat - beta_true) ** 2) / torch.sum(beta_true ** 2)
