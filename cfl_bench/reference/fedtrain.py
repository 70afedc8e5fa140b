"""Plain federated training steps: the deadline-masked loss (each
sequence's mean next-token NLL, weighted 0 or 1/p by its client's
arrival, summed over the number of sequences that count), its gradient
by autograd, and AdamW (Loshchilov and Hutter; bias-corrected moments,
decoupled weight decay) on every leaf."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def masked_loss(logits: torch.Tensor, targets: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    nll = F.cross_entropy(logits.transpose(1, 2), targets, reduction="none")
    per_seq = nll.mean(-1)
    return (per_seq * weights).sum() / (weights > 0).sum().clamp(min=1)


def flat(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += flat(v, f"{prefix}{k}/") if isinstance(v, dict) \
            else [(prefix + k, v)]
    return out


def train(forward: Callable, make_params: Callable, batches: list,
          weights: list, opt: dict, steps: int,
          fault: str | None = None) -> dict:
    """`steps` AdamW steps from `make_params()` on `batches[k]`
    ({"tokens", "targets"} on the device) at per-sequence `weights[k]`.

    Returns {"losses", "grad_norms" (each leaf's at step 1), "change_norms"
    (each leaf's ||p_steps - p_0||)}, by leaf path.  `fault` plants a
    fault for the checks' upper readings: "half" drops the second half of
    every batch (the loss is the mean over the rest), "frozen" leaves the
    parameters unchanged."""
    params = make_params()
    leaves = flat(params)
    for _, p in leaves:
        p.requires_grad_(True)
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for _, p in leaves]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["lr"], opt.get("weight_decay", 0.0)
    losses, grad_norms = [], {}
    for k in range(steps):
        w = weights[k].clone()
        if fault == "half":
            w[w.shape[0] // 2:] = 0
        loss = masked_loss(forward(params, batches[k]["tokens"]),
                           batches[k]["targets"], w)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        losses.append(float(loss.detach()))
        if k == 0:
            grad_norms = {n: float(g.norm()) for (n, _), g in
                          zip(leaves, grads)}
        if fault == "frozen":
            continue
        c1, c2 = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
        with torch.no_grad():
            for (_, p), (m, v), g in zip(leaves, moments, grads):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr * ((m / c1) / ((v / c2).sqrt() + eps) + wd * p))
        del grads
    del moments
    start = dict(flat(make_params()))
    with torch.no_grad():
        change = {n: float((p - start[n]).norm()) for n, p in leaves}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
