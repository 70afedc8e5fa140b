"""Minimal optimizer library (counterpart of `repro/optim/optimizers.py`).

An optimizer is a pair of functions over parameter trees
(`repro_torch.tree`): `init(params) -> OptState` and
`update(grads, state, params, lr_scale=1.0) -> (updates, state)`, the
reference's API, plus `update_(grads, state, params, lr_scale=1.0) ->
state`, which applies the same update leaf by leaf in place (parameters
and moments) under `torch.no_grad()`, so a training step holds
parameters, gradients and moments and one leaf's temporaries, not a
second copy of each tree.  Both compute each leaf's update with the same
expressions.

The formulas are the reference's, not `torch.optim`'s: AdamW's update is
-lr (m^ / (sqrt(v^) + eps) + wd p) with m^ = m / (1 - b1^t) and
v^ = v / (1 - b2^t), the bias corrections taken in float32 from a
float32 step count, and the parameters updated as (p.float() + u) cast
to their dtype.  Moments may be kept in bf16 (`state_dtype`); the
arithmetic is float32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import tree

F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor      # () int32, on the parameters' device
    mu: Optional[dict]      # first moment / momentum (None for plain SGD)
    nu: Optional[dict]      # second moment (Adam only)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], OptState]
    update: Callable[..., tuple[dict, OptState]]
    update_: Callable[..., OptState]


def _zeros_like_dtype(params: dict, dtype: Optional[torch.dtype]) -> dict:
    return tree.tree_map(lambda p: torch.zeros_like(p, dtype=dtype or p.dtype),
                         params)


def _step0(params: dict) -> torch.Tensor:
    first = tree.leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


def _apply(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (p.to(F32) + u).to(p.dtype)


def _make(init: Callable, context: Callable, leaf_update: Callable,
          n_moments: int) -> Optimizer:
    """An Optimizer from `context(state, lr_scale) -> (ctx, new step)`,
    taken once a step, and `leaf_update(g, p, moments, ctx) -> (u, new
    moments)`, taken for each leaf."""
    def columns(grads, state, params):
        trees = [grads, params, *(state.mu, state.nu)[:n_moments]]
        return zip(*(tree.leaves(t) for t in trees))

    def update(grads, state, params, lr_scale=1.0):
        ctx, step = context(state, lr_scale)
        outs = [leaf_update(g, p, ms, ctx)
                for g, p, *ms in columns(grads, state, params)]
        updates = tree.unflatten(grads, [u for u, _ in outs])
        moments = [tree.unflatten(m, [new[i] for _, new in outs])
                   for i, m in enumerate((state.mu, state.nu)[:n_moments])]
        moments += [None] * (2 - n_moments)
        return updates, OptState(step, *moments)

    @torch.no_grad()
    def update_(grads, state, params, lr_scale=1.0):
        ctx, step = context(state, lr_scale)
        for g, p, *ms in columns(grads, state, params):
            u, new = leaf_update(g, p, ms, ctx)
            for m, m_new in zip(ms, new):
                m.copy_(m_new)
            p.copy_(_apply(p, u))
        return OptState(step, state.mu, state.nu)

    return Optimizer(init, update, update_)


def sgd(lr: float, momentum: float = 0.0,
        state_dtype: Optional[torch.dtype] = None) -> Optimizer:
    def init(params):
        mu = _zeros_like_dtype(params, state_dtype) if momentum else None
        return OptState(_step0(params), mu, None)

    def context(state, lr_scale):
        return lr * lr_scale, state.step + 1

    def leaf_update(g, p, moments, step_lr):
        if momentum:
            m = moments[0]
            m_new = (momentum * m.to(F32) + g.to(F32)).to(m.dtype)
            return -step_lr * m_new.to(F32), [m_new]
        return -step_lr * g.to(F32), []

    return _make(init, context, leaf_update, 1 if momentum else 0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          state_dtype: Optional[torch.dtype] = None) -> Optimizer:
    """AdamW.  `state_dtype=torch.bfloat16` halves optimizer memory."""
    def init(params):
        return OptState(_step0(params), _zeros_like_dtype(params, state_dtype),
                        _zeros_like_dtype(params, state_dtype))

    def context(state, lr_scale):
        step = state.step + 1
        t = step.to(F32)
        # b ** t in float32, as the reference (a float64 power rounds
        # differently)
        c1 = 1.0 - torch.pow(t.new_full((), b1), t)
        c2 = 1.0 - torch.pow(t.new_full((), b2), t)
        return (c1, c2, lr * lr_scale), step

    def leaf_update(g, p, moments, ctx):
        m, v = moments
        c1, c2, step_lr = ctx
        g32 = g.to(F32)
        m32 = b1 * m.to(F32) + (1 - b1) * g32
        v32 = b2 * v.to(F32) + (1 - b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        u = -step_lr * (mhat / (torch.sqrt(vhat) + eps)
                        + weight_decay * p.to(F32))
        return u, [m32.to(m.dtype), v32.to(v.dtype)]

    return _make(init, context, leaf_update, 2)


def apply_updates(params: dict, updates: dict) -> dict:
    return tree.tree_map(_apply, params, updates)


def init_opt_state(opt: Optimizer, params: dict) -> OptState:
    return opt.init(params)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
