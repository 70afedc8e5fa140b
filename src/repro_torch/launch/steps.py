"""Step functions shared by the launchers (counterpart of
`repro/launch/steps.py`): train, federated train, prefill and decode.

The train steps take the reference's defaults and return its metrics.
Gradients come from `torch.autograd.grad` over the parameter leaves
(`value_and_grad`); the optimizer then updates parameters and moments
leaf by leaf in place (`Optimizer.update_`), so a step returns the same
parameter tree and holds parameters, gradients and moments, not a second
copy of each.  The serve steps compute in the parameters' dtype (the
serving entry points run float32)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.fed.trainer import masked_loss
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer
from repro_torch.optim.schedules import clip_by_global_norm


def value_and_grad(loss_of: Callable, params: dict):
    """(loss, aux, grads) of `loss_of(params) -> (loss, aux)`: the
    gradient of every leaf, by `torch.autograd.grad` over detached leaves
    that share the parameters' storage (the parameters themselves need
    not require grad)."""
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss, aux = loss_of(tree.unflatten(params, live))
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), aux, tree.unflatten(params, list(grads))


def make_train_step(cfg: ArchConfig, opt: Optimizer,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    remat=True, clip_norm: float = 0.0,
                    lr_schedule: Callable | None = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters updated in place.

    clip_norm > 0 enables global-norm gradient clipping (metrics gain
    "grad_norm"); lr_schedule(step) scales the optimizer's base lr
    (repro_torch.optim.schedules), read from the state's step on the
    device.  A moe model's metrics also carry "moe_aux_loss"."""

    def train_step(params, opt_state, batch):
        loss, aux, grads = value_and_grad(
            lambda p: T.loss_fn(cfg, p, batch, compute_dtype=compute_dtype,
                                remat=remat), params)
        metrics = {"loss": loss}
        if clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics["grad_norm"] = gnorm
        scale = (lr_schedule(opt_state.step) if lr_schedule is not None
                 else 1.0)
        opt_state = opt.update_(grads, opt_state, params, lr_scale=scale)
        if "moe_aux_loss" in aux:
            metrics["moe_aux_loss"] = aux["moe_aux_loss"].detach()
        return params, opt_state, metrics

    return train_step


def make_fed_grad_fn(cfg: ArchConfig,
                     compute_dtype: torch.dtype = torch.float32,
                     remat=False) -> Callable:
    """`grad_fn(params, batch, seq_weights) -> (loss, grads)` of the
    deadline-masked federated loss, the `grad_fn` of `fed.trainer`:
    per-sequence mean NLLs through `fed.trainer.masked_loss` (weighted
    by seq_weights, 0 for dropped clients and 1/p for received, over
    max(#(w > 0), 1)), plus 0.01 x the MoE aux loss of the whole batch's
    forward where the model has one, as the reference's federated step."""

    def grad_fn(params, batch, seq_weights):
        def loss_of(p):
            aux = {}

            def per_seq(q, b):
                logits, a = T.forward_train(cfg, q, b,
                                            compute_dtype=compute_dtype,
                                            remat=remat)
                aux.update(a)
                return torch.mean(T.token_nll(logits, b["targets"]), dim=-1)

            loss = masked_loss(per_seq, p, batch, seq_weights)
            if "moe_aux_loss" in aux:
                loss = loss + 0.01 * aux["moe_aux_loss"]
            return loss, aux

        loss, _, grads = value_and_grad(loss_of, params)
        return loss, grads

    return grad_fn


def make_fed_train_step(cfg: ArchConfig, opt: Optimizer,
                        compute_dtype: torch.dtype = torch.float32,
                        remat=False) -> Callable:
    """Deadline-masked federated step, (params, opt_state, batch,
    seq_weights) -> (params, opt_state, {"loss"}): per-sequence weights
    (0 for dropped clients, 1/p for received) make the aggregate unbiased
    (repro_torch.fed)."""
    grad_fn = make_fed_grad_fn(cfg, compute_dtype, remat)

    def step(params, opt_state, batch, seq_weights):
        loss, grads = grad_fn(params, batch, seq_weights)
        opt_state = opt.update_(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return step


def make_prefill_step(cfg: ArchConfig,
                      cache_len: int | None = None) -> Callable:
    """`cache_len` reserves KV slots beyond the prompt for the decode
    steps (the dense family; the ssm family ignores it)."""
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, batch, cache):
        return T.decode_step(cfg, params, batch, cache)
    return serve_step
