"""Straggler-aware federated training for arbitrary (non-linear) models
(counterpart of `repro/fed/trainer.py`).

The paper's exact parity-gradient identity needs a linear model + squared
loss, so for the deep models of the zoo the trainer carries the
*protocol-level* parts of CFL, which are model-agnostic:

  1. **Load allocation (Eqs. 14-16)** — each client's per-round microbatch
     ell*_i is chosen to maximize its expected return by the deadline, and
     the deadline t* is the smallest that covers the global batch in
     expectation.  Here a "data point" is one training sequence.
  2. **Deadline-masked aggregation** — per round, each client's sampled
     T_i <= t* decides whether its partial gradient lands; missing clients
     are compensated by inverse-probability (1/p_i) importance scaling so
     the aggregate stays unbiased.

The plan and the arrivals are host NumPy over the port's
`core.returns.optimal_loads` and `core.delay_model`, bit-equal to the
reference's for the same fleet and generator.  One `grad_fn(params,
batch, seq_weights) -> (loss, grads)` (torch tensors; e.g.
`launch.steps.make_fed_grad_fn`) serves every round: client
contributions enter as a weighted per-sequence mask, so the backward pass
is a single masked batch gradient.  The optimizer updates the parameters
in place (`Optimizer.update_`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.delay_model import (DeviceDelayParams, sample_total,
                                          total_cdf)
from repro_torch.core.redundancy import RedundancyPlan
from repro_torch.core.returns import optimal_loads
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Optimizer


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int
    sequences_per_client: int       # local dataset size (in sequences)
    target_sequences: int           # global batch the server wants per round
    deadline_quantile: float = 1.0  # scale t* (1.0 = Eq. 16 deadline)
    min_return_prob: float = 1e-3   # clients below this are never scheduled
                                    # AND the importance-weight clip floor


@dataclasses.dataclass
class FedState:
    plan: RedundancyPlan
    p_return: np.ndarray            # (n,) Pr{T_i <= t*}
    edge: DeviceDelayParams
    min_return_prob: float          # from FedConfig (see round_weights)
    round_idx: int = 0
    wall_clock: float = 0.0


def fed_setup(edge: DeviceDelayParams, cfg: FedConfig) -> FedState:
    """Run the Eq. 14-16 load allocation over sequences-as-points.

    No parity for non-linear models: redundancy c is 0 and the aggregate
    return target is the requested global batch, capped at what the
    clients hold; t* comes from a bisection over `optimal_loads`."""
    sizes = np.full(cfg.n_clients, cfg.sequences_per_client, dtype=np.int64)
    target = min(cfg.target_sequences, int(sizes.sum()))
    plan = _solve_loads(edge, sizes, target)
    p = total_cdf(edge, plan.loads, plan.t_star)
    return FedState(plan=plan, p_return=p, edge=edge,
                    min_return_prob=cfg.min_return_prob)


def _solve_loads(edge: DeviceDelayParams, sizes: np.ndarray,
                 target: int) -> RedundancyPlan:
    t_hi = float(np.max(edge.mean_total(sizes))) + 1.0
    loads, vals = optimal_loads(edge, sizes, t_hi)
    guard = 0
    while float(vals.sum()) < target:
        t_hi *= 2
        loads, vals = optimal_loads(edge, sizes, t_hi)
        guard += 1
        if guard > 60:
            raise RuntimeError("fleet cannot reach the target batch")
    t_lo = 0.0
    for _ in range(48):
        t_mid = 0.5 * (t_lo + t_hi)
        l_mid, v_mid = optimal_loads(edge, sizes, t_mid)
        if float(v_mid.sum()) >= target:
            t_hi, loads, vals = t_mid, l_mid, v_mid
        else:
            t_lo = t_mid
        if t_hi - t_lo < 1e-4 * max(t_hi, 1e-9):
            break
    probs = total_cdf(edge, loads, t_hi)
    return RedundancyPlan(loads=loads, c=0, t_star=float(t_hi),
                          p_return=np.append(probs, 1.0),
                          expected_agg=float(vals.sum()),
                          loads_cap_total=int(sizes.sum()))


def masked_loss(loss_per_seq_fn: Callable, params, batch: dict,
                seq_weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean of per-sequence losses.

    loss_per_seq_fn(params, batch) -> (B,) per-sequence losses;
    seq_weights: (B,) — 0 for dropped/straggling sequences, 1/p_i for
    received ones (importance-scaled, unbiased)."""
    per_seq = loss_per_seq_fn(params, batch)
    denom = torch.clamp(torch.sum(seq_weights > 0), min=1)
    return torch.sum(per_seq * seq_weights) / denom


def _round_client_weights(state: FedState,
                          rng: np.random.Generator) -> np.ndarray:
    """One round's per-client importance weights: 0 (dropped) or 1/p_i.

    Clients whose return probability is below `state.min_return_prob`
    (FedConfig.min_return_prob) are never scheduled: their gradients are
    dropped even if the sampled delay lands, and the same floor clips the
    importance weights so a barely-returning client cannot blow up the
    aggregate with a near-infinite 1/p_i."""
    t_i = sample_total(state.edge, state.plan.loads, rng)
    scheduled = state.p_return >= state.min_return_prob
    received = (t_i <= state.plan.t_star) & (state.plan.loads > 0) & scheduled
    p = np.clip(state.p_return, state.min_return_prob, 1.0)
    return np.where(received, 1.0 / p, 0.0)            # unbiased masking


def round_weights(state: FedState, rng: np.random.Generator,
                  batch_clients: np.ndarray) -> tuple[np.ndarray, float]:
    """Sample one round's arrivals.

    batch_clients: (B,) client id of each sequence in the global batch
    (sequences are laid out client-major along the batch).
    Returns (seq_weights (B,), round wall time = t*)."""
    w_client = _round_client_weights(state, rng)
    return w_client[batch_clients], float(state.plan.t_star)


def presample_round_weights(state: FedState, rng: np.random.Generator,
                            n_rounds: int) -> np.ndarray:
    """Pre-sample every round's per-client weights up front: (rounds, n),
    in the generator order of per-round `round_weights` calls, so the
    training loop itself touches no NumPy sampling."""
    return np.stack([_round_client_weights(state, rng)
                     for _ in range(n_rounds)])


def _params_device(params) -> torch.device:
    return tree.leaves(params)[0].device


def _apply_round(state: FedState, grad_fn, params, opt: Optimizer,
                 opt_state, batch: dict, seq_weights: np.ndarray):
    """Masked-gradient update for one round's (pre)sampled weights; the
    parameters are updated in place.  Returns (params, opt_state, loss)."""
    w = torch.as_tensor(np.asarray(seq_weights, dtype=np.float32)).to(
        _params_device(params))
    loss, grads = grad_fn(params, batch, w)
    opt_state = opt.update_(grads, opt_state, params)
    state.round_idx += 1
    state.wall_clock += float(state.plan.t_star)
    return params, opt_state, float(loss)


def fed_round(state: FedState, grad_fn, params, opt: Optimizer, opt_state,
              batch: dict, batch_clients: np.ndarray,
              rng: np.random.Generator):
    """One synchronous round: sample arrivals, masked gradient, update."""
    w, _ = round_weights(state, rng, batch_clients)
    return _apply_round(state, grad_fn, params, opt, opt_state, batch, w)


def fed_train(state: FedState, grad_fn, params, opt: Optimizer,
              batches: Iterator[tuple[dict, np.ndarray]], n_rounds: int,
              seed: int = 0, log_every: int = 0,
              device: str | torch.device | None = None):
    """Run n_rounds of federated training on `device` (the card by
    default; the parameters must live there); returns (params, losses).

    All per-round arrival randomness is pre-sampled up front
    (`presample_round_weights`, same draw order as per-round sampling), so
    the loop body is model work and one read-back of the loss a round."""
    dev = resolve_device(device)
    if _params_device(params) != dev:
        raise ValueError(f"parameters are on {_params_device(params)}, the "
                         f"run is on {dev}")
    rng = np.random.default_rng(seed)
    opt_state = opt.init(params)
    w_rounds = presample_round_weights(state, rng, n_rounds)  # (rounds, n)
    losses = []
    for r in range(n_rounds):
        batch, batch_clients = next(batches)
        params, opt_state, loss = _apply_round(
            state, grad_fn, params, opt, opt_state, batch,
            w_rounds[r][batch_clients])
        losses.append(loss)
        if log_every and (r + 1) % log_every == 0:
            print(f"round {r+1}: loss {loss:.4f} "
                  f"wall {state.wall_clock:.1f}s")
    return params, losses
