"""Gradient coding baseline (Tandon et al., ICML 2017 — the paper's ref
[5]); counterpart of `repro/core/gradient_coding.py`.

With replication factor r, the "fractional repetition" construction
splits the n clients into n/r groups of r (r | n); each group member
holds the whole group's data and returns the group-sum gradient, and the
server recovers the exact full gradient once every group has >= 1
returner (it tolerates r - 1 stragglers per group).  Each client computes
over r shards, and the data sharing is a one-time raw-data transfer.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.core.delay_model import sample_total

if TYPE_CHECKING:
    from repro_torch.api.report import TraceReport
    from repro_torch.sim.network import FleetSpec


@dataclasses.dataclass(frozen=True)
class GradCodingPlan:
    r: int                  # replication factor
    groups: np.ndarray      # (n,) group id of each client

    @property
    def tolerated_stragglers_per_group(self) -> int:
        return self.r - 1


def make_plan(n_clients: int, r: int) -> GradCodingPlan:
    if n_clients % r != 0:
        raise ValueError(f"fractional repetition needs r | n "
                         f"({r} does not divide {n_clients})")
    groups = np.repeat(np.arange(n_clients // r), r)
    return GradCodingPlan(r=r, groups=groups)


def group_gradients(xs: torch.Tensor, ys: torch.Tensor, beta: torch.Tensor,
                    plan: GradCodingPlan) -> torch.Tensor:
    """Each group's exact gradient over all its members' data:
    (n_groups, d), the per-client partials summed through a one-hot
    (n, n_groups) product."""
    per_client = aggregation.client_partial_gradients(
        xs, ys, torch.ones(xs.shape[:2], dtype=xs.dtype, device=xs.device),
        beta)                                                   # (n, d)
    n_groups = int(plan.groups.max()) + 1
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(plan.groups, dtype=torch.long, device=xs.device),
        n_groups).to(xs.dtype)                                  # (n, g)
    return torch.einsum("nd,ng->gd", per_client, onehot)


def epoch_time(fleet: "FleetSpec", plan: GradCodingPlan, ell: int,
               rng: np.random.Generator) -> float:
    """Wall time until every group has >= 1 returner: each client
    processes r*ell points, and the epoch ends at the max over groups of
    the min over the group's members."""
    loads = np.full(fleet.edge.n, plan.r * ell)
    t_i = sample_total(fleet.edge, loads, rng)
    n_groups = int(plan.groups.max()) + 1
    per_group = np.full(n_groups, np.inf)
    for i, g in enumerate(plan.groups):
        per_group[g] = min(per_group[g], t_i[i])
    return float(per_group.max())


def run_gradient_coding(fleet: "FleetSpec", xs, ys, beta_true, lr: float,
                        epochs: int, rng: np.random.Generator, r: int,
                        label: str = "gradcode",
                        device: Optional[torch.device] = None
                        ) -> "TraceReport":
    """Wall-clock simulation of fractional-repetition gradient coding: a
    shim over `Session(strategy=GradientCodingFL(r=...))` on `device`
    (None: the card), the same trace for the same generator."""
    from repro_torch.api import GradientCodingFL, Session, TrainData
    session = Session(strategy=GradientCodingFL(r=r, label=label),
                      fleet=fleet, lr=lr, epochs=epochs, device=device)
    return session.run(TrainData(xs=xs, ys=ys, beta_true=beta_true), rng=rng)
