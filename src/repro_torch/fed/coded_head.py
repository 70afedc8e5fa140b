"""Exact CFL for a model's linear readout head (counterpart of
`repro/fed/coded_head.py`).

The paper's parity-gradient identity holds whenever the trained
parameters enter linearly under squared loss.  For a frozen backbone this
is the last-layer (linear-probe) setting: client i holds features
Phi_i = f(X_i) in R^{ell_i x d_feat} and targets y_i, and training the
head beta solves min ||Phi beta - y||^2 — the paper's problem with Phi in
place of X.

Two feature sources compose here:

  * a frozen backbone (`backbone_fn`, any torch callable on one client's
    inputs), applied per client with `torch.func.vmap`, or on all rows
    in one call (`extract_features(..., batched=True)`; the entry point
    `python -m repro_torch.coded_head_probe` takes a frozen granite-8b
    backbone that way, kernel 8 in its attention);
  * `CodedFedL`'s random-Fourier-feature map (`d_feat=...`), which turns
    the head into Gaussian-kernel regression on the (backbone) features.

Runs ride the Strategy/Session substrate on the inputs' device
(`UncodedFL` baseline, `CodedFL` / `CodedFedL` coded head) and return
`TraceReport`s.  The coded head encodes through kernel 2 and takes each
round gradient through kernel 1 when the inputs lie on the card (the
wrappers' plain versions on the CPU).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api import Session, TrainData
from repro_torch.api.report import TraceReport
from repro_torch.api.strategy import CodedFL, UncodedFL
from repro_torch.schemes import CodedFedL
from repro_torch.sim.network import FleetSpec


def extract_features(backbone_fn: Callable, xs: torch.Tensor,
                     batched: bool = False) -> torch.Tensor:
    """Apply a frozen backbone per client: xs (n, ell, ...) -> (n, ell, d).

    batched=False maps `backbone_fn` over the clients with
    `torch.func.vmap`.  batched=True calls it once on all n * ell rows,
    (n * ell, ...) -> (n * ell, d): for a backbone that acts on each row
    alone (a model over token sequences), and one that launches a CUDA
    kernel through ctypes, which `vmap` cannot trace."""
    if not batched:
        return torch.func.vmap(backbone_fn)(xs)
    n, ell = xs.shape[:2]
    feats = backbone_fn(xs.reshape(n * ell, *xs.shape[2:]))
    return feats.reshape(n, ell, *feats.shape[1:])


def _feature_rows(strategy: CodedFedL, xs: torch.Tensor,
                  ys: torch.Tensor) -> np.ndarray:
    """`strategy`'s features of the (n, ell, d) inputs as float64 rows on
    the host (the map reads the inputs alone)."""
    phi = strategy.features(TrainData(xs=xs, ys=ys,
                                      beta_true=xs.new_zeros(0)))
    return phi.cpu().numpy().astype(np.float64).reshape(-1, phi.shape[-1])


def reference_head(strategy: CodedFedL, xs: torch.Tensor,
                   ys: torch.Tensor) -> torch.Tensor:
    """The feature-space least-squares head of `strategy`'s map of the
    inputs against the (n, ell) targets, solved in float64 on the host and
    returned in the inputs' dtype on their device."""
    beta, *_ = np.linalg.lstsq(
        _feature_rows(strategy, xs, ys),
        ys.cpu().numpy().astype(np.float64).reshape(-1), rcond=None)
    return torch.as_tensor(beta, device=xs.device).to(xs.dtype)


def head_accuracy(strategy: CodedFedL, beta, xs: torch.Tensor,
                  ys: torch.Tensor) -> float:
    """Sign accuracy of the feature-space head `beta` on (held-out) inputs
    and their ±1 targets."""
    pred = _feature_rows(strategy, xs, ys) @ np.asarray(beta, np.float64)
    return float(np.mean((pred > 0) == (ys.cpu().numpy().reshape(-1) > 0)))


def train_coded_head(fleet: FleetSpec, backbone_fn: Optional[Callable],
                     xs: torch.Tensor, ys: torch.Tensor,
                     beta_true: torch.Tensor, lr: float, epochs: int,
                     key: int, rng: np.random.Generator,
                     fixed_c: Optional[int] = None,
                     include_upload_delay: bool = False,
                     uncoded_baseline: bool = True,
                     d_feat: Optional[int] = None,
                     rff_key: Optional[int] = None,
                     rff_gamma: float = 1.0) -> dict[str, TraceReport]:
    """Coded-train a linear head on (frozen-backbone or RFF) features, on
    the device the inputs live on.

    backbone_fn: maps one client's raw inputs (ell, ...) to features
    (ell, d_feat); None means features == inputs (pure linreg).
    key / rff_key: int seeds, as in `CodedFL` and `CodedFedL`.
    d_feat/rff_key/rff_gamma: push the (backbone) features through
    `CodedFedL`'s shared RFF map and train the head in kernel space;
    `beta_true` is then replaced by the feature-space least-squares head
    (float64 on the host), so the NMSE trace measures distance to the
    kernel regressor.
    Returns {"uncoded": TraceReport, "cfl" | "cfedl": TraceReport}; the
    shared `rng` is consumed in turn, uncoded first.
    """
    feats = extract_features(backbone_fn, xs) if backbone_fn is not None \
        else xs
    dev = feats.device

    if d_feat is None:
        coded_key = "cfl"
        coded = CodedFL(key=key, fixed_c=fixed_c,
                        include_upload_delay=include_upload_delay,
                        use_kernel=True)
        data = TrainData(xs=feats, ys=ys, beta_true=beta_true)
    else:
        coded_key = "cfedl"
        coded = CodedFedL(key=key, d_feat=d_feat, rff_key=rff_key,
                          rff_gamma=rff_gamma, fixed_c=fixed_c,
                          include_upload_delay=include_upload_delay,
                          use_kernel=True)
        # feature-space reference head: the model trains in d_feat
        # dimensions, so NMSE is measured against the kernel regressor
        data = TrainData(xs=feats, ys=ys,
                         beta_true=reference_head(coded, feats, ys))

    out: dict[str, TraceReport] = {}
    if uncoded_baseline:
        # the uncoded baseline waits for every straggler on the same
        # training problem: kernel-space runs pre-map the features, so
        # both arms descend the same objective
        base_xs = data.xs if d_feat is None else coded.features(data)
        base = TrainData(xs=base_xs, ys=data.ys, beta_true=data.beta_true)
        out["uncoded"] = Session(strategy=UncodedFL(), fleet=fleet, lr=lr,
                                 epochs=epochs, device=dev).run(base,
                                                                rng=rng)
    out[coded_key] = Session(strategy=coded, fleet=fleet, lr=lr,
                             epochs=epochs, device=dev).run(data, rng=rng)
    return out
