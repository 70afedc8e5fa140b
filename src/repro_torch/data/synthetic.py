"""Synthetic dataset generators (counterpart of `repro/data/synthetic.py`).

* `linreg_dataset`: the paper §IV setup — X iid N(0,1), beta ~ N(0,1)^d,
  y = X beta + z with unit-variance noise.
* `classification_dataset`: the CodedFedL (arXiv:2007.03273) workload —
  labels from a random RBF-network teacher (`teacher_labels`), so the
  class regions are non-linear in the raw inputs; `one_vs_rest_targets`
  turns labels into ±1 regression targets.
* `token_batches`: the seeded LM token stream of `launch.train`
  (Zipfian unigram draws with copy-back "induction" events), drawn on
  the host with NumPy exactly as the reference draws it.

The first two draw from an explicit `torch.Generator` on their device.
The distributions are the reference's; the numbers are not (torch's
generators are not `jax.random`), so parity tests hand both packages the
same NumPy arrays instead (the teacher's operands, for the labels).
`token_batches`' tokens equal the reference's for a seed.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


def linreg_dataset(generator: torch.Generator, n_clients: int, ell: int,
                   d: int, noise_std: float = 1.0):
    """Returns (xs (n, ell, d), ys (n, ell), beta_true (d,)), float32, on
    the generator's device."""
    dev = generator.device
    xs = torch.randn((n_clients, ell, d), generator=generator, device=dev,
                     dtype=torch.float32)
    beta = torch.randn((d,), generator=generator, device=dev,
                       dtype=torch.float32)
    zs = noise_std * torch.randn((n_clients, ell), generator=generator,
                                 device=dev, dtype=torch.float32)
    ys = torch.einsum("nld,d->nl", xs, beta) + zs
    return xs, ys, beta


def teacher_labels(xs: torch.Tensor, zc: torch.Tensor, amp: torch.Tensor,
                   gamma: float = 1.0) -> torch.Tensor:
    """The RBF-network teacher's labels: `argmax_c sum_j A[c, j] *
    exp(-gamma * ||x - z_j||^2 / d)` for xs (..., d), centers zc (C, d)
    and amplitudes amp (n_classes, C).  Returns int32 labels (...)."""
    d = int(xs.shape[-1])
    sq = (torch.sum(xs ** 2, dim=-1, keepdim=True)
          - 2.0 * xs @ zc.T + torch.sum(zc ** 2, dim=-1))   # (..., C)
    feats = torch.exp(-gamma * sq / d)
    return torch.argmax(feats @ amp.T, dim=-1).to(torch.int32)


def classification_dataset(generator: torch.Generator, n_clients: int,
                           ell: int, d: int, n_classes: int = 10,
                           centers: int = 32, gamma: float = 1.0):
    """Client-sharded synthetic classification with non-linear classes.

    Inputs are iid N(0, 1); labels come from `teacher_labels` over
    `centers` random N(0, 1) centers and N(0, 1) amplitudes, drawn from
    the generator in that order after the inputs.  The 1/d scaling keeps
    the teacher's kernel width O(1), so an RFF map with
    `gamma_feat = gamma / d` approximates the matching Gaussian kernel.

    Returns `(xs (n, ell, d) float32, labels (n, ell) int32)` on the
    generator's device."""
    if n_classes < 2:
        raise ValueError(f"n_classes must be >= 2, got {n_classes}")
    dev = generator.device
    xs = torch.randn((n_clients, ell, d), generator=generator, device=dev,
                     dtype=torch.float32)
    zc = torch.randn((centers, d), generator=generator, device=dev,
                     dtype=torch.float32)
    amp = torch.randn((n_classes, centers), generator=generator, device=dev,
                      dtype=torch.float32)
    return xs, teacher_labels(xs, zc, amp, gamma)


def one_vs_rest_targets(labels: torch.Tensor, cls: int) -> torch.Tensor:
    """±1 float32 regression targets for the one-vs-rest head of class
    `cls` (least squares on signed labels, the CodedFedL recipe)."""
    one = torch.ones((), dtype=torch.float32, device=labels.device)
    return torch.where(labels == cls, one, -one)


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


def token_batches(seed: int, batch: int, seq_len: int, vocab: int,
                  induction_prob: float = 0.3,
                  device: str | torch.device | None = None
                  ) -> Iterator[dict]:
    """Infinite iterator of {"tokens", "targets"} (batch, seq_len) int64
    batches on `device` (the card by default), the reference's values.

    Sequences mix Zipfian unigram draws with copy-back ("induction") events
    so that even small models see decreasing loss within a few hundred steps.
    """
    return _token_stream(seed, batch, seq_len, vocab, induction_prob,
                         resolve_device(device))


def _token_stream(seed, batch, seq_len, vocab, induction_prob, dev):
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(vocab)
    while True:
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs)
        # induction: with prob p, token t copies token t - lag
        lag = rng.integers(2, 32)
        copy = rng.random((batch, seq_len + 1)) < induction_prob
        copy[:, :lag] = False
        idx = np.arange(seq_len + 1)
        shifted = toks[:, np.maximum(idx - lag, 0)]
        toks = np.where(copy, shifted, toks).astype(np.int64)
        yield {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
               "targets": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
