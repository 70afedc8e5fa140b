"""The one traffic generator: every input a cell hands the port is made
here from the run's seed and the numbers of its traffic file.

`token_stream` and `paper_edge` are frozen copies of the port's
`data.synthetic.token_batches` and `sim.network.make_fleet` (the paper's
§IV fleet: geometric MAC and link ladders, randomly assigned), so a
change to the port's generators cannot change what the benchmark sends.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """Independent NumPy streams of one seed (0 tokens, 1 arrivals, ...)."""
    return np.random.default_rng([seed, stream])


def token_stream(seed: int, batch: int, seq_len: int, vocab: int,
                 induction_prob: float = 0.3) -> Iterator[dict]:
    """Infinite (batch, seq_len) int64 {"tokens", "targets"} NumPy
    batches: Zipfian (alpha 1.1) unigram draws in which each token
    copies the one `lag` back with probability `induction_prob`, a new
    lag in 2..31 each batch; every row differs."""
    gen = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -1.1
    probs /= probs.sum()
    while True:
        toks = gen.choice(vocab, size=(batch, seq_len + 1), p=probs)
        lag = gen.integers(2, 32)
        copy = gen.random((batch, seq_len + 1)) < induction_prob
        copy[:, :lag] = False
        idx = np.arange(seq_len + 1)
        toks = np.where(copy, toks[:, np.maximum(idx - lag, 0)],
                        toks).astype(np.int64)
        yield {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}


def paper_edge(seed: int, n: int, d: int, nu_comp: float, nu_link: float,
               base_mac_kmacs: float = 1536.0, base_link_kbps: float = 216.0,
               erasure_p: float = 0.1, header_overhead: float = 0.10,
               bits_per_value: int = 32) -> dict:
    """The edge devices' delay parameters {a, mu, tau, p} ((n,) float64)
    of the paper's §IV fleet at model width d."""
    gen = np.random.default_rng(seed)
    ladder = np.arange(n)
    mac = gen.permutation((1.0 - nu_comp) ** ladder * base_mac_kmacs * 1e3)
    link = gen.permutation((1.0 - nu_link) ** ladder * base_link_kbps * 1e3)
    a = d / mac
    packet_bits = d * bits_per_value * (1.0 + header_overhead)
    return {"a": a, "mu": 2.0 / a, "tau": packet_bits / link,
            "p": np.full(n, erasure_p)}


def prompt_lengths(seed: int, count: int, lo: int, hi: int) -> np.ndarray:
    """`count` prompt lengths drawn from the run's seed, each log-uniform
    on [lo, hi], in a seeded order.  The draw is stratified: the i-th
    length of the sorted set lies in the i-th of `count` equal-probability
    bins, at a point the seed draws, so every seed sends lengths of the
    same distribution (no two alike) and in its own order."""
    g = rng(seed, 2)
    q = (g.permutation(count) + g.random(count)) / count
    return np.rint(lo * (hi / lo) ** q).astype(np.int64)


def prompt_tokens(seed: int, index: int, length: int, vocab: int,
                  stream: int = 3) -> np.ndarray:
    """Request `index`'s token ids, uniform over the vocabulary (another
    `stream` for the warm-up's)."""
    return np.random.default_rng([seed, stream, index]).integers(
        0, vocab, size=length, dtype=np.int64)
