"""Fleet topology: clients grouped under edge tiers, MEC-style.

A NumPy copy of `repro/fleet/topology.py`, bit-for-bit on the same
`np.random.Generator`:

  * `tier_of[i]` is the edge tier client `i` reports to; tier ids are
    dense in `[0, n_tiers)` and every tier is non-empty.
  * `sample_frac[t]` is the probability that a tier-`t` client
    participates in any given round.  Participation gates are
    inverse-probability weighted (`indicator / sample_frac`), so the
    tier-reduced gradient stays an unbiased estimate of the full
    aggregate — `StochasticCodedFL`'s rho-weighting, applied per client
    instead of per parity row.
  * `sample_frac == 1` everywhere draws NO extra randomness (the gates
    are constant 1.0), which keeps the degenerate hierarchical run on the
    same generator stream as its flat base strategy.

Topologies are host-side metadata: nothing here touches torch.
"""
from __future__ import annotations

import dataclasses
from typing import Hashable, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class FleetTopology:
    """Tier assignment + per-tier participation for `n` clients.

    tier_of:     (n,) int32 tier id per client, dense in [0, n_tiers)
    sample_frac: (n_tiers,) per-round participation probability in (0, 1]
    """

    tier_of: np.ndarray
    sample_frac: np.ndarray

    def __post_init__(self):
        tier_of = np.asarray(self.tier_of, dtype=np.int32)
        frac = np.atleast_1d(np.asarray(self.sample_frac, dtype=np.float64))
        object.__setattr__(self, "tier_of", tier_of)
        object.__setattr__(self, "sample_frac", frac)
        if tier_of.ndim != 1 or tier_of.size == 0:
            raise ValueError("tier_of must be a non-empty (n,) vector")
        n_tiers = frac.shape[0]
        if tier_of.min() < 0 or tier_of.max() >= n_tiers:
            raise ValueError(
                f"tier ids must be dense in [0, {n_tiers}); got range "
                f"[{tier_of.min()}, {tier_of.max()}]")
        sizes = np.bincount(tier_of, minlength=n_tiers)
        if np.any(sizes == 0):
            raise ValueError(
                f"every tier must own at least one client; empty tiers: "
                f"{np.flatnonzero(sizes == 0).tolist()}")
        if np.any(frac <= 0.0) or np.any(frac > 1.0):
            raise ValueError(
                f"sample_frac must be in (0, 1] per tier, got {frac}")

    # -- structure ----------------------------------------------------------

    @property
    def n(self) -> int:
        return int(self.tier_of.shape[0])

    @property
    def n_tiers(self) -> int:
        return int(self.sample_frac.shape[0])

    @property
    def subsampled(self) -> bool:
        """True iff any tier participates at less than full strength."""
        return bool(np.any(self.sample_frac < 1.0))

    def tier_sizes(self) -> np.ndarray:
        return np.bincount(self.tier_of, minlength=self.n_tiers)

    def tier_members(self) -> List[np.ndarray]:
        """Client indices per tier, in ascending client order."""
        order = np.argsort(self.tier_of, kind="stable")
        return np.split(order, np.cumsum(self.tier_sizes())[:-1])

    def structure_key(self) -> Hashable:
        """Hashable digest of the tier STRUCTURE (not the participation
        values — those only gate operand values, never the trace)."""
        return (self.n, self.n_tiers)

    # -- constructors -------------------------------------------------------

    @classmethod
    def uniform(cls, n: int, n_tiers: int,
                sample_frac: float = 1.0) -> "FleetTopology":
        """Contiguous equal-size tiers (the MEC cell layout: clients are
        assigned to the geographically nearest edge node, block by block)."""
        if not (1 <= n_tiers <= n):
            raise ValueError(f"need 1 <= n_tiers <= n, got {n_tiers}, {n}")
        tier_of = (np.arange(n) * n_tiers) // n
        return cls(tier_of=tier_of.astype(np.int32),
                   sample_frac=np.full(n_tiers, float(sample_frac)))

    @classmethod
    def from_assignment(cls, tier_of: np.ndarray,
                        sample_frac=1.0) -> "FleetTopology":
        """Arbitrary (e.g. permuted) assignment; scalar `sample_frac`
        broadcasts over tiers."""
        tier_of = np.asarray(tier_of, dtype=np.int32)
        n_tiers = int(tier_of.max()) + 1 if tier_of.size else 0
        frac = np.broadcast_to(
            np.asarray(sample_frac, dtype=np.float64), (n_tiers,)).copy()
        return cls(tier_of=tier_of, sample_frac=frac)

    def with_round_budget(self, budget: int) -> "FleetTopology":
        """Cap the EXPECTED participants per round at `budget` clients.

        Per-tier `sample_frac` = min(1, budget / n), so the expected round
        cost is O(budget) however large the fleet grows."""
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        frac = min(1.0, float(budget) / float(self.n))
        return dataclasses.replace(
            self, sample_frac=np.full(self.n_tiers, frac))

    # -- per-round gates ----------------------------------------------------

    def tier_masks(self, ell: int) -> np.ndarray:
        """(n_tiers, n*ell) float32 one-hot row masks over the flat
        client-major (m,) layout every built-in strategy uses."""
        row_tier = np.repeat(self.tier_of, ell)
        return (np.arange(self.n_tiers)[:, None]
                == row_tier[None, :]).astype(np.float32)

    def sample_gates(self, epochs: int,
                     rng: np.random.Generator) -> np.ndarray:
        """(epochs, n) inverse-probability participation gates.

        gate[e, i] = 1{client i participates in round e} / sample_frac of
        its tier — `E[gate] == 1` per client, so gated tier reduction is
        unbiased.  All-ones (and NO generator draws) when every tier has
        `sample_frac == 1`, keeping the degenerate case on the base
        strategy's exact stream.
        """
        if not self.subsampled:
            return np.ones((epochs, self.n), dtype=np.float32)
        frac = self.sample_frac[self.tier_of]                    # (n,)
        draws = rng.random((epochs, self.n))
        return np.asarray((draws < frac) / frac, dtype=np.float32)
