"""Admission scheduling for the always-on federated serving engine
(counterpart of `repro/serving/scheduler.py`; host NumPy, bit-equal to
the reference).

The policy half of `repro_torch.serving.fed_engine`, kept free of any
device work so it can be tested on its own:

  * `ConvergenceCriterion` — the per-lane early-exit predicate (NMSE
    target, relative-plateau delta), evaluated on the device each epoch,
    plus the host-side epoch budget (`max_epochs`, how epsilon-budget
    exhaustion is expressed — see `StochasticCodedFL.serve_convergence`);
  * `ServeRequest` — one admitted-or-pending training job: a `Session`,
    its stable uid, and its arrival time on the engine's virtual clock;
  * `FifoScheduler` — arrival-ordered admission that scans the WHOLE
    arrived queue instead of only its head, so one request whose shape
    bucket is out of capacity never starves admissible requests behind
    it;
  * `poisson_arrivals` — the arrival trace the command line drives the
    engine with.

**Randomness is admission-order independent by construction.**  A
request's epoch randomness is drawn from `np.random.default_rng(seed)`
where the seed is the SESSION's own stable identity (`Session.seed`, or
an explicit per-request override) — never a shared engine stream, never
the admission index — and the strategy's generator seed rides inside the
strategy itself.  So the same session gives the same trace under any
arrival interleaving, and the trace of a solo `Session.run` (which uses
the same `default_rng(session.seed)` default).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.api import Session


@dataclasses.dataclass(frozen=True)
class ConvergenceCriterion:
    """Per-lane early-exit predicate for the serving engine.

    A lane exits after epoch t (reporting `serve_exit_epoch = t`) when

        t >= min_epochs  AND  (nmse_t <= nmse_target
                               OR |nmse_{t-1} - nmse_t|
                                  <= rel_delta * nmse_{t-1})

    or unconditionally when t reaches the epoch budget
    `min(session.epochs, max_epochs)`.  The defaults disable both
    convergence clauses, so a default-criterion lane runs its full fixed
    epoch count — exactly a solo `Session.run`.

    nmse_target: absolute NMSE level counting as converged (<= 0 = off)
    rel_delta:   relative one-epoch plateau threshold (None = off)
    min_epochs:  epochs to run before the predicate may fire
    max_epochs:  hard cap on epochs served (None = the session's own
                 count); the budget-exhaustion channel strategies tighten
                 through the `serve_convergence` hook
    """

    nmse_target: float = 0.0
    rel_delta: Optional[float] = None
    min_epochs: int = 1
    max_epochs: Optional[int] = None

    def __post_init__(self):
        if self.min_epochs < 1:
            raise ValueError(
                f"min_epochs must be >= 1, got {self.min_epochs}")
        if self.max_epochs is not None and self.max_epochs < 0:
            raise ValueError(
                f"max_epochs must be >= 0, got {self.max_epochs}")

    def budget(self, epochs: int) -> int:
        """The epoch budget for a session asking for `epochs` epochs."""
        if self.max_epochs is None:
            return epochs
        return min(epochs, int(self.max_epochs))


@dataclasses.dataclass
class ServeRequest:
    """One training job in the serving engine's queue.

    session:  the `Session` to serve (strategy + fleet + lr + epochs)
    uid:      stable identity, assigned at submission and echoed on
              `TraceReport.extras["serve_uid"]`
    arrival:  arrival time on the engine's virtual clock (epoch units)
    rng_seed: seed of the per-request epoch-randomness generator;
              defaults to the session's own `seed` so a served trace is
              the session's solo trace (see the module docstring)
    state:    pre-planned strategy state (optional; submission plans
              missing states in one batched `plan_sweep` call)
    criterion: per-request override of the engine's criterion
    """

    session: Session
    uid: int
    arrival: float = 0.0
    rng_seed: Optional[int] = None
    state: Any = None
    criterion: Optional[ConvergenceCriterion] = None

    @property
    def seed(self) -> int:
        return self.session.seed if self.rng_seed is None else self.rng_seed

    def make_rng(self) -> np.random.Generator:
        """The request's private generator — keyed on stable identity
        only, so admission order can never perturb its draws."""
        return np.random.default_rng(self.seed)


class FifoScheduler:
    """Arrival-ordered admission over shape-bucketed lane capacity.

    `pop_admissible` scans every request that has arrived by `now`, in
    arrival order, and admits each one whose shape bucket still has a
    free slot (`capacity_fn(bucket_key) -> bool`).  Scanning the whole
    arrived queue — not just its head — means a request bound for a
    saturated bucket waits without starving requests behind it whose
    buckets have room.
    """

    def __init__(self):
        self._pending: List[Tuple[ServeRequest, Hashable]] = []

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> List[ServeRequest]:
        return [req for req, _ in self._pending]

    def push(self, request: ServeRequest, bucket_key: Hashable) -> None:
        self._pending.append((request, bucket_key))
        self._pending.sort(key=lambda e: (e[0].arrival, e[0].uid))

    def next_arrival(self, now: float) -> Optional[float]:
        """Earliest arrival strictly after `now` (None when drained)."""
        later = [req.arrival for req, _ in self._pending
                 if req.arrival > now]
        return min(later) if later else None

    def pop_admissible(self, now: float, capacity_fn) -> List[
            Tuple[ServeRequest, Hashable]]:
        admitted: List[Tuple[ServeRequest, Hashable]] = []
        still: List[Tuple[ServeRequest, Hashable]] = []
        for req, key in self._pending:
            if req.arrival <= now and capacity_fn(key):
                admitted.append((req, key))
            else:
                still.append((req, key))
        self._pending = still
        return admitted


def poisson_arrivals(n: int, rate: float,
                     rng: np.random.Generator) -> np.ndarray:
    """(n,) arrival times of a Poisson process with `rate` arrivals per
    epoch-unit of virtual time (exponential inter-arrivals)."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    return np.cumsum(rng.exponential(scale=1.0 / rate, size=n))


def group_by_bucket(keys: List[Hashable]) -> Dict[Hashable, List[int]]:
    """Indices grouped by bucket key, preserving first-seen order."""
    groups: Dict[Hashable, List[int]] = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    return groups
