"""Unified training-trace report returned by every `Session` run.

A NumPy copy of `repro/api/report.py`.  `TraceReport` is
strategy-agnostic: the same fields describe an
uncoded run, a CFL run, or a gradient-coding run, so downstream analysis
(convergence times, coding gains, comm-load ratios) never branches on which
strategy produced the trace.

This module imports nothing from the rest of the package, so it can be
used from any layer without creating import cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass
class TraceReport:
    """Trace of one simulated training run.

    times:           (epochs+1,) wall-clock at each model snapshot
    nmse:            (epochs+1,) NMSE at each snapshot
    epoch_durations: (epochs,)   per-epoch wall time
    label:           human-readable run tag ("uncoded", "cfl", ...)
    setup_time:      one-time setup wall time (parity upload / data sharing)
    uplink_bits_total: total bits moved device -> server over the whole run
    extras:          strategy-specific diagnostics from the optional
                     `report_extras(state)` hook (StochasticCodedFL's noise
                     knobs and DP spend, HierarchicalCFL's tiers); empty
                     without it
    beta:            final model iterate (model_dim,), or None
    """

    times: np.ndarray
    nmse: np.ndarray
    epoch_durations: np.ndarray
    label: str
    setup_time: float = 0.0
    uplink_bits_total: float = 0.0
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    beta: Optional[np.ndarray] = None

    def final_nmse(self) -> float:
        return float(self.nmse[-1])

    def privacy_budget(self):
        """(epsilon_spent, delta) when the strategy reported DP accounting
        (`StochasticCodedFL` with an accounting horizon), else None.

        The extras schema for privacy-accounting strategies:
        `epsilon_spent` (composed total), `delta`, `accounting_rounds`,
        `epsilon_schedule` ((rounds,) cumulative per-round epsilon), and
        `epsilon_target` when the noise was calibrated to a budget."""
        eps = self.extras.get("epsilon_spent")
        if eps is None:
            return None
        return float(eps), float(self.extras["delta"])

    @property
    def epochs(self) -> int:
        return int(self.epoch_durations.shape[0])

    def epochs_to(self, target_nmse: float) -> int:
        """Number of epochs until NMSE first reaches target (epochs+1 if never)."""
        hit = np.nonzero(self.nmse <= target_nmse)[0]
        return int(hit[0]) if hit.size else self.epochs + 1


def convergence_time(result: TraceReport, target_nmse: float) -> float:
    """First wall-clock time at which NMSE <= target (inf if never)."""
    hit = np.nonzero(result.nmse <= target_nmse)[0]
    return float(result.times[hit[0]]) if hit.size else float("inf")


def coding_gain(uncoded: TraceReport, coded: TraceReport,
                target_nmse: float) -> float:
    """Ratio of uncoded to coded convergence time (paper Figs. 4-5)."""
    tu = convergence_time(uncoded, target_nmse)
    tc = convergence_time(coded, target_nmse)
    return tu / tc
