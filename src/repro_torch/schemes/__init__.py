"""Coded follow-up schemes (counterpart of `repro.schemes`).

Ported: `StochasticCodedFL` (noisy shared parity, per-round stochastic
parity sampling and its (epsilon, delta)-DP accounting) and
`LowLatencyCFL` (partial-return uploads over wireless fleets).
`CodedFedL` is still to port (ROADMAP §1 item 4).
"""
from .base import CodedSchemeState
from .lowlatency import LowLatencyCFL, LowLatencyState, row_chunks
from .stochastic import StochasticCodedFL, StochasticState

__all__ = ["CodedSchemeState", "LowLatencyCFL", "LowLatencyState",
           "StochasticCodedFL", "StochasticState", "row_chunks"]
