"""Coded follow-up schemes (counterpart of `repro.schemes`).

Ported so far: `StochasticCodedFL` (noisy shared parity and per-round
stochastic parity sampling).  `LowLatencyCFL` and `CodedFedL` are still
to port (ROADMAP item 8).
"""
from .base import CodedSchemeState
from .stochastic import StochasticCodedFL, StochasticState

__all__ = ["CodedSchemeState", "StochasticCodedFL", "StochasticState"]
