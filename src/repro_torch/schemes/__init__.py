"""Coded follow-up schemes (counterpart of `repro.schemes`).

`StochasticCodedFL` (noisy shared parity, per-round stochastic parity
sampling and its (epsilon, delta)-DP accounting), `LowLatencyCFL`
(partial-return uploads over wireless fleets) and `CodedFedL` (random-
Fourier-feature kernel regression under the MEC delay model).
"""
from .base import CodedSchemeState
from .codedfedl import CodedFedL, CodedFedLState, rff_seed
from .lowlatency import LowLatencyCFL, LowLatencyState, row_chunks
from .stochastic import StochasticCodedFL, StochasticState

__all__ = ["CodedFedL", "CodedFedLState", "CodedSchemeState",
           "LowLatencyCFL", "LowLatencyState", "StochasticCodedFL",
           "StochasticState", "rff_seed", "row_chunks"]
