"""Strategy/Session training surface (counterpart of `repro.api`)."""
from .registry import available_strategies, make_strategy, register_strategy
from .report import TraceReport, coding_gain, convergence_time
from .session import Session, make_epoch_step
from .strategy import (CodedFL, EpochSchedule, GradCodingState,
                       GradientCodingFL, Strategy, TrainData, UncodedFL)

__all__ = [
    "TraceReport", "coding_gain", "convergence_time",
    "Session", "make_epoch_step",
    "Strategy", "TrainData", "EpochSchedule", "UncodedFL", "CodedFL",
    "GradCodingState", "GradientCodingFL",
    "available_strategies", "make_strategy", "register_strategy",
]
