"""Strategy/Session training surface (counterpart of `repro.api`)."""
from .registry import available_strategies, make_strategy, register_strategy
from .report import TraceReport, coding_gain, convergence_time
from .session import (Session, cache_engine, make_epoch_step, plan_sweep,
                      run_sweep)
from .strategy import (CodedFL, EpochSchedule, GradCodingState,
                       GradientCodingFL, Strategy, TrainData, UncodedFL)

__all__ = [
    "TraceReport", "coding_gain", "convergence_time",
    "Session", "make_epoch_step", "plan_sweep", "run_sweep", "cache_engine",
    "Strategy", "TrainData", "EpochSchedule", "UncodedFL", "CodedFL",
    "GradCodingState", "GradientCodingFL",
    "available_strategies", "make_strategy", "register_strategy",
]
