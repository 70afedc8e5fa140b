"""Strategy/Session training surface (counterpart of `repro.api`)."""
from .report import TraceReport, coding_gain, convergence_time
from .session import Session, make_epoch_step
from .strategy import (CodedFL, EpochSchedule, Strategy, TrainData,
                       UncodedFL)

__all__ = [
    "TraceReport", "coding_gain", "convergence_time",
    "Session", "make_epoch_step",
    "Strategy", "TrainData", "EpochSchedule", "UncodedFL", "CodedFL",
]
