"""Serving (counterpart of `repro.serving`): the continuous-batching LM
`ServeEngine`, and the always-on federated `FedServeEngine` with its
scheduler."""
from .engine import Request, ServeEngine
from .fed_engine import FedServeEngine
from .scheduler import (ConvergenceCriterion, FifoScheduler, ServeRequest,
                        poisson_arrivals)

__all__ = [
    "Request", "ServeEngine",
    "FedServeEngine", "ServeRequest", "ConvergenceCriterion",
    "FifoScheduler", "poisson_arrivals",
]
