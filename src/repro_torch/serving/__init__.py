"""Serving (counterpart of `repro.serving`): the continuous-batching
`ServeEngine`.  `FedServeEngine` and the scheduler wait for ROADMAP.md
item 11."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
