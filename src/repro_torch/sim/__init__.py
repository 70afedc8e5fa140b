"""Fleet generation (counterpart of `repro.sim`)."""
from .network import FleetSpec, make_fleet, paper_fleet

__all__ = ["FleetSpec", "make_fleet", "paper_fleet"]
