"""Fleet generation and the legacy simulator shims (counterpart of
`repro.sim`)."""
from .network import FleetSpec, make_fleet, paper_fleet
from .simulator import (SimResult, TraceReport, coding_gain,
                        convergence_time, run_cfl, run_uncoded)

__all__ = ["FleetSpec", "make_fleet", "paper_fleet", "SimResult",
           "TraceReport", "run_uncoded", "run_cfl", "convergence_time",
           "coding_gain"]
