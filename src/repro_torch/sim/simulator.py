"""Wall-clock simulation of uncoded FL vs CFL (paper §IV) — the legacy
surface (counterpart of `repro/sim/simulator.py`), as shims over the
Strategy/Session API:

    run_uncoded(...)  ->  Session(strategy=UncodedFL(), ...).run(data)
    run_cfl(...)      ->  Session(strategy=CodedFL(...), ...).run(data)
    SimResult         ->  repro_torch.api.TraceReport (alias)

The shims keep the reference's NumPy generator draw order (they pass the
caller's generator to `Session.run`), so both surfaces give identical
traces for the same seeds.  Each runs on `device` (None: the card).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.api import (CodedFL, Session, TraceReport, TrainData,
                             UncodedFL, coding_gain, convergence_time)

from .network import FleetSpec

# Back-compat alias: SimResult was the old name of the unified trace report.
SimResult = TraceReport

__all__ = ["SimResult", "generate_linreg", "run_uncoded", "run_cfl",
           "convergence_time", "coding_gain"]


def generate_linreg(key, n: int, ell: int, d: int, noise_std: float = 1.0,
                    device=None):
    """Paper §IV data: X iid N(0,1), beta ~ N(0,1)^d, y = X beta + z.
    key: an int seed or a `torch.Generator` (see `TrainData.linreg`)."""
    data = TrainData.linreg(key, n, ell, d, noise_std=noise_std,
                            device=device)
    return data.xs, data.ys, data.beta_true


def run_uncoded(fleet: FleetSpec, xs, ys, beta_true, lr: float,
                epochs: int, rng: np.random.Generator,
                label: str = "uncoded", device=None) -> TraceReport:
    """Synchronous uncoded FL: wait for everyone each epoch."""
    session = Session(strategy=UncodedFL(label=label), fleet=fleet,
                      lr=lr, epochs=epochs, device=device)
    return session.run(TrainData(xs=xs, ys=ys, beta_true=beta_true), rng=rng)


def run_cfl(fleet: FleetSpec, xs, ys, beta_true, lr: float, epochs: int,
            rng: np.random.Generator, key: Union[int, torch.Generator],
            fixed_c: Optional[int] = None, c_up: Optional[int] = None,
            include_upload_delay: bool = True,
            server_always_returns: bool = False,
            use_kernel: bool = False, label: str = "cfl",
            device=None) -> TraceReport:
    """Coded federated learning with the Eq. 14-16 redundancy plan."""
    strategy = CodedFL(key=key, fixed_c=fixed_c, c_up=c_up,
                       include_upload_delay=include_upload_delay,
                       server_always_returns=server_always_returns,
                       use_kernel=use_kernel, label=label)
    session = Session(strategy=strategy, fleet=fleet, lr=lr, epochs=epochs,
                      device=device)
    return session.run(TrainData(xs=xs, ys=ys, beta_true=beta_true), rng=rng)
