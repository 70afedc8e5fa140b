"""Quickstart: Coded Federated Learning end to end on the card.

The counterpart of `examples/quickstart.py`: the paper's §IV setup (24
heterogeneous edge devices, linear regression, d=500), the two-step
redundancy optimization at c = 0.28 m, then CFL against uncoded FL
through the Strategy/Session API, and the coding gain to NMSE <= 1e-3.

    PYTHONPATH=src python -m repro_torch.quickstart [--epochs 600]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import (CodedFL, Session, TrainData, UncodedFL,
                             coding_gain, convergence_time)
from repro_torch.core.redundancy import solve_redundancy
from repro_torch.device import resolve_device
from repro_torch.sim.network import paper_fleet

N, ELL, D = 24, 300, 500
M = N * ELL
FIXED_C = int(0.28 * M)
LR = 0.0085
TARGET = 1e-3


def run(epochs: int = 600, device=None) -> dict:
    """Plan, train both strategies, and return every piece of the run:
    fleet, data, plan, the coded state, both `TraceReport`s, and the host
    seconds of each phase (each ends in a device sync)."""
    dev = resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    fleet = paper_fleet(nu_comp=0.2, nu_link=0.2, seed=0)
    data = TrainData.linreg(0, N, ELL, D, device=dev)
    lap("data")
    plan = solve_redundancy(fleet.edge, fleet.server, np.full(N, ELL),
                            fixed_c=FIXED_C, device=dev)
    lap("plan")
    # baseline: synchronous uncoded FL (wait for every straggler)
    uncoded = Session(strategy=UncodedFL(), fleet=fleet, lr=LR,
                      epochs=epochs, device=dev)
    res_u = uncoded.run(data, rng=np.random.default_rng(0))
    lap("uncoded_run")
    # CFL: parity upload once, then deadline-clipped epochs
    strategy = CodedFL(key=1, fixed_c=plan.c, include_upload_delay=False,
                       use_kernel=True, redundancy_plan=plan)
    coded = Session(strategy=strategy, fleet=fleet, lr=LR, epochs=epochs,
                    device=dev)
    state = coded.plan(data)
    lap("encode")
    res_c = coded.run(data, rng=np.random.default_rng(0), state=state)
    lap("coded_run")
    return {"fleet": fleet, "data": data, "plan": plan, "state": state,
            "uncoded": res_u, "coded": res_c, "seconds": seconds}


def main(epochs: int = 600, device=None) -> None:
    print("=== Coded Federated Learning quickstart (PyTorch) ===")
    out = run(epochs, device)
    plan, res_u, res_c = out["plan"], out["uncoded"], out["coded"]
    print(f"plan: c={plan.c} (delta={plan.delta:.2f}) t*={plan.t_star:.2f}s")
    print(f"per-device loads: {plan.loads.tolist()}")
    print(f"\nuncoded: NMSE {res_u.final_nmse():.2e} after "
          f"{res_u.times[-1]:.0f}s simulated")
    print(f"coded:   NMSE {res_c.final_nmse():.2e} after "
          f"{res_c.times[-1]:.0f}s simulated "
          f"(epoch deadline {plan.t_star:.1f}s)")
    g = coding_gain(res_u, res_c, TARGET)
    print(f"\ncoding gain to NMSE<={TARGET}: {g:.2f}x "
          f"(uncoded {convergence_time(res_u, TARGET):.0f}s vs "
          f"coded {convergence_time(res_c, TARGET):.0f}s)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=600,
                    help="training epochs (30 for a smoke run)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    main(**vars(ap.parse_args()))
