"""Always-on federated serving driver: Poisson arrivals into the
continuous-batching `FedServeEngine` (counterpart of
`repro/launch/fedserve.py`, with its flags and defaults).

  python -m repro_torch.launch.fedserve --sessions 16 --rate 0.5 \\
      --epochs 120 --nmse-target 3e-2 [--device cpu]

Builds a mixed workload (uncoded / CFL at two coding rates — three shape
buckets), submits it on a Poisson arrival trace over the engine's
virtual clock, and drains.  Prints per-session exit epochs plus
aggregate throughput in sessions/s and epochs/s of wall time (ending in
a device sync).  Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_workload(fleet, m: int, n_sessions: int, epochs: int, lr: float,
                   base_seed: int = 100, device=None):
    """The mixed-shape session list: half CFL at c1, a quarter CFL at c2,
    a quarter uncoded (three engine buckets)."""
    from repro_torch.api import Session, make_strategy

    c1, c2 = int(0.3 * m), int(0.5 * m)
    sessions = []
    for i in range(n_sessions):
        if i % 4 in (0, 1):
            strat = make_strategy("cfl", fixed_c=c1, key_seed=7 + i)
        elif i % 4 == 2:
            strat = make_strategy("cfl", fixed_c=c2, key_seed=7 + i)
        else:
            strat = make_strategy("uncoded")
        sessions.append(Session(strategy=strat, fleet=fleet, lr=lr,
                                epochs=epochs, seed=base_seed + i,
                                device=device))
    return sessions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="Poisson arrival rate (sessions per epoch-unit "
                         "of virtual time)")
    ap.add_argument("--lane-width", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--nmse-target", type=float, default=0.0)
    ap.add_argument("--rel-delta", type=float, default=None)
    ap.add_argument("--min-epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--ell", type=int, default=60)
    ap.add_argument("--d", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from repro_torch.api import TrainData
    from repro_torch.device import resolve_device
    from repro_torch.serving import (ConvergenceCriterion, FedServeEngine,
                                     poisson_arrivals)
    from repro_torch.sim.network import paper_fleet

    dev = resolve_device(args.device)
    data = TrainData.linreg(args.seed, n=args.n, ell=args.ell, d=args.d,
                            device=dev)
    fleet = paper_fleet(0.2, 0.2, seed=args.seed, n=args.n, d=args.d)
    sessions = build_workload(fleet, data.m, args.sessions, args.epochs,
                              args.lr, device=dev)
    arrivals = poisson_arrivals(args.sessions, args.rate,
                                np.random.default_rng(args.seed))
    crit = ConvergenceCriterion(nmse_target=args.nmse_target,
                                rel_delta=args.rel_delta,
                                min_epochs=args.min_epochs)
    engine = FedServeEngine(data, lane_width=args.lane_width,
                            chunk=args.chunk, criterion=crit, device=dev)

    t0 = time.perf_counter()
    reports = engine.serve(sessions, arrivals=arrivals)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    total_epochs = 0
    for arr, rep in zip(arrivals, reports):
        t_exit = rep.extras["serve_exit_epoch"]
        total_epochs += t_exit
        tag = "conv" if rep.extras["serve_converged"] else "budget"
        print(f"  uid={rep.extras['serve_uid']:3d} {rep.label:22s} "
              f"arrival={arr:7.1f} exit_epoch={t_exit:4d} ({tag}) "
              f"final_nmse={rep.final_nmse():.3e}")
    print(f"{len(reports)} sessions, {engine.n_groups} buckets, "
          f"{engine.steps} engine steps")
    print(f"wall {wall:.2f}s -> {len(reports) / wall:.2f} sessions/s, "
          f"{total_epochs / wall:.0f} epochs/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
