"""The readings that the limits of `correct` are set from, on the card:

    python3 -m cfl_bench.control --workload mamba2-1.3b.fedtrain \
        --seeds 11,12,13 --seconds 5

For each seed, in one process: a run of the cell (set-up, a short
window at the cell's own load, the port's state freed), the numbers the
benchmark compares (the lower readings: sound runs of the port), then the
same numbers with the reference in the port's place computed in TF32 (the
control: the nearest precision below the configuration's float32), and,
for a training cell, with each of the training faults planted in that
reference (half of the batch left out; a step that leaves the state
unchanged, which reads 1 by the change's measure), and for the
coded head an answer altered where it is produced (each epoch's arrivals
and times drawn from another generator) and a plan off by one parity
row (the reference's least deadline at c - 1 and c + 1 in the port's
place).  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json

import torch

from cfl_bench import run, spec
from cfl_bench.runners import fedtrain


def readings(workload: str, seed: int, seconds: float) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    ctx = run.context(workload, seed, dev)
    runner = spec.runner(ctx.traffic["kind"]).Runner(ctx)
    runner.setup()
    runner.window(seconds)
    runner.release()
    kind = ctx.traffic["kind"]
    if kind == "fedtrain":
        runner._full = runner.reference()
        return {"seed": seed,
                "program": fedtrain.compare(runner.first, runner._full),
                "control_tf32": runner.control(tf32=True),
                "fault_half_batch": runner.control(fault="half"),
                "fault_frozen": runner.control(fault="frozen")}
    out = {"seed": seed, "program": runner.checks(),
           "control_tf32": runner.control()}
    if kind == "coded_head":
        out["fault_answer"] = runner.control(fault=True)
        out["fault_plan"] = runner.plan_fault()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
