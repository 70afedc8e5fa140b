"""Find the rate a serving cell's engine sustains, once, on the card:

    python3 -m cfl_bench.sweep --workload mamba2-1.3b.prefill --seed 5 \
        --seconds 20

sends the cell's prompts back to back for `--seconds` (a closed loop: the
capacity in requests a second), then runs the cell's open-loop window at
fractions of that capacity and prints, for each, the median and 95th
percentile time to first token and the last request's wait.  The cell's
traffic file fixes its rate from this reading; runs of the benchmark
never search for one.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cfl_bench import run, spec
from cfl_bench import traffic as gen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fractions", default="0.6,0.7,0.8,0.9,1.0")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", torch.cuda.current_device())
    ctx = run.context(args.workload, args.seed, dev)
    runner = spec.runner(ctx.traffic["kind"]).Runner(ctx)
    runner.setup()
    t = ctx.traffic
    order = gen.prompt_lengths(args.seed, 100_000, t["prompt_min"],
                               t["prompt_max"])
    served = tokens = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        n = int(order[served])
        runner._serve(served, gen.prompt_tokens(args.seed, served, n,
                                                ctx.model["vocab"]))
        served += 1
        tokens += n
    elapsed = time.perf_counter() - t0
    capacity = served / elapsed
    out = {"capacity_per_s": capacity, "mean_prompt": tokens / served,
           "device": torch.cuda.get_device_name(dev), "rates": []}
    for frac in (float(f) for f in args.fractions.split(",")):
        ctx.traffic["rate_per_s"] = frac * capacity
        runner.window(args.seconds)
        ttft = np.asarray(runner.ttft)
        out["rates"].append({
            "fraction": frac, "rate_per_s": frac * capacity,
            "requests": int(ttft.size),
            "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
            "ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)),
            "last_ttft_ms": 1e3 * float(ttft[-1])})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
