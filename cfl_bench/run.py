"""Run one cell of the benchmark and print its result as the last line.

    python3 -m cfl_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run makes its weights and inputs from
`--seed`, builds and warms the port's objects (set-up), measures for
`--seconds` seconds, reads the device memory peak, frees the port's
state, and checks what the timed path produced against the plain
reference.  With `--trace 0` the result's metrics are the cell's
end-to-end metrics; with `--trace 1` its per-layer ones, read from spans
over the window and a `torch.profiler` trace of a steady part of it.
Each compared number and its limit are printed last on standard error
and last in the result's line, under "checks".

The run needs a CUDA device (as many as the cell asks for) and exits
non-zero without printing a result where there is none, where the port
is missing, or where `jax`, `jaxlib`, `flax` or the JAX package `repro`
is loaded once the window has closed.  Caches and kernel builds go to
`build/` inside the checkout.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


_environment()

import torch  # noqa: E402

from cfl_bench import spec, weights  # noqa: E402
from cfl_bench.runners import Context, sync  # noqa: E402
from cfl_bench.trace import Profile, Spans  # noqa: E402


class LayerRecord:
    """What a per-layer reader reads: the cell's configuration and
    traffic, the runner's counts of the window, the harness's spans and
    the trace."""

    def __init__(self, ctx: Context, data: dict, trace) -> None:
        self.workload = ctx.workload
        self.model = ctx.model
        self.traffic = ctx.traffic
        self.spans = ctx.spans
        self.data = data
        self.trace = trace


def context(workload_name: str, seed: int, device: torch.device,
            overrides: dict | None = None, tiny: bool = False) -> Context:
    """The cell's context.  `tiny` (tests on the CPU) runs the port's
    reduced config of the cell's model instead of the file's."""
    bench = spec.load_benchmark()
    cell = spec.workload(bench, workload_name)
    file = spec.config(bench, cell["config"])
    if tiny:
        cfg = weights.registered(weights.program_config(
            cell["config"], file["model"]).reduced())
        model = {k: v for k, v in dataclasses.asdict(cfg).items()
                 if k in file["model"]}
    else:
        cfg = weights.program_config(cell["config"], file["model"])
        model = file["model"]
    traffic = {**spec.traffic(cell["traffic"]), **(overrides or {})}
    return Context(workload=workload_name, config_name=cell["config"],
                   family=file["family"], model=model, traffic=traffic,
                   seed=seed % 2**64, device=device, program_config=cfg,
                   spans=Spans(), limits=spec.limits(workload_name))


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             tiny: bool = False) -> dict:
    """One run of a cell; returns the result object (without printing)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = spec.load_benchmark()
    ctx = context(workload_name, seed, dev, overrides, tiny)
    runner = spec.runner(ctx.traffic["kind"]).Runner(ctx)
    t_setup = time.perf_counter()
    runner.setup()
    sync(dev)
    setup_s = time.perf_counter() - START
    print(f"cfl_bench: set-up {setup_s:.3f} s: imports and context "
          f"{t_setup - START:.3f} s, " + ", ".join(
              f"{k} {ctx.spans.total(k):.3f} s" for k in ctx.spans.seconds
              if k.startswith("setup.")), file=sys.stderr)
    ctx.spans.seconds.clear()
    runner.window(seconds, (lambda host: Profile(ctx.spans, dev, host))
                  if trace else None)
    peak_bytes = runner.peak_bytes()
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": spec.workload(bench, workload_name)["chips"],
                   "memory_peak_bytes": peak_bytes}
    metrics, breakdown = {}, None
    if trace:
        traced = runner.trace.device
        if traced is None or runner.trace.host is None:
            raise RuntimeError("the window was too short to trace")
        record = LayerRecord(ctx, runner.layer_record(), traced)
        for m in spec.per_layer(bench, workload_name):
            value = spec.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device_info["busy_s"] = traced.busy_s()
        device_info["window_s"] = traced.window_s
        breakdown = {"device_ops": traced.breakdown()["device_ops"],
                     "idle_gaps": runner.trace.host.breakdown()["idle_gaps"]}
    else:
        values = {"setup_s": setup_s, **runner.end_to_end()}
        for m in spec.end_to_end(bench, workload_name):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    t_window = time.perf_counter()
    runner.release()
    numbers = runner.checks()
    print(f"cfl_bench: window and trace {t_window - START - setup_s:.3f} s, "
          f"reference {time.perf_counter() - t_window:.3f} s",
          file=sys.stderr)
    checks = {name: {"value": float(numbers[name]), "limit": float(limit)}
              for name, limit in ctx.limits.items()}
    correct = runner.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": runner.attempted,
              "failed": runner.failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = spec.workload(spec.load_benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cfl_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"cfl_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """Each compared number beside its limit, last on standard error, and
    the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
