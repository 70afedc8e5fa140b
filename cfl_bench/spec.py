"""`BENCHMARK.json` and the files it names, found by name."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of config `name`, as it is run."""
    entry = _named(bench["configs"], name, "config")
    return json.loads((root / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(workload_name: str) -> dict:
    return json.loads((BENCH / "limits" / f"{workload_name}.json").read_text())


def end_to_end(bench: dict, workload_name: str) -> list[dict]:
    """The end-to-end metrics a cell reports: those that list it, and
    those that list no cells (every cell reports them)."""
    return [m for m in bench["end_to_end"]
            if workload_name in m.get("workloads", [workload_name])]


def per_layer(bench: dict, workload_name: str) -> list[dict]:
    """The per-layer metrics a cell's traced run reads: those that list
    it, and those that list no cells but move one of its end-to-end
    metrics."""
    moved = {m["name"] for m in end_to_end(bench, workload_name)}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (workload_name in cells) if cells is not None else \
                m["moves"] in moved:
            out.append(m)
    return out


def metric_reader(name: str):
    """`read(record) -> float | None` of metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"cfl_bench.metrics._{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def family(name: str):
    return importlib.import_module(f"cfl_bench.families.{name}")


def runner(kind: str):
    return importlib.import_module(f"cfl_bench.runners.{kind}")


def reference(family_name: str):
    return importlib.import_module(f"cfl_bench.reference.{family_name}")
