"""Every entry of BENCHMARK.json resolves to its files by name, and the
file keeps to the benchmark's contract on names, units and keys."""
import json
import re

import pytest
import torch

from cfl_bench import run, spec, weights

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert 1 <= len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert all((spec.ROOT / p).is_dir() for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keep_their_keys_and_names(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_resolves_to_its_file_family_and_reference(config):
    entry = spec._named(BENCH["configs"], config, "config")
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    file = spec.config(BENCH, config)
    assert file["name"] == config
    assert file["reduced"] == entry["reduced"]
    assert spec.family(file["family"]).leaves(file["model"])
    assert hasattr(spec.reference(file["family"]), "forward")
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_weights_fill_the_ports_parameter_tree(workload, tiny):
    # at full size on the meta device: shapes only, nothing allocated
    ctx = run.context(workload, 1, torch.device("cpu"), tiny=tiny)
    weights.check_tree(ctx.family, ctx.model, ctx.program_config)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves_and_reports_what_it_must(workload):
    cell = spec.workload(BENCH, workload)
    assert cell["chips"] in (1, 4)
    traffic = spec.traffic(cell["traffic"])
    assert hasattr(spec.runner(traffic["kind"]), "Runner")
    assert spec.limits(workload)
    e2e = {m["name"] for m in spec.end_to_end(BENCH, workload)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(BENCH, workload)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader_and_moves_a_reported_metric(metric):
    m = spec._named(BENCH["per_layer"], metric, "metric")
    assert callable(spec.metric_reader(metric))
    for cell in m.get("workloads", []):
        assert m["moves"] in {e["name"] for e in spec.end_to_end(BENCH, cell)}
    if "roofline" in metric or "mfu" in metric:
        assert m["unit"] == "%"


def test_bounds_and_layers():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = spec._named(BENCH["end_to_end"], "setup_s", "metric")
    assert "workloads" not in setup
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
