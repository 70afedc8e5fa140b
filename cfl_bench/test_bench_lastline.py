"""A tiny run of each traffic mix on the CPU (the port's reduced config of
the cell's model, small traffic), through the harness's own printing:
the last line of standard output is one JSON object with exactly the
contract's keys, and the checks come out correct."""
import json

import pytest

from cfl_bench import run

TINY = {
    "mamba2-1.3b.fedtrain": {"seq_len": 16},
    "mamba2-1.3b.prefill": {"prompt_min": 8, "prompt_max": 24,
                            "warm_lengths": [24, 8], "rate_per_s": 100.0,
                            "check_requests": 3,
                            "trace": {"units": 2, "host_units": 1}},
    "granite-8b.coded-head": {"trace": {"skip_units": 0, "units": 1,
                                        "host_units": 1}},
}
SECONDS = {"mamba2-1.3b.fedtrain": 0.3, "mamba2-1.3b.prefill": 0.2,
           "granite-8b.coded-head": 0.1}


def tiny_run(workload, trace=False, seed=2**31 + 5):
    return run.run_cell(workload, seed, SECONDS[workload], trace,
                        device="cpu", overrides=TINY[workload], tiny=True)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_last_line_has_the_contract_keys(workload, capsys):
    run.emit(tiny_run(workload))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    bench = run.spec.load_benchmark()
    assert set(line["metrics"]) == {
        m["name"] for m in run.spec.end_to_end(bench, workload)}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert [ln.split()[1] for ln in last] == list(line["checks"])


def test_traced_line_carries_the_trace_keys(capsys):
    run.emit(tiny_run("mamba2-1.3b.prefill", trace=True))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "prefill_tokens_per_s" in line["metrics"]
