"""On the card, at each cell's own size: a sound run of the port reads
inside every limit, and the control (the reference in TF32 in the port's
place), or a training fault, fails at least one; a plan one parity row
off fails the coded head's `plan_gap`.  Skips without a card;
on one, run `python3 -m pytest -q cfl_bench -m cuda`."""
import pytest
import torch

from cfl_bench import control, spec

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(card, workload):
    limits = spec.limits(workload)
    out = control.readings(workload, 2**31 + 97, 3.0)
    assert all(out["program"][k] <= v for k, v in limits.items())
    for key in ("control_tf32", "fault_half_batch", "fault_frozen",
                "fault_answer"):
        if key in out:
            assert any(out[key][k] > v for k, v in limits.items()
                       if k in out[key]), key
    if "fault_plan" in out:
        assert all(v > limits["plan_gap"]
                   for v in out["fault_plan"].values())
