"""`GradientCodingFL`, `core.gradient_coding` and the legacy simulator
shims of the port against the JAX package, on the CPU.

Both packages get the same NumPy data and fleet and the same
`np.random.default_rng` seed.  The JAX side trains epoch by epoch through
`jax.jit(repro.api.make_epoch_step(...))` (its `Session.run` fails on
this JAX), the port through `Session.run`.

Bounds:
  * `make_plan`, `epoch_time`, the strategy's plan (share bits, shard
    time) and its epoch schedules: bit-equal (the same NumPy expressions
    and generator draws);
  * `group_gradients`: rtol 1e-4 / atol 1e-4 (float32 sums in another
    order);
  * training, flat and under `HierarchicalCFL` (T = 3, with and without
    client subsampling), on both gradient paths: times identical, NMSE
    within rtol 1e-4 over 30 epochs — the bound of
    `tests/test_torch_slice.py`;
  * inside the port: a T = 1 hierarchical run bit-equal to the flat run,
    and the shims (`run_gradient_coding`, `sim.simulator.run_uncoded`,
    `run_cfl`) bit-equal to the `Session` runs they wrap.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro import fleet as j_fleet
from repro.core import gradient_coding as j_gc
from repro_torch import api as t_api
from repro_torch import interop
from repro_torch.core import gradient_coding as t_gc
from repro_torch.fleet import FleetTopology, HierarchicalCFL, HierState
from repro_torch.sim import simulator
from test_torch_slice import (ELL, EPOCHS, LR, _assert_same_run, _data,
                              _fleets, _jax_run)

# (n clients, fleet seed, r)
CASES = {"r2": (8, 3, 2), "r3": (12, 4, 3), "r4": (8, 5, 4)}


def gc_pair(case, grad_path="fused"):
    """(jax strategy, jax state, port strategy, port state, jax fleet,
    port fleet, jax data, port data, seed)."""
    n, seed, r = CASES[case]
    jf, tf = _fleets(n, seed)
    xs, ys, beta = _data(n, seed)
    jdata = j_api.TrainData(jnp.asarray(xs), jnp.asarray(ys),
                            jnp.asarray(beta))
    tdata = interop.train_data(xs, ys, beta, device="cpu")
    j_s = j_api.GradientCodingFL(r=r, grad_path=grad_path)
    t_s = t_api.GradientCodingFL(r=r, grad_path=grad_path)
    return (j_s, j_s.plan(jf, jdata), t_s, t_s.plan(tf, tdata), jf, tf,
            jdata, tdata, seed)


@pytest.mark.parametrize("n,r", [(8, 1), (8, 2), (12, 3), (12, 4),
                                 (24, 6)])
def test_make_plan_bit_equal(n, r):
    got, want = t_gc.make_plan(n, r), j_gc.make_plan(n, r)
    assert got.r == want.r
    assert got.tolerated_stragglers_per_group == \
        want.tolerated_stragglers_per_group
    np.testing.assert_array_equal(got.groups, want.groups)
    assert got.groups.dtype == want.groups.dtype
    with pytest.raises(ValueError, match="does not divide"):
        t_gc.make_plan(n + 1, 2 if r == 1 else r)


@pytest.mark.parametrize("case", sorted(CASES))
def test_epoch_time_bit_equal(case):
    n, seed, r = CASES[case]
    jf, tf = _fleets(n, seed)
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        assert t_gc.epoch_time(tf, t_gc.make_plan(n, r), ELL, rng_t) == \
            j_gc.epoch_time(jf, j_gc.make_plan(n, r), ELL, rng_j)
    assert rng_t.bit_generator.state == rng_j.bit_generator.state


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_gradients_matches_reference(case):
    n, seed, r = CASES[case]
    xs, ys, _ = _data(n, seed)
    beta = np.random.default_rng(seed).standard_normal(xs.shape[-1]) \
        .astype(np.float32)
    want = np.asarray(j_gc.group_gradients(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(beta),
        j_gc.make_plan(n, r)))
    got = t_gc.group_gradients(torch.tensor(xs), torch.tensor(ys),
                               torch.tensor(beta), t_gc.make_plan(n, r))
    assert tuple(got.shape) == want.shape == (n // r, xs.shape[-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradcode_plan_and_schedules_bit_equal(case):
    j_s, jstate, t_s, tstate, jf, tf, _, _, seed = gc_pair(case)
    np.testing.assert_array_equal(tstate.plan.groups, jstate.plan.groups)
    assert (tstate.n_groups, tstate.ell, tstate.share_bits,
            tstate.shard_time) == (jstate.n_groups, jstate.ell,
                                   jstate.share_bits, jstate.shard_time)
    want = j_s.sample_epochs(jstate, jf, 40, np.random.default_rng(seed))
    got = t_s.sample_epochs(tstate, tf, 40, np.random.default_rng(seed))
    assert sorted(got.arrivals) == sorted(want.arrivals) == ["group_ok"]
    np.testing.assert_array_equal(got.arrivals["group_ok"],
                                  want.arrivals["group_ok"])
    assert got.arrivals["group_ok"].dtype == want.arrivals["group_ok"].dtype
    np.testing.assert_array_equal(got.durations, want.durations)
    assert (got.setup_time, got.t0) == (want.setup_time, want.t0)
    # the state the interop builds from the reference's is the port's own
    again = interop.gradcoding_state(jstate.plan.r, jstate.plan.groups,
                                     jstate.n_groups, jstate.ell,
                                     jstate.share_bits, jstate.shard_time)
    np.testing.assert_array_equal(again.plan.groups, tstate.plan.groups)
    assert again.shard_time == tstate.shard_time


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gradcode_matches_reference(case, grad_path):
    j_s, jstate, t_s, tstate, jf, tf, jdata, tdata, seed = gc_pair(
        case, grad_path)
    want = _jax_run(j_s, jstate, jdata, jf, seed)
    got = t_api.Session(t_s, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=tstate)
    _assert_same_run(got, want)
    assert got.setup_time == jstate.shard_time
    assert got.uplink_bits_total == j_s.uplink_bits(jstate, jf, EPOCHS)
    assert got.label == want.label == "gradcode"


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
@pytest.mark.parametrize("frac", [1.0, 0.6])
def test_gradcode_hierarchical_matches_reference(frac, grad_path):
    j_b, jbs, t_b, tbs, jf, tf, jdata, tdata, seed = gc_pair("r3",
                                                             grad_path)
    j_topo = j_fleet.FleetTopology.uniform(tdata.n, 3, sample_frac=frac)
    t_topo = FleetTopology.uniform(tdata.n, 3, sample_frac=frac)
    j_h = j_fleet.HierarchicalCFL(j_b, j_topo)
    t_h = HierarchicalCFL(t_b, t_topo)
    want = _jax_run(j_h, j_fleet.HierState(base=jbs, topology=j_topo),
                    jdata, jf, seed)
    got = t_api.Session(t_h, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed),
        state=HierState(tbs, t_topo))
    _assert_same_run(got, want)
    assert got.label == j_h.label == "hier[gradcode]"
    assert got.extras == j_h.report_extras(
        j_fleet.HierState(base=jbs, topology=j_topo))


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
def test_gradcode_single_tier_is_bit_equal_to_flat(grad_path):
    _, _, t_s, tstate, _, tf, _, tdata, seed = gc_pair("r2", grad_path)
    topo = FleetTopology.uniform(tdata.n, 1)
    flat = t_api.Session(t_s, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=tstate)
    hier = t_api.Session(HierarchicalCFL(t_s, topo), tf, LR, EPOCHS,
                         device="cpu").run(
        tdata, rng=np.random.default_rng(seed),
        state=HierState(tstate, topo))
    np.testing.assert_array_equal(hier.nmse, flat.nmse)
    np.testing.assert_array_equal(hier.times, flat.times)


def test_run_gradient_coding_is_the_session_run():
    _, _, t_s, _, _, tf, _, tdata, seed = gc_pair("r2")
    args = (tf, tdata.xs, tdata.ys, tdata.beta_true, LR, EPOCHS)
    shim = t_gc.run_gradient_coding(*args, np.random.default_rng(seed),
                                    r=2, device="cpu")
    sess = t_api.Session(t_s, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(shim.nmse, sess.nmse)
    np.testing.assert_array_equal(shim.times, sess.times)
    assert shim.label == "gradcode" and shim.nmse[-1] < shim.nmse[0]


def test_simulator_shims_are_the_session_runs():
    """`run_uncoded` / `run_cfl` give the `Session` runs' traces for the
    same generator; `generate_linreg` is `TrainData.linreg`."""
    _, tf = _fleets(8, 3)
    xs, ys, beta = simulator.generate_linreg(0, 8, ELL, 16, device="cpu")
    data = t_api.TrainData.linreg(0, 8, ELL, 16, device="cpu")
    for got, want in zip((xs, ys, beta),
                         (data.xs, data.ys, data.beta_true)):
        assert torch.equal(got, want)
    unc = simulator.run_uncoded(tf, xs, ys, beta, LR, EPOCHS,
                                np.random.default_rng(1), device="cpu")
    unc_s = t_api.Session(t_api.UncodedFL(), tf, LR, EPOCHS,
                          device="cpu").run(data,
                                            rng=np.random.default_rng(1))
    cfl = simulator.run_cfl(tf, xs, ys, beta, LR, EPOCHS,
                            np.random.default_rng(1), key=2, fixed_c=143,
                            device="cpu")
    cfl_s = t_api.Session(t_api.CodedFL(key=2, fixed_c=143), tf, LR,
                          EPOCHS, device="cpu").run(
        data, rng=np.random.default_rng(1))
    for got, want in ((unc, unc_s), (cfl, cfl_s)):
        np.testing.assert_array_equal(got.nmse, want.nmse)
        np.testing.assert_array_equal(got.times, want.times)
        assert got.setup_time == want.setup_time
    assert simulator.SimResult is t_api.TraceReport
