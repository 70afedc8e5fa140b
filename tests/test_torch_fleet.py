"""The fleet layer of the port (`FleetTopology`, `HierarchicalCFL`) against
the JAX package, on the CPU.

Bounds:
  * topology masks, gates and structure: bit-equal (a NumPy copy, the
    same `np.random.Generator` draws);
  * hierarchical training over UncodedFL, CodedFL and StochasticCodedFL
    (T = 3, with and without client subsampling), on both grad paths,
    against `jax.jit(repro.api.make_epoch_step(...))` epoch by epoch:
    times identical, NMSE within rtol 1e-4 over 30 epochs — the bound of
    `tests/test_torch_slice.py`;
  * the single-tier contract inside the port: a T = 1 hierarchical trace
    is bit-equal to the flat trace of its base (NumPy equality).  On the
    card it holds for the flat and Gram-folded paths by construction of
    the kernels (`tests/test_torch_cuda.py`, `chip_smoke.py`); here the
    plain versions run;
  * `report_extras`: equal keys and values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as j_api
from repro import fleet as j_fleet
from repro.core import cfl as j_cfl
from repro.plan.reference import solve_redundancy_reference
from repro_torch import api as t_api
from repro_torch import interop
from repro_torch.fleet import FleetTopology, HierarchicalCFL, HierState
from test_torch_schemes import port_plan, scfl_pair
from test_torch_slice import (ELL, EPOCHS, LR, _assert_same_run, _data,
                              _fleets, _jax_run)

J_TOPO = j_fleet.FleetTopology


@pytest.mark.parametrize("n,t", [(1, 1), (10, 3), (24, 3), (24, 1),
                                 (7, 7), (100, 8)])
def test_uniform_topology_bit_equal(n, t):
    got, want = FleetTopology.uniform(n, t), J_TOPO.uniform(n, t)
    np.testing.assert_array_equal(got.tier_of, want.tier_of)
    np.testing.assert_array_equal(got.sample_frac, want.sample_frac)
    assert got.tier_of.dtype == want.tier_of.dtype
    for ell in (1, 5):
        masks = got.tier_masks(ell)
        np.testing.assert_array_equal(masks, want.tier_masks(ell))
        assert masks.dtype == np.float32 and masks.shape == (t, n * ell)
    np.testing.assert_array_equal(got.tier_sizes(), want.tier_sizes())
    for a, b in zip(got.tier_members(), want.tier_members()):
        np.testing.assert_array_equal(a, b)
    assert got.structure_key() == want.structure_key() == (n, t)
    assert (got.n, got.n_tiers, got.subsampled) == \
        (want.n, want.n_tiers, want.subsampled)


@pytest.mark.parametrize("frac", [1.0, 0.5, [0.3, 1.0, 0.75]])
def test_gates_bit_equal(frac):
    rng = np.random.default_rng(0)
    tier_of = rng.permutation(np.arange(30) % 3)
    got = FleetTopology.from_assignment(tier_of, frac)
    want = J_TOPO.from_assignment(tier_of, frac)
    np.testing.assert_array_equal(got.tier_of, want.tier_of)
    np.testing.assert_array_equal(got.sample_frac, want.sample_frac)
    np.testing.assert_array_equal(got.tier_masks(4), want.tier_masks(4))
    g_rng, w_rng = np.random.default_rng(5), np.random.default_rng(5)
    gates = got.sample_gates(50, g_rng)
    np.testing.assert_array_equal(gates, want.sample_gates(50, w_rng))
    assert gates.dtype == np.float32 and gates.shape == (50, 30)
    # the generators advanced alike (no draws at all when not subsampled)
    assert g_rng.random() == w_rng.random()
    if not got.subsampled:
        np.testing.assert_array_equal(gates, 1.0)


@pytest.mark.parametrize("budget", [1, 7, 24, 100])
def test_round_budget_bit_equal(budget):
    got = FleetTopology.uniform(24, 3).with_round_budget(budget)
    want = J_TOPO.uniform(24, 3).with_round_budget(budget)
    np.testing.assert_array_equal(got.sample_frac, want.sample_frac)
    np.testing.assert_array_equal(
        got.sample_gates(20, np.random.default_rng(2)),
        want.sample_gates(20, np.random.default_rng(2)))


def test_topology_validation():
    for kw in ({"tier_of": [], "sample_frac": [1.0]},
               {"tier_of": [0, 2], "sample_frac": [1.0, 1.0]},
               {"tier_of": [0, 0], "sample_frac": [1.0, 1.0]},
               {"tier_of": [0, 1], "sample_frac": [1.0, 0.0]},
               {"tier_of": [0, 1], "sample_frac": [1.0, 1.5]}):
        with pytest.raises(ValueError):
            FleetTopology(**kw)
        with pytest.raises(ValueError):
            J_TOPO(**kw)
    with pytest.raises(ValueError):
        FleetTopology.uniform(3, 4)
    with pytest.raises(ValueError):
        FleetTopology.uniform(3, 1).with_round_budget(0)
    with pytest.raises(TypeError):
        HierarchicalCFL(t_api.UncodedFL(), topology=[0, 0])
    with pytest.raises(TypeError):
        HierarchicalCFL(object(), FleetTopology.uniform(3, 1))
    assert HierarchicalCFL(t_api.UncodedFL(),
                           FleetTopology.uniform(3, 1)).label == \
        "hier[uncoded]"


# (n clients, fleet seed, fixed_c): the CodedFL layout is packed here
CODED_CASE = (10, 5, 179)
TOPOLOGIES = {"t3": (3, 1.0), "t3_sub": (3, 0.6)}


def _topologies(n, name):
    t, frac = TOPOLOGIES[name]
    return (J_TOPO.uniform(n, t, sample_frac=frac),
            FleetTopology.uniform(n, t, sample_frac=frac))


def _base_pair(base, grad_path):
    """(jax base, jax base state, port base, port base state, jax fleet,
    port fleet, jax data, port data, seed)."""
    if base == "scfl":  # rho = 0.5 on the packed layout
        out = scfl_pair("packed", 0.5, grad_path)
        return (*out, 5)
    n, seed, c = CODED_CASE
    jf, tf = _fleets(n, seed)
    xs, ys, beta = _data(n, seed)
    jdata = j_api.TrainData(jnp.asarray(xs), jnp.asarray(ys),
                            jnp.asarray(beta))
    tdata = interop.train_data(xs, ys, beta, device="cpu")
    if base == "uncoded":
        j_b = j_api.UncodedFL(grad_path=grad_path)
        t_b = t_api.UncodedFL(grad_path=grad_path)
        return (j_b, j_b.plan(jf, jdata), t_b, t_b.plan(tf, tdata), jf, tf,
                jdata, tdata, seed)
    plan = solve_redundancy_reference(jf.edge, jf.server, np.full(n, ELL),
                                      fixed_c=c)
    key = jax.random.PRNGKey(seed)
    jstate = j_cfl.setup(key, jdata.xs, jdata.ys, jf.edge, jf.server,
                         plan=plan)
    tplan = port_plan(plan)
    tstate = interop.cfl_state(tplan, np.asarray(jstate.weights),
                               np.asarray(jstate.load_mask),
                               np.asarray(jstate.x_parity),
                               np.asarray(jstate.y_parity), tf.edge,
                               tf.server, device="cpu")
    j_b = j_api.CodedFL(key=key, fixed_c=c, redundancy_plan=plan,
                        include_upload_delay=False, grad_path=grad_path)
    t_b = t_api.CodedFL(key=seed, fixed_c=c, redundancy_plan=tplan,
                        include_upload_delay=False, grad_path=grad_path)
    return j_b, jstate, t_b, tstate, jf, tf, jdata, tdata, seed


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("base", ["uncoded", "coded", "scfl"])
def test_hierarchical_matches_reference(base, topo, grad_path):
    j_b, jbs, t_b, tbs, jf, tf, jdata, tdata, seed = _base_pair(base,
                                                                grad_path)
    j_topo, t_topo = _topologies(tdata.n, topo)
    j_h = j_fleet.HierarchicalCFL(j_b, j_topo)
    t_h = HierarchicalCFL(t_b, t_topo)
    jstate = j_fleet.HierState(base=jbs, topology=j_topo)
    tstate = HierState(base=tbs, topology=t_topo)
    want = _jax_run(j_h, jstate, jdata, jf, seed)
    got = t_api.Session(t_h, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=tstate)
    _assert_same_run(got, want)
    assert got.label == j_h.label
    assert got.extras == j_h.report_extras(jstate)
    assert got.uplink_bits_total == j_h.uplink_bits(jstate, jf, EPOCHS)
    if base != "uncoded" and grad_path == "fused":
        assert "sys_rows" in t_h.device_state(tstate, tdata)  # packed


def _single_tier_pair(base, grad_path):
    _, _, t_b, tbs, _, tf, _, tdata, seed = _base_pair(
        base.split("-")[0], grad_path)
    if base == "scfl-rho1":
        t_b = dataclasses.replace(t_b, sample_frac=1.0)
    return t_b, tbs, tf, tdata, seed


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
@pytest.mark.parametrize("base", ["uncoded", "coded", "scfl", "scfl-rho1"])
def test_single_tier_is_bit_equal_to_flat(base, grad_path):
    """The port's own single-tier contract on the CPU (plain versions)."""
    t_b, tbs, tf, tdata, seed = _single_tier_pair(base, grad_path)
    topo = FleetTopology.uniform(tdata.n, 1)
    flat = t_api.Session(t_b, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=tbs)
    hier = t_api.Session(HierarchicalCFL(t_b, topo), tf, LR, EPOCHS,
                         device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=HierState(tbs, topo))
    np.testing.assert_array_equal(hier.nmse, flat.nmse)
    np.testing.assert_array_equal(hier.times, flat.times)
    np.testing.assert_array_equal(hier.beta, flat.beta)


def test_plan_and_plan_with_wrap_the_base():
    _, tf = _fleets(8, 3)
    data = t_api.TrainData.linreg(0, 8, ELL, 16, device="cpu")
    topo = FleetTopology.uniform(8, 2)
    base = t_api.CodedFL(key=1, fixed_c=143, include_upload_delay=False)
    hier = HierarchicalCFL(base, topo)
    state = hier.plan(tf, data)
    assert isinstance(state, HierState) and state.topology is topo
    again = hier.plan_with(tf, data, state.base.plan)
    assert again.base.plan is state.base.plan
    np.testing.assert_array_equal(again.base.x_parity, state.base.x_parity)
    with pytest.raises(ValueError, match="topology covers"):
        HierarchicalCFL(base, FleetTopology.uniform(7, 2)).plan(tf, data)
