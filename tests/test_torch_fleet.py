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
  * `report_extras`: equal keys and values;
  * `mega_fleet`, `wireless_fleet` and `sample_tier_rounds` (statistics,
    validation errors and the generator's state after): bit-equal;
  * `solve_fleet` against the port's batched solver on the reference
    test's request (`tests/test_fleet.py`): loads and c equal, t* rtol
    1e-4, p_return rtol 1e-6 / atol 1e-9 — the reference's own bounds
    for the same comparison; against `repro.plan.reference` at small n:
    the bounds of `tests/test_torch_plan.py` (loads and c equal, t*,
    p_return and expected_agg rtol 1e-3);
  * `encode_fleet_tiered` against JAX's (Pallas in interpret mode):
    2e-4 * max|ref|, the reference's encode bound; inside the port one
    tier is bit-equal to the flat encode and T tiers are within rtol
    1e-5 / atol 1e-6 of it (`tests/test_fleet.py`'s bounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro import api as j_api
from repro import fleet as j_fleet
from repro.core import cfl as j_cfl
from repro.plan.reference import solve_redundancy_reference
from repro.sim import network as j_network
from repro_torch import api as t_api
from repro_torch import interop
from repro_torch.fleet import (FleetTopology, HierarchicalCFL, HierState,
                               encode_fleet_tiered, sample_tier_rounds,
                               solve_fleet)
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.plan import PlanRequest, solve_redundancy_batched
from repro_torch.sim import network as t_network
from test_torch_plan import _problem as _plan_problem
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


# ---------------------------------------------------------------------------
# fleet generation and O(participants) round scheduling
# ---------------------------------------------------------------------------

def _assert_fleet_equal(got, want):
    for part in ("edge", "server"):
        for f in ("a", "mu", "tau", "p"):
            np.testing.assert_array_equal(getattr(getattr(got, part), f),
                                          getattr(getattr(want, part), f))
    for f in ("mac_rates", "link_rates"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("packet_bits", "d", "nu_comp", "nu_link"):
        assert getattr(got, f) == getattr(want, f)


@pytest.mark.parametrize("n,kw", [(24, {}), (5000, {"d": 16, "seed": 3}),
                                  (100, {"ladder_period": 7, "erasure_p": 0.2,
                                         "base_mac_kmacs": 800.0})])
def test_mega_fleet_bit_equal(n, kw):
    _assert_fleet_equal(t_network.mega_fleet(n, **kw),
                        j_network.mega_fleet(n, **kw))
    with pytest.raises(TypeError, match="unexpected"):
        t_network.mega_fleet(10, nonsense_knob=3)


@pytest.mark.parametrize("kw", [{}, {"seed": 4, "n": 40, "d": 32},
                                {"nu_erasure": 0.0, "base_erasure_p": 0.1}])
def test_wireless_fleet_bit_equal(kw):
    _assert_fleet_equal(t_network.wireless_fleet(**kw),
                        j_network.wireless_fleet(**kw))


def _j_params(edge):
    from repro.core.delay_model import DeviceDelayParams
    return DeviceDelayParams(a=edge.a, mu=edge.mu, tau=edge.tau, p=edge.p)


@pytest.mark.parametrize("n,tiers,budget,epochs", [(3000, 8, 100, 6),
                                                   (30, 3, None, 3),
                                                   (500, 5, 40, 12)])
def test_sample_tier_rounds_bit_equal(n, tiers, budget, epochs):
    fleet = t_network.mega_fleet(n, d=16, seed=1)
    loads = np.random.default_rng(3).integers(1, 9, size=n)
    topo = FleetTopology.uniform(n, tiers)
    j_topo = J_TOPO.uniform(n, tiers)
    if budget is not None:
        topo, j_topo = (topo.with_round_budget(budget),
                        j_topo.with_round_budget(budget))
    g_rng, w_rng = np.random.default_rng(4), np.random.default_rng(4)
    got = sample_tier_rounds(topo, fleet.edge, loads, epochs, g_rng)
    want = j_fleet.sample_tier_rounds(j_topo, _j_params(fleet.edge), loads,
                                      epochs, w_rng)
    for f in ("durations", "tier_max", "participants"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert got.total_participants == want.total_participants
    assert g_rng.random() == w_rng.random()  # the same draws were made
    if budget is None:
        np.testing.assert_array_equal(got.participants,
                                      np.full((epochs, tiers), n // tiers))


def test_sample_tier_rounds_validation():
    n = 30
    fleet = t_network.mega_fleet(n, d=16, seed=1)
    topo = FleetTopology.uniform(n, 3)
    with pytest.raises(ValueError, match="loads"):
        sample_tier_rounds(topo, fleet.edge, np.full(n + 1, 4), 3,
                           np.random.default_rng(0))
    other = t_network.mega_fleet(n + 1, d=16, seed=1)
    with pytest.raises(ValueError, match="edge params"):
        sample_tier_rounds(topo, other.edge, np.full(n, 4), 3,
                           np.random.default_rng(0))


# ---------------------------------------------------------------------------
# fleet-scale planning
# ---------------------------------------------------------------------------

def _paper_request(**kw):
    """The request of tests/test_fleet.py's solve_fleet checks."""
    fleet = t_network.paper_fleet(0.2, 0.2, seed=0, n=24, d=40)
    data_sizes = np.random.default_rng(2).integers(40, 81, size=24)
    return PlanRequest(edge=fleet.edge, server=fleet.server,
                       data_sizes=data_sizes, **kw)


@pytest.mark.parametrize("kw", [{"c_up": 400},
                                {"srv_weight": 0.5, "fixed_c": 64}])
def test_solve_fleet_matches_batched_solver(kw):
    req = _paper_request(**kw)
    batched = solve_redundancy_batched([req], eps_rel=1e-6, device="cpu")[0]
    fleet = solve_fleet(req, eps_rel=1e-6, device="cpu")
    np.testing.assert_array_equal(fleet.loads, batched.loads)
    assert fleet.c == batched.c
    assert fleet.t_star == pytest.approx(batched.t_star, rel=1e-4)
    np.testing.assert_allclose(fleet.p_return, batched.p_return, rtol=1e-6,
                               atol=1e-9)
    assert fleet.expected_agg >= req.m * (1.0 - 1e-9)
    assert fleet.loads_cap_total == req.m
    # chunks smaller than the fleet stream the same sum
    streamed = solve_fleet(req, eps_rel=1e-6, chunk=8, device="cpu")
    np.testing.assert_array_equal(streamed.loads, fleet.loads)
    assert streamed.t_star == pytest.approx(fleet.t_star, rel=1e-4)


@pytest.mark.parametrize("mode", ["free", "fixed"])
@pytest.mark.parametrize("n,ell,seed", [(5, 40, 123), (8, 60, 4242)])
def test_solve_fleet_matches_reference_oracle(n, ell, seed, mode):
    """The randomized fleets of tests/test_torch_plan.py."""
    (je, js), (te, ts), sizes, kw = _plan_problem(n, ell, mode, seed)
    ref = solve_redundancy_reference(je, js, sizes, eps_rel=1e-4, **kw)
    got = solve_fleet(PlanRequest(te, ts, sizes, **kw), eps_rel=1e-4,
                      device="cpu")
    np.testing.assert_array_equal(got.loads, ref.loads)
    assert got.c == ref.c
    np.testing.assert_allclose(got.t_star, ref.t_star, rtol=1e-3)
    np.testing.assert_allclose(got.p_return, ref.p_return, rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(got.expected_agg, ref.expected_agg,
                               rtol=1e-3)


def test_solve_fleet_scales_past_the_oracle_ceiling():
    """A fleet beyond the reference oracle's 16 384-client ceiling plans
    (chunk-streamed, five chunks) within every device's cap."""
    from repro.plan.reference import _MAX_ORACLE_N
    n = 17_000
    assert n > _MAX_ORACLE_N
    fleet = t_network.mega_fleet(n, d=16, seed=0)
    data_sizes = np.random.default_rng(1).integers(2, 9, size=n)
    req = PlanRequest(edge=fleet.edge, server=fleet.server,
                      data_sizes=data_sizes, c_up=256)
    plan = solve_fleet(req, eps_rel=1e-2, device="cpu")
    assert plan.loads.shape == (n,) and plan.loads.dtype == np.int64
    assert np.all(plan.loads <= data_sizes) and np.all(plan.loads >= 0)
    assert plan.expected_agg >= req.m * (1.0 - 1e-6)
    assert 0 <= plan.c <= 256 and plan.p_return.shape == (n + 1,)


def test_solve_fleet_rejects_the_partial_objective():
    with pytest.raises(NotImplementedError):
        solve_fleet(_paper_request(edge_chunks=4, fixed_c=64), device="cpu")


# ---------------------------------------------------------------------------
# tiered streamed encoding
# ---------------------------------------------------------------------------

def _encode_problem(n=6, ell=5, d=8):
    rng = np.random.default_rng(9)
    return (np.asarray(jax.random.PRNGKey(9)),
            rng.standard_normal((n, ell, d)).astype(np.float32),
            rng.standard_normal((n, ell)).astype(np.float32),
            rng.uniform(0.5, 1.5, (n, ell)).astype(np.float32))


PERMUTED_TIERS = np.array([2, 0, 1, 0, 2, 1])


@pytest.mark.parametrize("kind", ["normal", "bernoulli"])
def test_encode_tiered_matches_reference(kind):
    key, xs, ys, w = _encode_problem()
    jx, jy = j_fleet.encode_fleet_tiered(
        jnp.asarray(key), jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(w),
        4, J_TOPO.from_assignment(PERMUTED_TIERS), kind=kind,
        force_interpret=True)
    tx, ty = encode_fleet_tiered(key, torch.tensor(xs), torch.tensor(ys),
                                 torch.tensor(w), 4,
                                 FleetTopology.from_assignment(
                                     PERMUTED_TIERS), kind=kind)
    for got, want in ((tx, jx), (ty, jy)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["normal", "bernoulli"])
def test_encode_tiered_single_tier_and_partition(kind):
    key, xs, ys, w = _encode_problem()
    args = (torch.tensor(xs), torch.tensor(ys), torch.tensor(w), 4)
    x_flat, y_flat = enc_ops.encode_fleet_prng(key, *args, kind=kind)
    x_one, y_one = encode_fleet_tiered(key, *args,
                                       FleetTopology.uniform(6, 1), kind=kind)
    assert torch.equal(x_one, x_flat) and torch.equal(y_one, y_flat)
    x_t, y_t = encode_fleet_tiered(
        key, *args, FleetTopology.from_assignment(PERMUTED_TIERS), kind=kind)
    np.testing.assert_allclose(x_t.numpy(), x_flat.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(y_t.numpy(), y_flat.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_encode_tiered_validates_fleet_size():
    key, xs, ys, w = _encode_problem()
    with pytest.raises(ValueError, match="topology covers"):
        encode_fleet_tiered(key, torch.tensor(xs), torch.tensor(ys),
                            torch.tensor(w), 4, FleetTopology.uniform(7, 2))
