"""`StochasticCodedFL` and the `srv_weight` planner of the port against the
JAX package, on the CPU.

Both packages get the same NumPy data and fleet, the reference's plan
(`repro.plan.reference_schemes.solve_stochastic_reference`), the
reference's noised parity (`StochasticCodedFL.plan_with` on that plan,
carried across with `repro_torch.interop`) and the same
`np.random.default_rng` seed.  The JAX side trains epoch by epoch through
`jax.jit(repro.api.make_epoch_step(...))`, the port through
`Session.run(..., state=...)`.

Bounds:
  * planner against the scalar oracle: loads and c exact, t* and the
    expected aggregate within rtol 1e-3 — the reference's own bound for
    its grid solver (`tests/test_schemes.py`); both solve to the same
    eps_rel (1e-4 on random fleets, 1e-3 and 1e-4 at §IV);
  * `effective_srv_weight`, the noise scales and the epoch schedules:
    bit-equal (the same float64 and NumPy expressions, the same
    generator draws);
  * training: times identical, NMSE within rtol 1e-4 over 30 epochs — the
    bound of `tests/test_torch_slice.py` (float32 gradients summed in
    another order);
  * `report_extras` and the uplink total: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro import plan as j_plan
from repro.core.redundancy import _fleet_with_server as j_with_server
from repro.core.redundancy import systematic_weights as j_weights
from repro.core.returns import optimal_loads as j_optimal_loads
from repro.plan.reference_schemes import (solve_stochastic_reference,
                                          stochastic_noise_scale)
from repro.schemes import StochasticCodedFL as JSCFL
from repro.sim.network import paper_fleet as j_paper_fleet
from repro_torch import api as t_api
from repro_torch import interop
from repro_torch.core.delay_model import DeviceDelayParams as TParams
from repro_torch.core.redundancy import _fleet_with_server
from repro_torch.core.returns import optimal_loads
from repro_torch.plan import (PlanRequest, effective_srv_weight,
                              solve_redundancy_batched)
from repro_torch.schemes import StochasticCodedFL as TSCFL
from repro_torch.sim.network import paper_fleet
from test_torch_slice import (ELL, EPOCHS, LR, _assert_same_run, _data,
                              _fleets, _jax_run)

# (n clients, fleet seed, fixed_c, noise multiplier): the fused layout is
# dense in the first case and packed in the second, at both rho
CASES = {"dense": (8, 3, 143, 0.5), "packed": (10, 5, 320, 0.25)}

# The SCFL plan at the §IV point (srv_weight 0.5 / (1 + 0.5^2) = 0.64,
# fixed_c = 2016); its padded support (6656 rows) is above 0.85 m, so the
# fused layout is dense.
SEC4_SCFL_LOADS = [300, 300, 268, 300, 300, 300, 193, 300, 0, 300, 0, 300,
                   300, 300, 300, 300, 300, 300, 300, 0, 300, 300, 300, 300]


def port_plan(plan):
    return interop.redundancy_plan(plan.loads, plan.c, plan.t_star,
                                   plan.p_return, plan.expected_agg,
                                   plan.loads_cap_total)


def port_scfl_state(jstate, tplan, tf, device="cpu"):
    return interop.stochastic_state(
        tplan, np.asarray(jstate.load_mask), np.asarray(jstate.x_parity),
        np.asarray(jstate.y_parity), tf.edge, tf.server,
        jstate.noise_scale_x, jstate.noise_scale_y, jstate.srv_weight,
        device=device)


def scfl_pair(case, rho, grad_path):
    """(jax strategy, jax state, port strategy, port state, jax fleet,
    port fleet, jax data, port data) on the case's reference plan."""
    n, seed, c, sigma = CASES[case]
    jf, tf = _fleets(n, seed)
    xs, ys, beta = _data(n, seed)
    srv_w = float(j_plan.effective_srv_weight(sigma, rho))
    plan = solve_stochastic_reference(jf.edge, jf.server, np.full(n, ELL),
                                      srv_weight=srv_w, fixed_c=c)
    jdata = j_api.TrainData(jnp.asarray(xs), jnp.asarray(ys),
                            jnp.asarray(beta))
    j_s = JSCFL(key=jax.random.PRNGKey(seed), noise_multiplier=sigma,
                sample_frac=rho, fixed_c=c, redundancy_plan=plan,
                include_upload_delay=False, grad_path=grad_path)
    jstate = j_s.plan_with(jf, jdata, plan)
    tplan = port_plan(plan)
    t_s = TSCFL(key=seed, noise_multiplier=sigma, sample_frac=rho,
                fixed_c=c, redundancy_plan=tplan,
                include_upload_delay=False, grad_path=grad_path)
    tstate = port_scfl_state(jstate, tplan, tf)
    tdata = interop.train_data(xs, ys, beta, device="cpu")
    return j_s, jstate, t_s, tstate, jf, tf, jdata, tdata


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
@pytest.mark.parametrize("rho", [0.5, 1.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scfl_matches_reference(case, rho, grad_path):
    j_s, jstate, t_s, tstate, jf, tf, jdata, tdata = scfl_pair(
        case, rho, grad_path)
    seed = CASES[case][1]
    want = _jax_run(j_s, jstate, jdata, jf, seed)
    got = t_api.Session(t_s, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=tstate)
    if grad_path == "fused":
        layout = t_s.device_state(tstate, tdata)
        assert ("sys_x" in layout) == (case == "packed")
        assert ("x_parity" in layout) == (rho < 1.0)
    _assert_same_run(got, want)
    assert got.extras == j_s.report_extras(jstate)
    assert got.uplink_bits_total == j_s.uplink_bits(jstate, jf, EPOCHS)


@pytest.mark.parametrize("rho", [0.5, 1.0])
def test_scfl_schedules_bit_equal(rho):
    j_s, jstate, t_s, tstate, jf, tf, _, _ = scfl_pair("dense", rho,
                                                       "fused")
    want = j_s.sample_epochs(jstate, jf, 40, np.random.default_rng(11))
    got = t_s.sample_epochs(tstate, tf, 40, np.random.default_rng(11))
    assert sorted(got.arrivals) == sorted(want.arrivals)
    for k in want.arrivals:
        np.testing.assert_array_equal(got.arrivals[k], want.arrivals[k])
        assert got.arrivals[k].dtype == want.arrivals[k].dtype
    np.testing.assert_array_equal(got.durations, want.durations)
    assert (got.setup_time, got.t0) == (want.setup_time, want.t0)
    if rho < 1.0:  # parity rows were really subsampled
        assert 0.0 < want.arrivals["parity_mask"].mean() < 1.0


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.7])
def test_scfl_plan_with_noise_scales_bit_equal(sigma):
    """The port's own plan_with on the reference plan: the same load mask,
    noise scales bit-equal to the reference's state and to
    `stochastic_noise_scale`, and parity of the planned shape."""
    j_s, jstate, t_s, _, jf, tf, jdata, tdata = scfl_pair("dense", 0.5,
                                                          "fused")
    n, _, c, _ = CASES["dense"]
    j_s = JSCFL(key=j_s.key, noise_multiplier=sigma, sample_frac=0.5,
                fixed_c=c, include_upload_delay=False)
    jstate = j_s.plan_with(jf, jdata, jstate.plan)
    t_s = TSCFL(key=3, noise_multiplier=sigma, sample_frac=0.5, fixed_c=c,
                include_upload_delay=False)
    tstate = t_s.plan_with(tf, tdata, port_plan(jstate.plan))
    weights = np.stack(j_weights(jstate.plan, np.full(n, ELL)))
    oracle = stochastic_noise_scale(np.asarray(jdata.xs),
                                    np.asarray(jdata.ys), weights, sigma)
    assert (tstate.noise_scale_x, tstate.noise_scale_y) == \
        (jstate.noise_scale_x, jstate.noise_scale_y)
    assert (tstate.noise_scale_x, tstate.noise_scale_y) == \
        tuple(float(v) for v in oracle)
    assert tstate.srv_weight == jstate.srv_weight == t_s.srv_weight
    np.testing.assert_array_equal(tstate.load_mask.numpy(),
                                  np.asarray(jstate.load_mask))
    assert tuple(tstate.x_parity.shape) == (c, tdata.d)
    assert tuple(tstate.y_parity.shape) == (c,)
    if sigma == 0.0:  # no noise drawn: the parity is CodedFL's, same key
        cfl = t_api.CodedFL(key=3, fixed_c=c).plan_with(
            tf, tdata, port_plan(jstate.plan))
        assert torch.equal(tstate.x_parity, cfl.x_parity)
        assert torch.equal(tstate.y_parity, cfl.y_parity)


def test_scfl_port_plans_and_trains_on_its_own():
    """The port's own path end to end on the CPU: its srv_weight planner,
    its torch.Generator encode and noise, training on both grad paths."""
    _, tf = _fleets(8, 3)
    data = t_api.TrainData.linreg(0, 8, ELL, 16, device="cpu")
    reports = {}
    for grad_path in ("fused", "reference"):
        strategy = TSCFL(key=1, fixed_c=143, sample_frac=0.8,
                         include_upload_delay=False, grad_path=grad_path)
        sess = t_api.Session(strategy, tf, LR, EPOCHS, device="cpu")
        state = sess.plan(data)
        assert state.c == 143 and state.srv_weight == 0.64
        reports[grad_path] = sess.run(data, rng=np.random.default_rng(0),
                                      state=state)
    fused, ref = reports["fused"], reports["reference"]
    assert fused.nmse[0] == 1.0 and fused.nmse[-1] < 0.1
    assert np.all(np.diff(fused.nmse[:10]) < 0)
    np.testing.assert_array_equal(fused.times, ref.times)
    np.testing.assert_allclose(fused.nmse, ref.nmse, rtol=1e-4)
    assert fused.extras["srv_weight"] == 0.64


def _random_fleet(rng, n):
    """Randomized fleets as in tests/test_plan_solver.py."""
    a = rng.uniform(1e-3, 5e-2, n)
    mu = (2.0 / a) * rng.uniform(0.5, 2.0, n)
    tau = rng.uniform(1e-3, 5e-2, n)
    p = rng.uniform(0.0, 0.3, n)
    sa = np.array([a.min() / 10.0])
    return (a, mu, tau, p), (sa, 2.0 / sa, np.zeros(1), np.zeros(1))


@pytest.mark.parametrize("mode", ["free", "fixed"])
@pytest.mark.parametrize("srv_w", [0.3, 0.64])
@pytest.mark.parametrize("n,ell,seed", [(3, 25, 17), (5, 40, 123),
                                        (8, 60, 4242)])
def test_srv_weight_planner_matches_oracle(n, ell, seed, srv_w, mode):
    from repro.core.delay_model import DeviceDelayParams as JParams
    rng = np.random.default_rng(seed)
    edge, server = _random_fleet(rng, n)
    sizes = rng.integers(ell // 2 + 1, ell + 1, size=n)
    m = int(sizes.sum())
    kw = {"fixed_c": int(rng.integers(m // 10 + 1, m + 1))} \
        if mode == "fixed" else {"c_up": int(rng.integers(m // 10 + 1,
                                                         m + 1))}
    ref = solve_stochastic_reference(JParams(*edge), JParams(*server),
                                     sizes, srv_weight=srv_w, eps_rel=1e-4,
                                     **kw)
    got = solve_redundancy_batched(
        [PlanRequest(TParams(*edge), TParams(*server), sizes,
                     srv_weight=srv_w, **kw)], eps_rel=1e-4, device="cpu")[0]
    np.testing.assert_array_equal(got.loads, ref.loads)
    assert got.c == ref.c
    np.testing.assert_allclose(got.t_star, ref.t_star, rtol=1e-3)
    np.testing.assert_allclose(got.expected_agg, ref.expected_agg,
                               rtol=1e-3)


def test_srv_weight_one_is_the_base_objective():
    """srv_weight = 1.0 multiplies exactly: the plan is the base plan bit
    for bit, and a lighter weight needs a later deadline."""
    fleet = paper_fleet(0.2, 0.2, seed=0, n=8, d=50)
    base = PlanRequest(fleet.edge, fleet.server, np.full(8, 100),
                       fixed_c=200)
    weighted = PlanRequest(fleet.edge, fleet.server, np.full(8, 100),
                           fixed_c=200, srv_weight=1.0)
    light = PlanRequest(fleet.edge, fleet.server, np.full(8, 100),
                        fixed_c=200, srv_weight=0.5)
    a, b, c = solve_redundancy_batched([base, weighted, light],
                                       device="cpu")
    assert a.t_star == b.t_star and a.expected_agg == b.expected_agg
    np.testing.assert_array_equal(a.loads, b.loads)
    assert c.t_star > a.t_star


@pytest.mark.parametrize("eps_rel,device6", [(1e-3, 193), (1e-4, 192)])
def test_section4_scfl_plan(eps_rel, device6):
    """The §IV SCFL plan (fixed_c = 2016, srv_weight 0.64): at the default
    eps_rel = 1e-3 (the driven configuration) c and the loads are
    SEC4_SCFL_LOADS; at either eps_rel they equal the oracle's at the same
    eps_rel and the float64 host argmax at the port's t*.  Device 6's
    load moves with where t* lands: 193 at t* = 17.01867 s, 192 at
    17.00833 s."""
    sizes = np.full(24, 300)
    srv_w = float(effective_srv_weight(0.5, 0.8))
    assert srv_w == 0.64
    fleet = paper_fleet(0.2, 0.2, seed=0)
    got = solve_redundancy_batched(
        [PlanRequest(fleet.edge, fleet.server, sizes, fixed_c=2016,
                     srv_weight=srv_w)], eps_rel=eps_rel, device="cpu")[0]
    jfleet = j_paper_fleet(0.2, 0.2, seed=0)
    ref = solve_stochastic_reference(jfleet.edge, jfleet.server, sizes,
                                     srv_weight=srv_w, fixed_c=2016,
                                     eps_rel=eps_rel)
    want = SEC4_SCFL_LOADS[:6] + [device6] + SEC4_SCFL_LOADS[7:]
    assert got.c == ref.c == 2016
    assert got.loads.tolist() == ref.loads.tolist() == want
    np.testing.assert_allclose(got.t_star, ref.t_star, rtol=1e-3)
    host, _ = optimal_loads(_fleet_with_server(fleet.edge, fleet.server),
                            np.concatenate([sizes, [2016]]), got.t_star)
    j_host, _ = j_optimal_loads(
        j_with_server(jfleet.edge, jfleet.server),
        np.concatenate([sizes, [2016]]), got.t_star)
    assert host[:-1].tolist() == want
    assert j_host.tolist() == host.tolist()


def test_effective_srv_weight_bit_equal():
    sigma = np.array([0.0, 0.25, 0.5, 1.0, 3.0])
    rho = np.array([1.0, 0.8, 0.5, 0.3, 0.9])
    np.testing.assert_array_equal(effective_srv_weight(sigma, rho),
                                  j_plan.effective_srv_weight(sigma, rho))
    assert float(effective_srv_weight(0.5, 0.8)) == \
        float(j_plan.effective_srv_weight(0.5, 0.8))


def test_unported_objectives_and_privacy_raise():
    """Nothing raises for being unported any more: the MEC objective
    (CodedFedL), the partial-return objective and the privacy budget
    construct (`tests/test_torch_codedfedl.py`,
    `tests/test_torch_lowlatency.py`, `tests/test_torch_privacy.py` hold
    them to the reference); the invalid requests still raise.  The name
    is the one this test had while these were refused; it is kept so
    that the test's record stays traceable."""
    fleet = paper_fleet(seed=0, n=4, d=8)
    sizes = np.full(4, 8)
    assert PlanRequest(fleet.edge, fleet.server, sizes,
                       mec_comm=True).mec_comm
    with pytest.raises(ValueError, match="mec_comm"):
        PlanRequest(fleet.edge, fleet.server, sizes, mec_comm=True,
                    edge_chunks=2)
    assert PlanRequest(fleet.edge, fleet.server, sizes,
                       edge_chunks=2).edge_chunks == 2
    with pytest.raises(ValueError, match="edge_chunks"):
        PlanRequest(fleet.edge, fleet.server, sizes, edge_chunks=0)
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="srv_weight"):
            PlanRequest(fleet.edge, fleet.server, sizes, srv_weight=bad)
    priced = TSCFL(key=0, rounds=600)
    assert priced.noise_multiplier == 0.5 and priced.rounds == 600
    with pytest.raises(ValueError, match="rounds"):
        TSCFL(key=0, epsilon_target=2.0)
    budgeted = TSCFL(key=0, epsilon_target=2.0, rounds=600, device="cpu")
    assert budgeted.noise_multiplier > 0.5 and budgeted.delta == 1e-5
    for kw in ({"sample_frac": 0.0}, {"sample_frac": 1.2},
               {"noise_multiplier": -1.0}):
        with pytest.raises(ValueError):
            TSCFL(key=0, **kw)
    assert TSCFL(key=0).noise_multiplier == 0.5
