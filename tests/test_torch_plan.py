"""Parity of the port's grid planner (`repro_torch.plan.solver`) with the
reference's scalar oracle `repro.plan.reference`, run on the CPU.

Bounds are the reference's own (`tests/test_plan_solver.py`): loads and c
exactly, t*, p_return and expected_agg within rtol 1e-3 (p_return also
atol 1e-6) — the oracle bisects to eps_rel and the grid refines to
eps_rel, so t* agrees to that resolution.  The oracle is the float64
seed stack; the JAX batched solver is not called (it needs the scoped
x64 API this JAX no longer has).
"""
import numpy as np
import pytest

from repro.core.delay_model import DeviceDelayParams as JParams
from repro.core.redundancy import _fleet_with_server
from repro.plan.reference import (optimal_loads_loop,
                                  solve_redundancy_reference)
from repro.sim.network import paper_fleet as j_paper_fleet
from repro_torch.core.delay_model import DeviceDelayParams as TParams
from repro_torch.core.delay_model import total_cdf
from repro_torch.core.redundancy import solve_redundancy
from repro_torch.plan import PlanRequest, solve_redundancy_batched
from repro_torch.sim.network import paper_fleet

# The §IV plan (N=24, ell=300, fixed_c = 0.28 m = 2016).  The reference's
# main path (its batched grid solver) and the oracle at eps_rel=1e-4 both
# stop at t* = 11.96324 s, where device 3's best load is 123; the oracle's
# default eps_rel=1e-3 bisection stops 9e-4 s later, at 11.96410 s, where
# it is 124.
SEC4_T_STAR = 11.9641
SEC4_LOADS = [300, 300, 186, 123, 300, 300, 127, 300, 0, 0, 0, 300, 300,
              300, 300, 288, 300, 300, 300, 0, 300, 300, 300, 300]


def _random_fleet(mod, rng: np.random.Generator, n: int):
    """The randomized fleets of tests/test_plan_solver.py."""
    a = rng.uniform(1e-3, 5e-2, n)
    mu = (2.0 / a) * rng.uniform(0.5, 2.0, n)
    tau = rng.uniform(1e-3, 5e-2, n)
    p = rng.uniform(0.0, 0.3, n)
    sa = np.array([a.min() / 10.0])
    return (mod(a, mu, tau, p),
            mod(sa, 2.0 / sa, np.zeros(1), np.zeros(1)))


def _problem(n, ell, mode, seed):
    rng = np.random.default_rng(seed)
    state = rng.bit_generator.state
    j_edge, j_server = _random_fleet(JParams, rng, n)
    sizes = rng.integers(ell // 2 + 1, ell + 1, size=n)
    m = int(sizes.sum())
    # parity budget >= 10% of m: away from the saturation asymptote
    kw = {"fixed_c": int(rng.integers(m // 10 + 1, m + 1))} \
        if mode == "fixed" else \
        {"c_up": int(rng.integers(m // 10 + 1, m + 1))}
    rng.bit_generator.state = state
    t_edge, t_server = _random_fleet(TParams, rng, n)
    return (j_edge, j_server), (t_edge, t_server), sizes, kw


@pytest.mark.parametrize("mode", ["free", "fixed"])
@pytest.mark.parametrize("n,ell,seed", [(2, 8, 0), (3, 25, 17), (5, 40, 123),
                                        (8, 60, 4242), (6, 13, 99991)])
def test_solver_matches_reference_oracle(n, ell, mode, seed):
    (je, js), (te, ts), sizes, kw = _problem(n, ell, mode, seed)
    ref = solve_redundancy_reference(je, js, sizes, eps_rel=1e-4, **kw)
    got = solve_redundancy_batched([PlanRequest(te, ts, sizes, **kw)],
                                   eps_rel=1e-4, device="cpu")[0]
    np.testing.assert_array_equal(got.loads, ref.loads)
    assert got.c == ref.c
    np.testing.assert_allclose(got.t_star, ref.t_star, rtol=1e-3)
    np.testing.assert_allclose(got.p_return, ref.p_return, rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(got.expected_agg, ref.expected_agg, rtol=1e-3)
    assert got.loads_cap_total == ref.loads_cap_total == int(sizes.sum())


def test_section4_plan():
    """The §IV point: c = 2016, t* within rtol 1e-3 of 11.9641, the main
    path's loads; at eps_rel=1e-4 loads and c equal the oracle's, and at
    the default eps_rel the loads are the oracle's own argmax at the
    port's t* (load extraction is exact, whatever t* it lands on)."""
    jf, tf = j_paper_fleet(0.2, 0.2, seed=0), paper_fleet(0.2, 0.2, seed=0)
    sizes = np.full(24, 300)
    plan = solve_redundancy(tf.edge, tf.server, sizes, fixed_c=2016,
                            device="cpu")
    assert plan.c == 2016
    np.testing.assert_allclose(plan.t_star, SEC4_T_STAR, rtol=1e-3)
    assert plan.loads.tolist() == SEC4_LOADS
    caps = np.concatenate([sizes, [2016]])
    oracle_loads, _ = optimal_loads_loop(
        _fleet_with_server(jf.edge, jf.server), caps, plan.t_star)
    np.testing.assert_array_equal(oracle_loads[:-1], plan.loads)

    ref = solve_redundancy_reference(jf.edge, jf.server, sizes,
                                     fixed_c=2016, eps_rel=1e-4)
    tight = solve_redundancy(tf.edge, tf.server, sizes, fixed_c=2016,
                             eps_rel=1e-4, device="cpu")
    np.testing.assert_array_equal(tight.loads, ref.loads)
    assert tight.c == ref.c == 2016
    np.testing.assert_allclose(tight.t_star, ref.t_star, rtol=1e-3)


def test_batched_matches_single_calls():
    """One batched call over heterogeneous requests == per-request solves
    (per-row series truncation keeps every plan independent of its
    batch)."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(4):
        edge, server = _random_fleet(TParams, rng, 6)
        sizes = np.full(6, 40 + 4 * i)
        kw = {"fixed_c": 30 + 10 * i} if i % 2 else {"c_up": 60 + 10 * i}
        reqs.append(PlanRequest(edge, server, sizes, **kw))
    batch = solve_redundancy_batched(reqs, device="cpu")
    for req, got in zip(reqs, batch):
        one = solve_redundancy_batched([req], device="cpu")[0]
        assert got.t_star == one.t_star and got.c == one.c
        np.testing.assert_array_equal(got.loads, one.loads)
        np.testing.assert_array_equal(got.p_return, one.p_return)


def test_p_return_is_host_total_cdf():
    """p_return is re-evaluated on the host: bit-equal to total_cdf at
    (loads, t*), since the Eq.-17 weights amplify any last-ulp drift."""
    edge, server = _random_fleet(TParams, np.random.default_rng(11), 6)
    plan = solve_redundancy_batched(
        [PlanRequest(edge, server, np.full(6, 40), c_up=100)],
        device="cpu")[0]
    np.testing.assert_array_equal(
        plan.p_return[:-1], total_cdf(edge, plan.loads, plan.t_star))


def test_infeasible_request_raises():
    edge = TParams(a=np.full(2, 1e12), mu=np.full(2, 1e-12), tau=np.ones(2),
                   p=np.full(2, 0.99))
    server = TParams(a=np.array([1e12]), mu=np.array([1e-12]),
                     tau=np.zeros(1), p=np.zeros(1))
    with pytest.raises(RuntimeError, match="request 0"):
        solve_redundancy_batched(
            [PlanRequest(edge, server, np.full(2, 10), c_up=5, t_hi=1.0)],
            device="cpu")


@pytest.mark.parametrize("kw", [{"edge_chunks": 2, "srv_weight": 0.5},
                                {"edge_chunks": 2}, {"mec_comm": True}])
def test_scheme_objectives_not_ported_yet(kw):
    """Every scheme objective is ported now: mec_comm (CodedFedL) is
    accepted and plans, with edge_chunks = 2 still a ValueError; the
    partial-return objective edge_chunks, with or without srv_weight, and
    the MEC objective each match their oracle of
    `repro.plan.reference_schemes` (the partial-return or MEC edge
    objective, the weighted server) at eps_rel 1e-4: loads and c equal,
    t* within rtol 1e-3.  The name is the one this test had while these
    objectives were refused; it is kept so that the test's record stays
    traceable."""
    from repro.plan.reference_schemes import (_solve_two_part,
                                              optimal_loads_mec_loop,
                                              optimal_loads_partial_loop)
    (je, js), (te, ts), sizes, fixed = _problem(3, 25, "fixed", 17)
    if kw.get("mec_comm"):
        assert PlanRequest(te, ts, sizes, **kw).mec_comm
        with pytest.raises(ValueError, match="mec_comm"):
            PlanRequest(te, ts, sizes, mec_comm=True, edge_chunks=2)
        edge_loads = lambda caps, t: optimal_loads_mec_loop(  # noqa: E731
            je, caps, t)
    else:
        edge_loads = lambda caps, t: optimal_loads_partial_loop(  # noqa
            je, caps, t, kw["edge_chunks"])
    got = solve_redundancy_batched([PlanRequest(te, ts, sizes, **kw,
                                                **fixed)],
                                   eps_rel=1e-4, device="cpu")[0]
    ref = _solve_two_part(je, js, sizes, edge_loads,
                          kw.get("srv_weight", 1.0), None, fixed["fixed_c"],
                          1e-4, None)
    np.testing.assert_array_equal(got.loads, ref.loads)
    assert got.c == ref.c
    np.testing.assert_allclose(got.t_star, ref.t_star, rtol=1e-3)


def test_plan_request_validates_server():
    edge, server = _random_fleet(TParams, np.random.default_rng(0), 3)
    with pytest.raises(ValueError):  # two servers
        PlanRequest(edge, edge, np.full(3, 10))
    comm_server = TParams(np.ones(1), np.ones(1), np.ones(1), np.zeros(1))
    with pytest.raises(ValueError):  # server with a communication leg
        PlanRequest(edge, comm_server, np.full(3, 10))
    with pytest.raises(ValueError):  # data_sizes shape mismatch
        PlanRequest(edge, server, np.full(4, 10))
