"""`LowLatencyCFL`, `core.delay_model.partial_cdf` and the partial-return
planner objective (`edge_chunks > 1`) of the port against the JAX
package, on the CPU.

The JAX planner and `LowLatencyCFL.plan` run under a scoped x64 this JAX
no longer has (ROADMAP "Reference state", R1), so the JAX strategy is
handed a `redundancy_plan=` from the NumPy oracle
`repro.plan.reference_schemes.solve_lowlatency_reference`; its encoded
parity crosses into the port with `repro_torch.interop`.  The JAX side
trains epoch by epoch through `jax.jit(repro.api.make_epoch_step(...))`.

Bounds:
  * `partial_cdf`, `row_chunks`, the chunk probabilities and chunk ids of
    the plan, the epoch schedules: bit-equal (NumPy copies, the same
    generator draws); `partial_cdf` at chunks = 1 equal to `total_cdf`;
  * the planner and `solve_fleet` at edge_chunks > 1 against the oracle
    at eps_rel 1e-4: loads and c equal, t* within rtol 1e-3 (the
    reference's own bound, `tests/test_schemes.py`);
  * training, flat and under `HierarchicalCFL`, on both gradient paths:
    times identical, NMSE within rtol 1e-4 over 30 epochs (the bound of
    `tests/test_torch_slice.py`);
  * chunks = 1 against `CodedFL` inside the port: the same plan and
    parity (`torch.equal`), the same arrival stream, NMSE within rtol
    1e-5 (`tests/test_schemes.py`'s bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro import fleet as j_fleet
from repro.core.delay_model import DeviceDelayParams as JParams
from repro.core.delay_model import partial_cdf as j_partial_cdf
from repro.plan.reference_schemes import solve_lowlatency_reference
from repro.schemes import LowLatencyCFL as JLowLat
from repro.schemes.lowlatency import row_chunks as j_row_chunks
from repro_torch import api as t_api
from repro_torch import interop
from repro_torch.core import encoding
from repro_torch.core.delay_model import DeviceDelayParams as TParams
from repro_torch.core.delay_model import partial_cdf, total_cdf
from repro_torch.fleet import (FleetTopology, HierarchicalCFL, HierState,
                               solve_fleet)
from repro_torch.plan import PlanRequest, solve_redundancy_batched
from repro_torch.schemes import LowLatencyCFL, row_chunks
from repro_torch.sim.network import wireless_fleet
from test_torch_plan import _problem
from test_torch_schemes import port_plan
from test_torch_slice import (ELL, EPOCHS, LR, _assert_same_run, _data,
                              _fleets, _jax_run)

# (n clients, fleet seed, fixed_c, chunks)
CASES = {"q4": (8, 3, 143, 4), "q8": (10, 5, 179, 8)}


def _edge(seed, n):
    (je, _), (te, _), _, _ = _problem(n, 40, "free", seed)
    return je, te


# ---------------------------------------------------------------------------
# the partial-return delay model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [2, 3, 17])
def test_partial_cdf_bit_equal(seed, chunks):
    je, te = _edge(seed, 6)
    ell = np.array([12, 25, 0, 30, 18, 9])
    for t in (0.0, 0.4, 1.1, 2.2, 50.0):
        np.testing.assert_array_equal(partial_cdf(te, ell, t, chunks),
                                      j_partial_cdf(je, ell, t, chunks))
    # a server-style fleet (no communication leg) takes the base branch
    server = TParams(te.a, te.mu, np.zeros(6), np.zeros(6))
    j_server = JParams(je.a, je.mu, np.zeros(6), np.zeros(6))
    np.testing.assert_array_equal(partial_cdf(server, ell, 1.1, chunks),
                                  j_partial_cdf(j_server, ell, 1.1, chunks))


@pytest.mark.parametrize("seed", [2, 3])
def test_partial_cdf_chunks_one_is_total_cdf(seed):
    _, te = _edge(seed, 6)
    ell = np.array([10, 20, 0, 15, 30, 7])
    for t in (0.3, 1.5, 9.0):
        np.testing.assert_array_equal(partial_cdf(te, ell, t, 1)[:, 0],
                                      total_cdf(te, ell, t))


@pytest.mark.parametrize("chunks", [1, 3, 8, 40])
def test_row_chunks_bit_equal(chunks):
    loads = np.array([0, 1, 7, 30, 29, 12])
    got, want = row_chunks(loads, 30, chunks), j_row_chunks(loads, 30,
                                                            chunks)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32


# ---------------------------------------------------------------------------
# the partial-return planner objective
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [2, 4, 8])
@pytest.mark.parametrize("mode", ["free", "fixed"])
@pytest.mark.parametrize("n,ell,seed", [(3, 25, 17), (5, 40, 123),
                                        (8, 60, 4242)])
def test_partial_planner_matches_oracle(n, ell, seed, mode, chunks):
    (je, js), (te, ts), sizes, kw = _problem(n, ell, mode, seed)
    ref = solve_lowlatency_reference(je, js, sizes, chunks, eps_rel=1e-4,
                                     **kw)
    got = solve_redundancy_batched(
        [PlanRequest(te, ts, sizes, edge_chunks=chunks, **kw)],
        eps_rel=1e-4, device="cpu")[0]
    np.testing.assert_array_equal(got.loads, ref.loads)
    assert got.c == ref.c
    np.testing.assert_allclose(got.t_star, ref.t_star, rtol=1e-3)


def test_mixed_objective_batch_matches_solo():
    """Base, weighted and partial requests in ONE call plan as they do
    alone (partial requests group apart by edge_chunks)."""
    (_, _), (te, ts), _, _ = _problem(6, 40, "free", 4)
    sizes = np.full(6, 40)
    reqs = [PlanRequest(te, ts, sizes, c_up=100),
            PlanRequest(te, ts, sizes, c_up=100, edge_chunks=4),
            PlanRequest(te, ts, sizes, fixed_c=60, srv_weight=0.8),
            PlanRequest(te, ts, sizes, fixed_c=60, edge_chunks=2)]
    batch = solve_redundancy_batched(reqs, device="cpu")
    for req, got in zip(reqs, batch):
        solo = solve_redundancy_batched([req], device="cpu")[0]
        assert got.t_star == solo.t_star and got.c == solo.c
        np.testing.assert_array_equal(got.loads, solo.loads)
    # partial uploads return part of a straggler's work: an earlier t*
    assert batch[1].t_star < batch[0].t_star


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("mode", ["free", "fixed"])
@pytest.mark.parametrize("n,ell,seed", [(5, 40, 123), (8, 60, 4242)])
def test_solve_fleet_partial_objective_matches_oracle(n, ell, seed, mode,
                                                      chunks):
    (je, js), (te, ts), sizes, kw = _problem(n, ell, mode, seed)
    ref = solve_lowlatency_reference(je, js, sizes, chunks, eps_rel=1e-4,
                                     **kw)
    req = PlanRequest(te, ts, sizes, edge_chunks=chunks, **kw)
    got = solve_fleet(req, eps_rel=1e-4, device="cpu")
    np.testing.assert_array_equal(got.loads, ref.loads)
    assert got.c == ref.c
    np.testing.assert_allclose(got.t_star, ref.t_star, rtol=1e-3)
    streamed = solve_fleet(req, eps_rel=1e-4, chunk=8, device="cpu")
    np.testing.assert_array_equal(streamed.loads, got.loads)


# ---------------------------------------------------------------------------
# the strategy against the reference
# ---------------------------------------------------------------------------

def ll_pair(case, grad_path="fused", chunks=None):
    """(jax strategy, jax state, port strategy, port state, jax fleet,
    port fleet, jax data, port data, seed) on the case's oracle plan."""
    n, seed, c, q = CASES[case]
    q = q if chunks is None else chunks
    jf, tf = _fleets(n, seed)
    xs, ys, beta = _data(n, seed)
    plan = solve_lowlatency_reference(jf.edge, jf.server, np.full(n, ELL),
                                      q, fixed_c=c)
    jdata = j_api.TrainData(jnp.asarray(xs), jnp.asarray(ys),
                            jnp.asarray(beta))
    j_s = JLowLat(key=jax.random.PRNGKey(seed), chunks=q, fixed_c=c,
                  redundancy_plan=plan, include_upload_delay=False,
                  grad_path=grad_path)
    jstate = j_s.plan_with(jf, jdata, plan)
    tplan = port_plan(plan)
    t_s = LowLatencyCFL(key=seed, chunks=q, fixed_c=c, redundancy_plan=tplan,
                        include_upload_delay=False, grad_path=grad_path)
    tstate = interop.lowlatency_state(
        tplan, np.asarray(jstate.load_mask), np.asarray(jstate.x_parity),
        np.asarray(jstate.y_parity), tf.edge, tf.server, jstate.chunk_probs,
        jstate.row_chunk, device="cpu")
    tdata = interop.train_data(xs, ys, beta, device="cpu")
    return j_s, jstate, t_s, tstate, jf, tf, jdata, tdata, seed


@pytest.mark.parametrize("chunks", [1, 4, 8])
def test_lowlatency_plan_weights_bit_equal(chunks):
    """The port's own plan_with on the oracle plan: chunk probabilities,
    chunk ids and load mask bit-equal to the reference's state, and the
    parity exactly the encode of the per-chunk Eq.-17 weights written
    out from the reference's expression."""
    j_s, jstate, _, _, jf, tf, jdata, tdata, seed = ll_pair("q8",
                                                            chunks=chunks)
    t_s = LowLatencyCFL(key=seed, chunks=chunks, fixed_c=j_s.fixed_c,
                        include_upload_delay=False)
    tstate = t_s.plan_with(tf, tdata, port_plan(jstate.plan))
    np.testing.assert_array_equal(tstate.chunk_probs, jstate.chunk_probs)
    np.testing.assert_array_equal(tstate.row_chunk, jstate.row_chunk)
    np.testing.assert_array_equal(tstate.load_mask.numpy(),
                                  np.asarray(jstate.load_mask))
    n = tdata.n
    probs_ext = np.concatenate([jstate.chunk_probs, np.zeros((n, 1))], 1)
    w = np.sqrt(np.maximum(0.0, 1.0 - np.take_along_axis(
        probs_ext, jstate.row_chunk, axis=1)))
    x_par, y_par = encoding.encode_fleet(
        torch.Generator().manual_seed(seed), tdata.xs, tdata.ys,
        torch.tensor(w).to(torch.float32), j_s.fixed_c)
    assert torch.equal(tstate.x_parity, x_par)
    assert torch.equal(tstate.y_parity, y_par)
    assert t_s.report_extras(tstate) == j_s.report_extras(jstate)


@pytest.mark.parametrize("chunks", [1, 4, 8])
def test_lowlatency_schedules_bit_equal(chunks):
    j_s, jstate, t_s, tstate, jf, tf, _, _, seed = ll_pair("q4",
                                                           chunks=chunks)
    want = j_s.sample_epochs(jstate, jf, 40, np.random.default_rng(seed))
    got = t_s.sample_epochs(tstate, tf, 40, np.random.default_rng(seed))
    assert sorted(got.arrivals) == sorted(want.arrivals)
    for k in want.arrivals:
        np.testing.assert_array_equal(got.arrivals[k], want.arrivals[k])
        assert got.arrivals[k].dtype == want.arrivals[k].dtype
    np.testing.assert_array_equal(got.durations, want.durations)
    assert (got.setup_time, got.t0) == (want.setup_time, want.t0)


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lowlatency_matches_reference(case, grad_path):
    j_s, jstate, t_s, tstate, jf, tf, jdata, tdata, seed = ll_pair(
        case, grad_path)
    want = _jax_run(j_s, jstate, jdata, jf, seed)
    got = t_api.Session(t_s, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=tstate)
    if grad_path == "fused":
        layout = t_s.device_state(tstate, tdata)
        j_layout = j_s.device_state(jstate, jdata)
        assert ("sys_x" in layout) == ("sys_x" in j_layout)
        np.testing.assert_array_equal(layout["sys_chunk"].numpy(),
                                      np.asarray(j_layout["sys_chunk"]))
    _assert_same_run(got, want)
    assert got.extras == j_s.report_extras(jstate)
    assert got.uplink_bits_total == j_s.uplink_bits(jstate, jf, EPOCHS)


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
@pytest.mark.parametrize("frac", [1.0, 0.6])
def test_lowlatency_hierarchical_matches_reference(frac, grad_path):
    j_b, jbs, t_b, tbs, jf, tf, jdata, tdata, seed = ll_pair("q8",
                                                             grad_path)
    j_topo = j_fleet.FleetTopology.uniform(tdata.n, 3, sample_frac=frac)
    t_topo = FleetTopology.uniform(tdata.n, 3, sample_frac=frac)
    j_h = j_fleet.HierarchicalCFL(j_b, j_topo)
    jstate = j_fleet.HierState(base=jbs, topology=j_topo)
    want = _jax_run(j_h, jstate, jdata, jf, seed)
    got = t_api.Session(HierarchicalCFL(t_b, t_topo), tf, LR, EPOCHS,
                        device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=HierState(tbs, t_topo))
    _assert_same_run(got, want)
    assert got.extras == j_h.report_extras(jstate)


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
def test_lowlatency_single_tier_is_bit_equal_to_flat(grad_path):
    _, _, t_s, tstate, _, tf, _, tdata, seed = ll_pair("q8", grad_path)
    topo = FleetTopology.uniform(tdata.n, 1)
    flat = t_api.Session(t_s, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=tstate)
    hier = t_api.Session(HierarchicalCFL(t_s, topo), tf, LR, EPOCHS,
                         device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=HierState(tstate, topo))
    np.testing.assert_array_equal(hier.nmse, flat.nmse)
    np.testing.assert_array_equal(hier.times, flat.times)


# ---------------------------------------------------------------------------
# the port's own path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    fleet = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=12, d=40)
    data = t_api.TrainData.linreg(0, n=12, ell=60, d=40, device="cpu")
    return fleet, data


def test_chunks_one_is_codedfl(small):
    """chunks = 1 (all-or-nothing) against CodedFL with the same key and
    c, each planned by the port: the same plan and parity, the same
    clocks, the fused layouts without cross-talk, NMSE within rtol
    1e-5."""
    fleet, data = small
    c = int(0.3 * data.m)
    cfl = t_api.make_strategy("cfl", key_seed=5, fixed_c=c, use_kernel=True)
    ll = t_api.make_strategy("lowlatency", key_seed=5, fixed_c=c, chunks=1)
    st_c, st_l = cfl.plan(fleet, data), ll.plan(fleet, data)
    assert st_c.plan.t_star == st_l.plan.t_star
    np.testing.assert_array_equal(st_c.plan.loads, st_l.plan.loads)
    assert torch.equal(st_c.x_parity, st_l.x_parity)
    assert torch.equal(st_c.y_parity, st_l.y_parity)
    s_c = cfl.sample_epochs(st_c, fleet, 50, np.random.default_rng(3))
    s_l = ll.sample_epochs(st_l, fleet, 50, np.random.default_rng(3))
    np.testing.assert_array_equal(s_l.arrivals["chunks_done"],
                                  s_c.arrivals["received"])
    np.testing.assert_array_equal(s_l.arrivals["parity_ok"],
                                  s_c.arrivals["parity_ok"])
    dev_l = ll.device_state(st_l, data)
    assert "sys_chunk" not in cfl.device_state(st_c, data)
    assert "sys_chunk" in dev_l
    r_c = t_api.Session(cfl, fleet, 0.05, 80, device="cpu").run(
        data, rng=np.random.default_rng(3), state=st_c)
    r_l = t_api.Session(ll, fleet, 0.05, 80, device="cpu").run(
        data, rng=np.random.default_rng(3), state=st_l)
    np.testing.assert_allclose(r_l.nmse, r_c.nmse, rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(r_l.times, r_c.times)
    assert r_l.setup_time == r_c.setup_time


def test_partial_rows_track_chunks(small):
    """Exactly the rows of completed chunks contribute; punctured rows
    never do."""
    fleet, data = small
    strat = LowLatencyCFL(key=2, fixed_c=100, chunks=4)
    state = strat.plan(fleet, data)
    dev = strat.device_state(state, data)
    beta = torch.randn(data.d, generator=torch.Generator().manual_seed(0))
    done = torch.zeros(data.n)
    done[0] = 2.0  # client 0 finished 2 of 4 chunks
    g = strat.round_contributions(state, dev, beta,
                                  {"chunks_done": done,
                                   "parity_ok": torch.tensor(0.0)})
    rows = np.flatnonzero(state.row_chunk[0] < 2)
    x0, y0 = data.xs[0][rows], data.ys[0][rows]
    np.testing.assert_allclose(g.numpy(), ((x0 @ beta - y0) @ x0).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_port_plans_and_trains_on_its_own(small):
    """The port's own partial-return planner, per-chunk encode and both
    gradient paths, end to end."""
    fleet, data = small
    reports = {}
    for grad_path in ("fused", "reference"):
        strat = LowLatencyCFL(key=1, fixed_c=int(0.28 * data.m), chunks=8,
                              include_upload_delay=False,
                              grad_path=grad_path)
        sess = t_api.Session(strat, fleet, 0.05, EPOCHS, device="cpu")
        state = sess.plan(data)
        assert np.all(state.plan.loads <= data.ell)
        assert state.plan.expected_agg >= data.m * (1.0 - 1e-9)
        reports[grad_path] = sess.run(data, rng=np.random.default_rng(0),
                                      state=state)
    fused, ref = reports["fused"], reports["reference"]
    assert fused.nmse[-1] < fused.nmse[0]
    np.testing.assert_array_equal(fused.times, ref.times)
    np.testing.assert_allclose(fused.nmse, ref.nmse, rtol=1e-4)
    assert 0.0 < fused.extras["mean_chunk_prob"] < 1.0
    with pytest.raises(ValueError, match="chunks"):
        LowLatencyCFL(key=0, chunks=0)
