"""The port's sweep engine (`repro_torch.api.plan_sweep` / `run_sweep`, the
engine cache and the bucket keys), on the CPU.

Inside the port every comparison is exact (`np.array_equal`): a sweep
lane runs the launches of the same session's solo `Session.run` on the
same tensors, so traces, clocks and extras are bit-equal, and a batched
plan is bit-equal to the strategy's own one-request plan.

Against the JAX package (whose `run_sweep` fails on this JAX, ROADMAP.md
R2) each lane of a port sweep over the reference's plans and parity is
held to `jax.jit(repro.api.make_epoch_step(...))` driven epoch by epoch:
NMSE within rtol 1e-4 (float32 gradients summed in another order over
20 epochs; tests/test_torch_slice.py states the same bound), times and
durations bit-equal (the same host NumPy schedule).  The lane-to-bucket
partition is held to the one the JAX `_bucket_key` gives on the same
sessions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.api.session import _bucket_key as j_bucket_key
from repro.core import aggregation as j_agg
from repro.plan.reference import solve_redundancy_reference
from repro.plan.reference_schemes import solve_stochastic_reference
from repro.sim.network import make_fleet as j_make_fleet
from repro_torch import api as t_api
from repro_torch import interop
from repro_torch.api import (Session, TrainData, make_strategy, plan_sweep,
                             run_sweep)
from repro_torch.api import session as t_session
from repro_torch.api.session import (_ENGINE_CACHE, _bucket_key,
                                     _static_strategy_key)
from repro_torch.core import aggregation, cfl
from repro_torch.fleet import FleetTopology, HierState
from repro_torch.sim.network import paper_fleet, wireless_fleet

EPOCHS = 20
LR = 0.3
N, ELL, D = 10, 64, 16
D_FEAT = 16
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread, restored after the
    module, keeps the file cheap when the suite runs beside others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small():
    fleet = paper_fleet(0.2, 0.2, seed=1, n=N, d=D)
    wfleet = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=N, d=D)
    data = TrainData.linreg(0, N, ELL, D, device=CPU)
    return fleet, wfleet, data


@pytest.fixture(scope="module")
def feature_data(small):
    """CodedFedL's problem: the linreg inputs and labels, with the
    least-squares head over the shared feature map as the reference."""
    _, _, data = small
    probe = make_strategy("codedfedl", key_seed=0, d_feat=D_FEAT, rff_key=5)
    phi = probe.features(data).reshape(-1, D_FEAT).double().numpy()
    head, *_ = np.linalg.lstsq(phi, data.ys.reshape(-1).double().numpy(),
                               rcond=None)
    return TrainData(data.xs, data.ys,
                     torch.tensor(head, dtype=torch.float32))


def _sessions_for(name, small, feature_data, epochs=EPOCHS):
    """A small sweep per strategy, lanes differing in value-only knobs."""
    fleet, wfleet, data = small
    c = int(0.3 * data.m)
    if name == "uncoded":
        return [Session(make_strategy("uncoded"), fleet, lr, epochs,
                        device=CPU) for lr in (0.3, 0.2)]
    if name == "cfl":
        return [Session(make_strategy("cfl", key_seed=seed, fixed_c=c),
                        fleet, LR, epochs, device=CPU)
                for seed in (7, 8, 9)]
    if name == "gradcode":
        return [Session(make_strategy("gradcode", r=2), fleet, lr, epochs,
                        device=CPU) for lr in (0.3, 0.25)]
    if name == "stochastic":
        return [Session(make_strategy(
            "stochastic", key_seed=7, fixed_c=c, noise_multiplier=sigma,
            sample_frac=0.8, rounds=epochs, device=CPU),
            wfleet, LR, epochs, device=CPU) for sigma in (0.0, 0.5, 1.0)]
    if name == "lowlatency":
        return [Session(make_strategy(
            "lowlatency", key_seed=seed, fixed_c=c, chunks=4),
            wfleet, LR, epochs, device=CPU) for seed in (7, 11)]
    if name == "codedfedl":
        return [Session(make_strategy(
            "codedfedl", key_seed=seed, d_feat=D_FEAT, rff_key=5,
            fixed_c=c), wfleet, 0.5, epochs, device=CPU)
            for seed in (7, 8)]
    if name == "hier":
        topo = FleetTopology.uniform(N, 2)
        return [Session(make_strategy(
            "hierarchical", base=make_strategy("cfl", key_seed=seed,
                                               fixed_c=c),
            topology=topo), fleet, LR, epochs, device=CPU)
            for seed in (7, 8)]
    raise ValueError(name)


def _data_for(name, small, feature_data):
    return feature_data if name == "codedfedl" else small[2]


def _assert_lane_equals_solo(reports, sessions, data, states):
    """Bit-for-bit: traces, clocks and extras equal fresh solo runs over
    the same states (`test_plan_sweep_plans_bit_equal_solo` holds the
    batched plans to the solo ones)."""
    for sess, rep, state in zip(sessions, reports, states):
        solo = sess.run(data, rng=np.random.default_rng(sess.seed),
                        state=state)
        np.testing.assert_array_equal(rep.nmse, solo.nmse)
        np.testing.assert_array_equal(rep.beta, solo.beta)
        np.testing.assert_array_equal(rep.times, solo.times)
        np.testing.assert_array_equal(rep.epoch_durations,
                                      solo.epoch_durations)
        assert rep.label == solo.label
        assert rep.setup_time == solo.setup_time
        assert rep.uplink_bits_total == solo.uplink_bits_total
        assert set(rep.extras) == set(solo.extras)
        for k, v in rep.extras.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(solo.extras[k]))


STRATEGIES = ["uncoded", "cfl", "gradcode", "stochastic", "lowlatency",
              "codedfedl", "hier"]


@pytest.mark.parametrize("name", STRATEGIES)
def test_sweep_lanes_bit_equal_solo(small, feature_data, name):
    """Each sweep lane's NMSE trace, clock and extras are bit-equal to a
    solo `Session.run` with the same per-lane generator, and the lanes
    of one strategy's sweep share one bucket."""
    data = _data_for(name, small, feature_data)
    sessions = _sessions_for(name, small, feature_data)
    states = plan_sweep(sessions, data)
    reports = run_sweep(sessions, data, states=states)
    assert all(np.all(np.isfinite(r.nmse)) for r in reports)
    assert reports[0].nmse[-1] < reports[0].nmse[0]
    _assert_lane_equals_solo(reports, sessions, data, states)
    assert len({k for s in sessions for k in s._engines}) == 1


def test_one_bucket_over_differing_plans(small):
    """A bucket's engine closes over its FIRST lane's state; lanes whose
    plans differ (fleets, keys, parity budgets of one layout, the SCFL
    noise and so its srv_weight and plan) still equal their solo runs."""
    _, wfleet, data = small
    sessions = [Session(make_strategy("cfl", key_seed=k, fixed_c=c),
                        paper_fleet(nu, nu, seed=0, n=N, d=D), LR, EPOCHS,
                        seed=k, device=CPU)
                for k, c, nu in ((1, 192, 0.25), (2, 200, 0.3),
                                 (3, 210, 0.35))]
    sessions += [Session(make_strategy("stochastic", key_seed=k,
                                       noise_multiplier=sigma, fixed_c=192,
                                       device=CPU),
                         wfleet, LR, EPOCHS, seed=k, device=CPU)
                 for k, sigma in ((4, 0.3), (5, 0.2))]
    states = plan_sweep(sessions, data)
    reports = run_sweep(sessions, data, states=states)
    buckets = {}
    for sess, state in zip(sessions, states):
        (key,) = sess._engines
        buckets.setdefault(key, []).append(state.plan)
    shared = [plans for plans in buckets.values() if len(plans) > 1]
    assert len(shared) == 2
    for plans in shared:
        assert len({(p.t_star, tuple(p.loads), p.c) for p in plans}) == \
            len(plans)
    _assert_lane_equals_solo(reports, sessions, data, states)


def test_stochastic_sweep_preserves_privacy_extras(small, feature_data):
    """Per-lane extras survive the sweep, the DP accounting fields too."""
    _, _, data = small
    reports = run_sweep(_sessions_for("stochastic", small, feature_data),
                        data)
    eps = [rep.extras["epsilon_spent"] for rep in reports]
    assert eps[0] == np.inf  # sigma = 0 lane: unbounded budget
    assert np.isfinite(eps[1]) and np.isfinite(eps[2])
    assert eps[1] > eps[2]  # more noise, less epsilon spent
    for rep in reports:
        assert rep.extras["epsilon_schedule"].shape == (EPOCHS,)
        assert rep.privacy_budget() is not None


def test_mixed_bucket_sweep(small):
    """One run_sweep over five strategy classes and two parity budgets
    splits lanes by static structure and shapes and still reproduces
    every solo trace bit for bit."""
    fleet, wfleet, data = small
    c1, c2 = int(0.2 * data.m), int(0.4 * data.m)
    sessions = [
        Session(make_strategy("uncoded"), fleet, LR, EPOCHS, device=CPU),
        Session(make_strategy("cfl", key_seed=7, fixed_c=c1), fleet, LR,
                EPOCHS, device=CPU),
        Session(make_strategy("cfl", key_seed=7, fixed_c=c2), fleet, LR,
                EPOCHS, device=CPU),
        Session(make_strategy("gradcode", r=2), fleet, LR, EPOCHS,
                device=CPU),
        Session(make_strategy("stochastic", key_seed=7, fixed_c=c1,
                              noise_multiplier=0.5, device=CPU),
                wfleet, LR, EPOCHS, device=CPU),
        Session(make_strategy("lowlatency", key_seed=7, fixed_c=c1,
                              chunks=4), wfleet, LR, EPOCHS, device=CPU),
    ]
    reports = run_sweep(sessions, data)  # plans through plan_sweep
    assert len(reports) == len(sessions)
    assert len({k for s in sessions for k in s._engines}) >= 5
    _assert_lane_equals_solo(reports, sessions, data,
                             plan_sweep(sessions, data))


def test_value_only_knobs_share_one_engine(small, feature_data):
    """Lanes differing only in declared value-only knobs (lr, the key
    seed, the noise level) form ONE bucket: at most one new engine."""
    _, _, data = small
    sessions = _sessions_for("stochastic", small, feature_data)
    states = plan_sweep(sessions, data)
    before = len(_ENGINE_CACHE)
    run_sweep(sessions, data, states=states)
    assert len(_ENGINE_CACHE) - before <= 1


def test_run_sweep_validates_lengths(small):
    fleet, _, data = small
    sessions = [Session(make_strategy("uncoded"), fleet, LR, 5, device=CPU)]
    with pytest.raises(ValueError, match="states"):
        run_sweep(sessions, data, states=[])
    with pytest.raises(ValueError, match="generators"):
        run_sweep(sessions, data, rngs=[])


@dataclasses.dataclass(frozen=True)
class _ScaledUncoded:
    """A static field (`scale`) steers the epoch program, but `engine_key`
    FORGETS it — the failure mode of sessions cloned with
    `dataclasses.replace`."""

    scale: float = 1.0
    label: str = "scaled"

    def plan(self, fleet, data):
        return {"n": data.n}

    def sample_epochs(self, state, fleet, epochs, rng):
        return t_api.EpochSchedule(
            durations=np.ones(epochs),
            arrivals={"epoch": np.zeros(epochs, np.float32)})

    def device_state(self, state, data):
        return {"x": data.xs.reshape(data.m, data.d),
                "y": data.ys.reshape(data.m)}

    def round_contributions(self, state, dev, beta, arrivals):
        resid = dev["x"] @ beta - dev["y"]
        return self.scale * (resid @ dev["x"])

    def uplink_bits(self, state, fleet, epochs):
        return 0.0

    def engine_key(self, state):
        return ()  # deliberately incomplete


def test_replaced_static_field_never_shares_engine(small):
    """Sessions made by `dataclasses.replace` with different static
    strategy fields build DIFFERENT engines, even when the strategy's own
    `engine_key` under-reports."""
    fleet, _, data = small
    s1 = Session(_ScaledUncoded(scale=1.0), fleet, 0.05, 10, device=CPU)
    rep1 = s1.run(data)
    s2 = dataclasses.replace(
        s1, strategy=dataclasses.replace(s1.strategy, scale=0.25))
    rep2 = s2.run(data)
    assert not np.array_equal(rep1.nmse, rep2.nmse)
    assert set(s1._engines) != set(s2._engines)
    g = [s.strategy.round_contributions(
        None, s.strategy.device_state(None, data), torch.zeros(D), {})
        for s in (s1, s2)]
    torch.testing.assert_close(0.25 * g[0], g[1], rtol=1e-6, atol=0.0)


def test_static_key_excludes_label_and_value_fields():
    """`label` and the declared `engine_value_fields` (the int key seeds
    among them) never split buckets; program-steering fields do."""
    a = make_strategy("stochastic", key_seed=7, noise_multiplier=0.2,
                      label="lane_a", device=CPU)
    b = make_strategy("stochastic", key_seed=9, noise_multiplier=0.9,
                      label="lane_b", device=CPU)
    assert _static_strategy_key(a) == _static_strategy_key(b)
    c = dataclasses.replace(a, sample_frac=0.5)  # 1/(c*rho) changes
    assert _static_strategy_key(a) != _static_strategy_key(c)
    for name, kw in (("cfl", {}), ("lowlatency", {}),
                     ("codedfedl", {"d_feat": 8})):
        x = make_strategy(name, key_seed=1, **kw)
        y = dataclasses.replace(x, key=2, label="other")
        assert _static_strategy_key(x) == _static_strategy_key(y)
    assert _static_strategy_key(make_strategy("cfl", key_seed=1)) != \
        _static_strategy_key(make_strategy("cfl", key_seed=1,
                                           grad_path="reference"))


def test_shared_data_keys_are_one_tensor(small, feature_data, monkeypatch):
    """The data-only operands are ONE tensor across a call's lanes (no
    per-lane copy), and CodedFedL's features stay per lane."""
    seen = []
    real = t_session._run_lane

    def spy(step, dev, *args):
        seen.append(dev)
        return real(step, dev, *args)

    monkeypatch.setattr(t_session, "_run_lane", spy)
    fleet, _, data = small
    sessions = [Session(make_strategy("uncoded"), fleet, lr, 3, device=CPU)
                for lr in (0.3, 0.2, 0.1)]
    run_sweep(sessions, data)
    for key in ("x", "y"):
        assert len({id(dev[key]) for dev in seen}) == 1
        assert len({dev[key].data_ptr() for dev in seen}) == 1
    seen.clear()
    run_sweep(_sessions_for("codedfedl", small, feature_data, epochs=3),
              feature_data)
    layout_x = "x" if "x" in seen[0] else "sys_x"
    assert seen[0][layout_x] is not seen[1][layout_x]
    for key in ("y", "row_client"):
        if key in seen[0]:
            assert seen[0][key] is seen[1][key]


def test_plan_sweep_plans_bit_equal_solo(small):
    """One batched solve over strategies of every planning group (base,
    srv_weight, edge_chunks, mec_comm, the hierarchical wrapper's
    forwarded hook) gives each lane its own one-request plan bit for
    bit."""
    fleet, wfleet, data = small
    c = int(0.3 * data.m)
    sessions = [
        Session(make_strategy("cfl", key_seed=1, fixed_c=c),
                paper_fleet(nu, nu, seed=0, n=N, d=D), LR, 1, device=CPU)
        for nu in (0.0, 0.2, 0.375)]
    sessions += [
        Session(make_strategy("cfl", key_seed=1), fleet, LR, 1, device=CPU),
        Session(make_strategy("stochastic", key_seed=1, fixed_c=c,
                              noise_multiplier=0.5, sample_frac=0.8,
                              device=CPU), wfleet, LR, 1, device=CPU),
        Session(make_strategy("lowlatency", key_seed=1, fixed_c=c,
                              chunks=4), wfleet, LR, 1, device=CPU),
        Session(make_strategy("codedfedl", key_seed=1, d_feat=D_FEAT,
                              fixed_c=c), wfleet, LR, 1, device=CPU),
        Session(make_strategy("hierarchical",
                              base=make_strategy("cfl", key_seed=1),
                              topology=FleetTopology.uniform(N, 2)),
                fleet, LR, 1, device=CPU),
    ]
    states = plan_sweep(sessions, data)
    for sess, state in zip(sessions, states):
        solo = sess.plan(data)
        got = getattr(state, "base", state).plan
        want = getattr(solo, "base", solo).plan
        np.testing.assert_array_equal(got.loads, want.loads)
        assert got.c == want.c and got.t_star == want.t_star
        np.testing.assert_array_equal(got.p_return, want.p_return)
        assert got.expected_agg == want.expected_agg
        torch.testing.assert_close(getattr(state, "base", state).x_parity,
                                   getattr(solo, "base", solo).x_parity,
                                   rtol=0, atol=0)


def test_fused_layout_and_gram_factors_are_memoized(small):
    """`fused_coded_device_state` returns one memoized dict per (state,
    data, x, parity_rows), equal to a fresh build; `parity_gram_factors`
    is computed once and equals `aggregation.parity_gram`; LowLatencyCFL's
    chunk ids never leak into the memoized dict."""
    fleet, wfleet, data = small
    strat = make_strategy("lowlatency", key_seed=3, fixed_c=100, chunks=4)
    state = strat.plan(wfleet, data)
    dev = cfl.fused_coded_device_state(state, data)
    assert cfl.fused_coded_device_state(state, data) is dev
    gram, gramy = aggregation.parity_gram(state.x_parity, state.y_parity)
    assert torch.equal(dev["par_gram"], gram)
    assert torch.equal(dev["par_gramy"], gramy)
    assert cfl.parity_gram_factors(state)[0] is dev["par_gram"]
    ll_dev = strat.device_state(state, data)
    assert "sys_chunk" in ll_dev and "sys_chunk" not in dev
    rows = cfl.fused_coded_device_state(state, data, parity_rows=True)
    assert rows is not dev and "x_parity" in rows and "par_gram" not in rows
    other = TrainData(data.xs, data.ys, data.beta_true)
    fresh = cfl.fused_coded_device_state(state, other)
    assert fresh is not dev and set(fresh) == set(dev)
    for k in dev:
        assert torch.equal(fresh[k], dev[k]), k


def test_hierarchical_wrapper_mirrors_the_base_hooks():
    topo = FleetTopology.uniform(N, 2)
    coded = make_strategy("hierarchical",
                          base=make_strategy("cfl", key_seed=1),
                          topology=topo)
    plain = make_strategy("hierarchical", base=make_strategy("uncoded"),
                          topology=topo)
    assert hasattr(coded, "plan_request") and coded.redundancy_plan is None
    assert not hasattr(plain, "plan_request")
    assert not hasattr(plain, "redundancy_plan")
    assert plain.data_device_keys == {"x", "y", "hier_row_client"}
    other = make_strategy("hierarchical", base=make_strategy("uncoded"),
                          topology=FleetTopology.uniform(N, 5))
    assert plain.engine_key(HierState(None, topo)) != \
        other.engine_key(HierState(None, other.topology))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

J_N, J_SEED = 10, 5


@pytest.fixture(scope="module")
def pair():
    """Both packages' fleet, data, and the reference's plans at two
    parity budgets: c = 179 loads 498 rows (the packed layout, 512 rows),
    c = 40 loads 618 (the dense one)."""
    jf = j_make_fleet(J_N, D, 0.3, 0.3, np.random.default_rng(J_SEED))
    tf = interop.fleet_spec(
        interop.delay_params(jf.edge.a, jf.edge.mu, jf.edge.tau, jf.edge.p),
        interop.delay_params(jf.server.a, jf.server.mu, jf.server.tau,
                             jf.server.p),
        jf.mac_rates, jf.link_rates, jf.packet_bits, jf.d, jf.nu_comp,
        jf.nu_link)
    rng = np.random.default_rng(100 + J_SEED)
    xs = rng.standard_normal((J_N, ELL, D)).astype(np.float32)
    beta = rng.standard_normal(D).astype(np.float32)
    ys = (xs @ beta + rng.standard_normal((J_N, ELL))).astype(np.float32)
    jdata = j_api.TrainData(jnp.asarray(xs), jnp.asarray(ys),
                            jnp.asarray(beta))
    tdata = interop.train_data(xs, ys, beta, device=CPU)
    plans = {c: solve_redundancy_reference(jf.edge, jf.server,
                                           np.full(J_N, ELL), fixed_c=c)
             for c in (179, 40)}
    srv = solve_stochastic_reference(jf.edge, jf.server, np.full(J_N, ELL),
                                     srv_weight=0.8 / 1.25, fixed_c=179)
    return {"jf": jf, "tf": tf, "jdata": jdata, "tdata": tdata,
            "plans": plans, "srv": srv}


def _port_plan(plan):
    return interop.redundancy_plan(plan.loads, plan.c, plan.t_star,
                                   plan.p_return, plan.expected_agg,
                                   plan.loads_cap_total)


def _lanes(p):
    """(jax strategy, jax state, port strategy, port state, lr, seed) per
    lane: two uncoded learning rates, CFL at two keys on one plan and at
    a second budget, gradient coding, and SCFL at two noise levels."""
    jf, tf, jdata = p["jf"], p["tf"], p["jdata"]
    out = []
    for lr in (LR, 0.2):
        js, ts = j_api.UncodedFL(), t_api.UncodedFL()
        out.append((js, js.plan(jf, jdata), ts, ts.plan(tf, p["tdata"]),
                    lr, 1))
    for seed, c in ((1, 179), (2, 179), (1, 40)):
        plan = p["plans"][c]
        key = jax.random.PRNGKey(seed)
        js = j_api.CodedFL(key=key, fixed_c=c, redundancy_plan=plan,
                           include_upload_delay=False)
        jstate = js.plan_with(jf, jdata, plan)
        tplan = _port_plan(plan)
        ts = t_api.CodedFL(key=seed, fixed_c=c, redundancy_plan=tplan,
                           include_upload_delay=False)
        tstate = interop.cfl_state(
            tplan, np.asarray(jstate.weights), np.asarray(jstate.load_mask),
            np.asarray(jstate.x_parity), np.asarray(jstate.y_parity),
            tf.edge, tf.server, device=CPU)
        out.append((js, jstate, ts, tstate, LR, 10 + seed))
    js = j_api.GradientCodingFL(r=2)
    ts = t_api.GradientCodingFL(r=2)
    jstate = js.plan(jf, jdata)
    tstate = interop.gradcoding_state(
        2, jstate.plan.groups, jstate.n_groups, jstate.ell,
        jstate.share_bits, jstate.shard_time)
    out.append((js, jstate, ts, tstate, LR, 3))
    from repro.api import make_strategy as j_make
    for sigma in (0.5, 1.0):
        plan = p["srv"]
        js = j_make("stochastic", key_seed=4, fixed_c=179,
                    noise_multiplier=sigma, sample_frac=0.8,
                    redundancy_plan=plan)
        jstate = js.plan_with(jf, jdata, plan)
        ts = make_strategy("stochastic", key_seed=4, fixed_c=179,
                           noise_multiplier=sigma, sample_frac=0.8,
                           redundancy_plan=_port_plan(plan), device=CPU)
        tstate = interop.stochastic_state(
            _port_plan(plan), np.asarray(jstate.load_mask),
            np.asarray(jstate.x_parity), np.asarray(jstate.y_parity),
            tf.edge, tf.server, jstate.noise_scale_x, jstate.noise_scale_y,
            jstate.srv_weight, device=CPU)
        out.append((js, jstate, ts, tstate, LR, 20))
    return out


def _jax_run(strategy, state, data, fleet, lr, seed):
    """The reference's training program, one jitted epoch at a time."""
    sched = strategy.sample_epochs(state, fleet, EPOCHS,
                                   np.random.default_rng(seed))
    dev = strategy.device_state(state, data)
    step = jax.jit(j_api.make_epoch_step(strategy, state, data.m))
    beta = jnp.zeros(data.model_dim, jnp.float32)
    lr_j = jnp.asarray(lr, jnp.float32)
    trace = [float(j_agg.nmse(beta, data.beta_true))]
    for e in range(EPOCHS):
        arr_t = {k: jnp.asarray(v[e]) for k, v in sched.arrivals.items()}
        beta, err = step(beta, dev, lr_j, data.beta_true, arr_t)
        trace.append(float(err))
    times = sched.t0 + np.concatenate([[0.0], np.cumsum(sched.durations)])
    return times, np.asarray(sched.durations), np.asarray(trace)


def _partition(keys):
    groups = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    return sorted(groups.values())


def test_sweep_lanes_match_the_jax_epoch_step(pair):
    """A port sweep over the reference's plans and parity: every lane
    within rtol 1e-4 of the JAX epoch step, times and durations equal."""
    lanes = _lanes(pair)
    sessions = [Session(ts, pair["tf"], lr, EPOCHS, seed=seed, device=CPU)
                for _, _, ts, _, lr, seed in lanes]
    reports = run_sweep(sessions, pair["tdata"],
                        states=[lane[3] for lane in lanes])
    for (js, jstate, _, _, lr, seed), rep in zip(lanes, reports):
        times, durations, trace = _jax_run(js, jstate, pair["jdata"],
                                           pair["jf"], lr, seed)
        np.testing.assert_array_equal(rep.times, times)
        np.testing.assert_array_equal(rep.epoch_durations, durations)
        np.testing.assert_allclose(rep.nmse, trace, rtol=1e-4, atol=0.0)
        assert rep.nmse[-1] < rep.nmse[0]


def test_bucket_partition_equals_the_jax_one(pair):
    """The lane-to-bucket partition of the port's `_bucket_key` equals the
    one the JAX `_bucket_key` gives on the same sessions and plans: five
    buckets, the packed and dense layouts splitting the CFL lanes."""
    lanes = _lanes(pair)
    j_keys, t_keys = [], []
    for js, jstate, ts, tstate, _, seed in lanes:
        jsched = js.sample_epochs(jstate, pair["jf"], EPOCHS,
                                  np.random.default_rng(seed))
        jdev = js.device_state(jstate, pair["jdata"])
        j_keys.append(j_bucket_key(
            js, jstate, pair["jdata"], jdev,
            {k: np.asarray(v) for k, v in jsched.arrivals.items()}))
        tsched = ts.sample_epochs(tstate, pair["tf"], EPOCHS,
                                  np.random.default_rng(seed))
        tdev = ts.device_state(tstate, pair["tdata"])
        t_keys.append(_bucket_key(
            ts, tstate, pair["tdata"], tdev,
            {k: np.asarray(v) for k, v in tsched.arrivals.items()}))
    assert _partition(t_keys) == _partition(j_keys)
    assert len(_partition(t_keys)) == 5
