"""The port's always-on federated serving engine
(`repro_torch.serving.FedServeEngine`) and its scheduler, on the CPU.

Inside the port every trace comparison is exact: a served lane runs the
epoch step of `make_epoch_step` on the operands of the same session's
solo `Session.run`, so its trace is the solo trace truncated at the
reported exit epoch, whatever the arrival interleaving, and the exit
epoch is the first one where the criterion, evaluated in float32 on the
solo trace, fires.

Against the JAX package: the scheduler's host NumPy (`poisson_arrivals`,
`FifoScheduler`) is bit-equal, and the JAX `FedServeEngine`, handed
pre-planned `states=` (its own shard_map passes `check_rep=False`, and
`states=` skips the planner of ROADMAP.md R1), serves the same mixed
workloads with the same exit epochs, converged flags, engine steps and
groups, bit-equal times and uplink bits, and NMSE within rtol 1e-4 —
after the test asserts that no deciding epoch lies within that bound of
the NMSE target (where an exit epoch could flip on rounding alone).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro import serving as j_serving
from repro.plan.reference import solve_redundancy_reference
from repro.sim.network import make_fleet as j_make_fleet
from repro_torch import interop
from repro_torch.api import Session, TrainData, make_strategy, plan_sweep
from repro_torch.api import session as t_session
from repro_torch.fleet import FleetTopology
from repro_torch.serving import (ConvergenceCriterion, FedServeEngine,
                                 FifoScheduler, ServeRequest,
                                 poisson_arrivals)
from repro_torch.serving import fed_engine
from repro_torch.serving.scheduler import group_by_bucket
from repro_torch.sim.network import paper_fleet, wireless_fleet

EPOCHS = 20
LR = 0.3
N, ELL, D = 10, 64, 16
D_FEAT = 16
CPU = "cpu"
STRATEGIES = ["uncoded", "cfl", "gradcode", "stochastic", "lowlatency",
              "codedfedl", "hier"]


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
    probe = make_strategy("codedfedl", key_seed=0, d_feat=D_FEAT, rff_key=5)
    phi = probe.features(data).reshape(-1, D_FEAT).double().numpy()
    head, *_ = np.linalg.lstsq(phi, data.ys.reshape(-1).double().numpy(),
                               rcond=None)
    fdata = TrainData(data.xs, data.ys,
                      torch.tensor(head, dtype=torch.float32))
    return fleet, wfleet, data, fdata


def _sessions_for(name, small, epochs=EPOCHS):
    """(sessions, data) per strategy; distinct per-session seeds so the
    arrival-order tests can tell the sessions apart."""
    fleet, wfleet, data, fdata = small
    c = int(0.3 * data.m)
    if name == "uncoded":
        return [Session(make_strategy("uncoded"), fleet, lr, epochs,
                        seed=10 + i, device=CPU)
                for i, lr in enumerate((0.3, 0.2))], data
    if name == "cfl":
        return [Session(make_strategy("cfl", key_seed=seed, fixed_c=c),
                        fleet, LR, epochs, seed=20 + seed, device=CPU)
                for seed in (7, 8, 9)], data
    if name == "gradcode":
        return [Session(make_strategy("gradcode", r=2), fleet, lr, epochs,
                        seed=30 + i, device=CPU)
                for i, lr in enumerate((0.3, 0.25))], data
    if name == "stochastic":
        return [Session(make_strategy(
            "stochastic", key_seed=7, fixed_c=c, noise_multiplier=sigma,
            sample_frac=0.8, rounds=epochs, device=CPU),
            wfleet, LR, epochs, seed=40 + i, device=CPU)
            for i, sigma in enumerate((0.0, 0.5))], data
    if name == "lowlatency":
        return [Session(make_strategy(
            "lowlatency", key_seed=seed, fixed_c=c, chunks=4),
            wfleet, LR, epochs, seed=50 + seed, device=CPU)
            for seed in (7, 11)], data
    if name == "codedfedl":
        return [Session(make_strategy(
            "codedfedl", key_seed=seed, d_feat=D_FEAT, rff_key=5,
            fixed_c=c), wfleet, 0.5, epochs, seed=60 + seed, device=CPU)
            for seed in (7, 8)], fdata
    if name == "hier":
        topo = FleetTopology.uniform(N, 2)
        return [Session(make_strategy(
            "hierarchical", base=make_strategy("cfl", key_seed=seed,
                                               fixed_c=c),
            topology=topo), fleet, LR, epochs, seed=70 + seed, device=CPU)
            for seed in (7, 8)], data
    raise ValueError(name)


def _solo(session, data, state=None):
    return session.run(data, rng=np.random.default_rng(session.seed),
                       state=state)


def _assert_prefix_of_solo(report, session, data, state=None, solo=None):
    """Bit-for-bit: the served trace is the solo trace (over the same
    state, or planned afresh) truncated at the reported exit epoch, with
    the exit point on extras."""
    if solo is None:
        solo = _solo(session, data, state)
    t = report.extras["serve_exit_epoch"]
    assert 0 <= t <= session.epochs
    assert report.nmse.shape == (t + 1,)
    np.testing.assert_array_equal(report.nmse, solo.nmse[:t + 1])
    np.testing.assert_array_equal(report.times, solo.times[:t + 1])
    np.testing.assert_array_equal(report.epoch_durations,
                                  solo.epoch_durations[:t])
    assert report.label == solo.label
    assert report.setup_time == solo.setup_time
    return solo, t


def _expected_exit(trace, crit, budget):
    """The first epoch where `crit` fires on `trace`, in float32 as the
    engine evaluates it, else the budget: (epoch, converged)."""
    trace = np.asarray(trace, np.float32)
    target = np.float32(crit.nmse_target)
    rel = np.float32(-1.0 if crit.rel_delta is None else crit.rel_delta)
    for t in range(crit.min_epochs, budget + 1):
        prev, cur = trace[t - 1], trace[t]
        if cur <= target or np.abs(prev - cur) <= rel * prev:
            return t, True
    return budget, False


@pytest.mark.parametrize("name", STRATEGIES)
def test_serve_full_budget_equals_solo(small, name):
    """With the default (disabled) criterion a served session runs its
    whole epoch count and reproduces the solo report: trace, clock,
    uplink pricing and every strategy extra."""
    sessions, data = _sessions_for(name, small)
    states = plan_sweep(sessions, data)
    engine = FedServeEngine(data, lane_width=2, chunk=6, device=CPU)
    reports = engine.serve(sessions, states=states)
    for sess, rep, state in zip(sessions, reports, states):
        solo, t = _assert_prefix_of_solo(rep, sess, data, state)
        np.testing.assert_array_equal(rep.beta, solo.beta)
        if name == "codedfedl":  # its hook arms a plateau exit
            assert (t, rep.extras["serve_converged"]) == _expected_exit(
                solo.nmse, ConvergenceCriterion(rel_delta=1e-4), EPOCHS)
            continue
        assert t == sess.epochs
        assert rep.extras["serve_converged"] is False
        assert rep.uplink_bits_total == solo.uplink_bits_total
        for k, v in solo.extras.items():
            np.testing.assert_array_equal(np.asarray(rep.extras[k]),
                                          np.asarray(v))
        assert set(rep.extras) - set(solo.extras) == {
            "serve_exit_epoch", "serve_converged", "serve_uid"}


@pytest.mark.parametrize("name", STRATEGIES)
def test_serve_early_exit_prefix_parity(small, name):
    """An NMSE-target exit stops each lane at the FIRST epoch the
    criterion fires on its solo trace, and the served trace is that solo
    prefix bit for bit.  The target is the first session's solo NMSE
    halfway through, so at least that lane exits early."""
    sessions, data = _sessions_for(name, small)
    states = plan_sweep(sessions, data)
    solos = [_solo(sess, data, st) for sess, st in zip(sessions, states)]
    crit = ConvergenceCriterion(
        nmse_target=float(solos[0].nmse[EPOCHS // 2]))
    engine = FedServeEngine(data, lane_width=2, chunk=7, criterion=crit,
                            device=CPU)
    reports = engine.serve(sessions, states=states)
    assert reports[0].extras["serve_exit_epoch"] <= EPOCHS // 2
    for sess, rep, state, solo in zip(sessions, reports, states, solos):
        _, t = _assert_prefix_of_solo(rep, sess, data, solo=solo)
        lane_crit = sess.strategy.serve_convergence(None, crit) \
            if name == "codedfedl" else crit
        assert (t, rep.extras["serve_converged"]) == _expected_exit(
            solo.nmse, lane_crit, sess.epochs)
        assert rep.uplink_bits_total == sess.strategy.uplink_bits(
            state, sess.fleet, t)


def test_relative_plateau_exit(small):
    """The rel_delta clause fires when one epoch moves NMSE by less than
    the relative threshold; min_epochs holds it off before that."""
    fleet, _, data, _ = small
    sess = Session(make_strategy("uncoded"), fleet, 0.1, 60, seed=3,
                   device=CPU)
    crit = ConvergenceCriterion(rel_delta=5e-2, min_epochs=5)
    engine = FedServeEngine(data, lane_width=2, chunk=16, criterion=crit,
                            device=CPU)
    [rep] = engine.serve([sess])
    solo, t = _assert_prefix_of_solo(rep, sess, data)
    assert rep.extras["serve_converged"] and 5 <= t < sess.epochs
    assert (t, True) == _expected_exit(solo.nmse, crit, sess.epochs)
    rel = np.abs(np.diff(solo.nmse)) / solo.nmse[:-1]
    assert not np.any(rel[4:t - 1] <= 5e-2)  # none eligible before


def test_arrival_order_independent_traces(small):
    """Permuting the arrival interleaving of a mixed workload leaves every
    per-session report bit-identical."""
    fleet, wfleet, data, _ = small
    c1, c2 = int(0.2 * data.m), int(0.4 * data.m)
    sessions = [
        Session(make_strategy("uncoded"), fleet, LR, EPOCHS, seed=60,
                device=CPU),
        Session(make_strategy("cfl", key_seed=7, fixed_c=c1), fleet, LR,
                EPOCHS, seed=61, device=CPU),
        Session(make_strategy("cfl", key_seed=7, fixed_c=c2), fleet, LR,
                EPOCHS, seed=62, device=CPU),
        Session(make_strategy("lowlatency", key_seed=7, fixed_c=c1,
                              chunks=4), wfleet, LR, EPOCHS, seed=63,
                device=CPU),
    ]
    arrivals = [0.0, 1.0, 2.0, 3.0]
    crit = ConvergenceCriterion(nmse_target=0.3)
    states = plan_sweep(sessions, data)

    def run(order):
        engine = FedServeEngine(data, lane_width=2, chunk=9, criterion=crit,
                                device=CPU)
        uids = engine.submit_many([sessions[i] for i in order],
                                  arrivals=[arrivals[i] for i in order],
                                  states=[states[i] for i in order])
        engine.drain()
        return {order[k]: engine._done[u] for k, u in enumerate(uids)}

    base = run([0, 1, 2, 3])
    perm = run([3, 0, 2, 1])
    for i, sess in enumerate(sessions):
        np.testing.assert_array_equal(base[i].nmse, perm[i].nmse)
        np.testing.assert_array_equal(base[i].epoch_durations,
                                      perm[i].epoch_durations)
        assert base[i].extras["serve_exit_epoch"] == \
            perm[i].extras["serve_exit_epoch"]
        _assert_prefix_of_solo(base[i], sess, data, states[i])


def test_churn_more_sessions_than_slots(small):
    """Six same-bucket sessions through two lane slots: every session
    completes with solo parity in ONE group, finished lanes swapped out
    for pending arrivals."""
    fleet, _, data, _ = small
    c = int(0.3 * data.m)
    sessions = [Session(make_strategy("cfl", key_seed=7, fixed_c=c), fleet,
                        LR, EPOCHS, seed=70 + i, device=CPU)
                for i in range(6)]
    arrivals = poisson_arrivals(6, 0.5, np.random.default_rng(0))
    engine = FedServeEngine(
        data, lane_width=2, chunk=6,
        criterion=ConvergenceCriterion(nmse_target=0.3), device=CPU)
    reports = engine.serve(sessions, arrivals=list(arrivals))  # plans
    assert len(reports) == 6 and engine.n_groups == 1
    assert engine.n_active == 0 and engine.n_pending == 0
    for sess, rep, state in zip(sessions, reports,
                                plan_sweep(sessions, data)):
        _assert_prefix_of_solo(rep, sess, data, state)
        assert rep.extras["serve_converged"]


def test_epsilon_budget_exhaustion_caps_epochs(small):
    """A DP-budgeted SCFL session stops at its accounting horizon: the
    hook caps the budget at `rounds`, and the run is a solo prefix of
    exactly that length."""
    _, wfleet, data, _ = small
    c = int(0.3 * data.m)
    rounds = 10
    sess = Session(make_strategy(
        "stochastic", key_seed=7, fixed_c=c, epsilon_target=5.0,
        delta=1e-5, sample_frac=0.8, rounds=rounds, device=CPU),
        wfleet, LR, EPOCHS, seed=80, device=CPU)
    engine = FedServeEngine(data, lane_width=2, chunk=8, device=CPU)
    [rep] = engine.serve([sess])
    solo, t = _assert_prefix_of_solo(rep, sess, data)
    assert t == rounds
    assert rep.extras["serve_converged"] is False  # budget, not convergence
    assert rep.extras["accounting_rounds"] == rounds
    np.testing.assert_array_equal(rep.extras["epsilon_schedule"],
                                  solo.extras["epsilon_schedule"])
    assert rep.extras["epsilon_spent"] == solo.extras["epsilon_spent"]


def test_epsilon_schedule_truncated_on_early_exit(small):
    """When convergence beats the accounting horizon, the cumulative
    epsilon schedule and the spend truncate to the epochs served."""
    _, wfleet, data, _ = small
    c = int(0.3 * data.m)
    sess = Session(make_strategy(
        "stochastic", key_seed=7, fixed_c=c, noise_multiplier=0.5,
        sample_frac=0.8, rounds=EPOCHS, device=CPU),
        wfleet, LR, EPOCHS, seed=81, device=CPU)
    engine = FedServeEngine(
        data, lane_width=2, chunk=8,
        criterion=ConvergenceCriterion(nmse_target=0.5), device=CPU)
    [rep] = engine.serve([sess])
    solo, t = _assert_prefix_of_solo(rep, sess, data)
    assert rep.extras["serve_converged"] and 0 < t < EPOCHS
    full = np.asarray(solo.extras["epsilon_schedule"])
    cut = np.asarray(rep.extras["epsilon_schedule"])
    assert cut.shape == (t,)
    np.testing.assert_array_equal(cut, full[:t])
    assert rep.extras["epsilon_spent"] == float(full[t - 1])
    assert rep.extras["accounting_rounds"] == t
    assert rep.privacy_budget() is not None


def test_criterion_validation():
    with pytest.raises(ValueError, match="min_epochs"):
        ConvergenceCriterion(min_epochs=0)
    with pytest.raises(ValueError, match="max_epochs"):
        ConvergenceCriterion(max_epochs=-1)
    assert ConvergenceCriterion(max_epochs=10).budget(25) == 10
    assert ConvergenceCriterion().budget(25) == 25
    with pytest.raises(ValueError, match="rate"):
        poisson_arrivals(4, 0.0, np.random.default_rng(0))


def test_duplicate_uid_and_engine_arguments_rejected(small):
    fleet, _, data, _ = small
    sess = Session(make_strategy("uncoded"), fleet, LR, 5, seed=0,
                   device=CPU)
    engine = FedServeEngine(data, lane_width=2, chunk=4, device=CPU)
    engine.submit(sess, uid=5)
    with pytest.raises(ValueError, match="duplicate"):
        engine.submit(sess, uid=5)
    with pytest.raises(ValueError, match="lane_width"):
        FedServeEngine(data, lane_width=0, device=CPU)
    with pytest.raises(ValueError, match="chunk"):
        FedServeEngine(data, chunk=0, device=CPU)
    with pytest.raises(ValueError, match="engine runs on"):
        FedServeEngine(data, device="meta")


def test_launches_equal_the_epochs_served(small, monkeypatch):
    """The epoch step runs exactly once per epoch served — a lane stops
    computing the epoch it converges — and the host reads one predicate
    vector per group-epoch at or past `min_epochs`."""
    calls, reads = [], []

    def counted(strategy, state, m):
        step = t_session.make_epoch_step(strategy, state, m)

        def run(*args):
            calls.append(1)
            return step(*args)
        return run

    real_fired = fed_engine._fired

    def fired(hits):
        reads.append(len(hits))
        return real_fired(hits)

    monkeypatch.setattr(fed_engine, "make_epoch_step", counted)
    monkeypatch.setattr(fed_engine, "_fired", fired)
    monkeypatch.setattr(t_session, "_ENGINE_CACHE", type(
        t_session._ENGINE_CACHE)())
    sessions, data = _sessions_for("cfl", small)
    crit = ConvergenceCriterion(nmse_target=0.3, min_epochs=3)
    engine = FedServeEngine(data, lane_width=2, chunk=5, criterion=crit,
                            device=CPU)
    reports = engine.serve(sessions)
    exits = [r.extras["serve_exit_epoch"] for r in reports]
    assert any(t < EPOCHS for t in exits)
    assert len(calls) == sum(exits)
    # two slots: lanes 0 and 1 together, lane 2 once a slot frees
    assert len(reads) > 0 and all(1 <= k <= 2 for k in reads)
    assert len(reads) <= max(exits[0], exits[1]) - 2 + exits[2] - 2


def test_serve_engine_programs_are_cached(small):
    """Two engines over the same workload shape share their epoch steps
    through the process-wide engine cache."""
    fleet, _, data, _ = small
    sess = Session(make_strategy("uncoded"), fleet, LR, EPOCHS, seed=90,
                   device=CPU)
    FedServeEngine(data, lane_width=2, chunk=10, device=CPU).serve([sess])
    before = len(t_session._ENGINE_CACHE)
    FedServeEngine(data, lane_width=2, chunk=10, device=CPU).serve([sess])
    assert len(t_session._ENGINE_CACHE) == before


def test_engine_cache_lru_semantics(monkeypatch):
    """`cache_engine` is a capped LRU: hits refresh recency, inserts past
    the cap (env-overridable, floor 1) evict the least-recently-used."""
    from repro_torch.api.session import cache_engine, engine_cache_max

    cache = t_session._ENGINE_CACHE
    saved = dict(cache)
    cache.clear()
    try:
        monkeypatch.setenv("REPRO_ENGINE_CACHE_MAX", "2")
        builds = []

        def make(tag):
            def build():
                builds.append(tag)
                return tag
            return build

        assert cache_engine(("k", 1), make("e1")) == "e1"
        assert cache_engine(("k", 2), make("e2")) == "e2"
        assert cache_engine(("k", 1), make("e1b")) == "e1"  # hit
        assert builds == ["e1", "e2"]
        assert cache_engine(("k", 3), make("e3")) == "e3"  # evicts ("k", 2)
        assert list(cache) == [("k", 1), ("k", 3)]
        assert cache_engine(("k", 2), make("e2b")) == "e2b"
        assert builds == ["e1", "e2", "e3", "e2b"]
        monkeypatch.setenv("REPRO_ENGINE_CACHE_MAX", "not-a-number")
        assert engine_cache_max() == 64
        monkeypatch.setenv("REPRO_ENGINE_CACHE_MAX", "-5")
        assert engine_cache_max() == 1
    finally:
        cache.clear()
        cache.update(saved)


def test_engine_cache_eviction_never_breaks_inflight_buckets(monkeypatch,
                                                             small):
    """With the cache capped at ONE entry, a mixed workload whose buckets
    evict each other's steps mid-serve still finishes every session with
    a solo-prefix trace: groups pin their own step."""
    fleet, _, data, _ = small
    cache = t_session._ENGINE_CACHE
    saved = dict(cache)
    cache.clear()
    try:
        monkeypatch.setenv("REPRO_ENGINE_CACHE_MAX", "1")
        c = int(0.3 * data.m)
        sessions = [
            Session(make_strategy("uncoded"), fleet, LR, EPOCHS, seed=70,
                    device=CPU),
            Session(make_strategy("cfl", key_seed=7, fixed_c=c), fleet, LR,
                    EPOCHS, seed=71, device=CPU),
            Session(make_strategy("uncoded"), fleet, 0.2, EPOCHS, seed=72,
                    device=CPU),
            Session(make_strategy("cfl", key_seed=8, fixed_c=c), fleet, LR,
                    EPOCHS, seed=73, device=CPU),
        ]
        states = plan_sweep(sessions, data)
        engine = FedServeEngine(data, lane_width=2, chunk=7, device=CPU)
        reports = engine.serve(sessions, states=states)
        assert engine.n_groups >= 2
        assert len(cache) <= 1
        for rep, sess, state in zip(reports, sessions, states):
            _assert_prefix_of_solo(rep, sess, data, state)
    finally:
        cache.clear()
        cache.update(saved)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_scheduler_matches_the_reference():
    """`poisson_arrivals`, the FIFO admission scan and `group_by_bucket`
    give the reference's numbers and order."""
    from repro.serving.scheduler import group_by_bucket as j_group

    got = poisson_arrivals(32, 0.3, np.random.default_rng(4))
    want = j_serving.poisson_arrivals(32, 0.3, np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)
    keys = ["a", "b", "a", "c", "b", "a", "a", "c"]
    arrivals = np.round(got[:8], 0)
    t_s, j_s = FifoScheduler(), j_serving.FifoScheduler()
    for uid, (key, arr) in enumerate(zip(keys, arrivals)):
        t_s.push(ServeRequest(session=None, uid=uid, arrival=arr), key)
        j_s.push(j_serving.ServeRequest(session=None, uid=uid, arrival=arr),
                 key)
    assert [r.uid for r in t_s.pending] == [r.uid for r in j_s.pending]
    for now in (arrivals[2], arrivals[5], np.inf):
        budget = {"a": 1, "b": 2, "c": 0}
        t_cap, j_cap = dict(budget), dict(budget)

        def cap(left):
            def fn(key):
                left[key] -= 1
                return left[key] >= 0
            return fn

        assert t_s.next_arrival(now) == j_s.next_arrival(now)
        got_uids = [r.uid for r, _ in t_s.pop_admissible(now, cap(t_cap))]
        want_uids = [r.uid for r, _ in j_s.pop_admissible(now, cap(j_cap))]
        assert got_uids == want_uids
    assert group_by_bucket(keys) == j_group(keys)
    assert ServeRequest(session=None, uid=0, rng_seed=9).make_rng() \
        .random() == np.random.default_rng(9).random()


def _fleets(n, seed):
    jf = j_make_fleet(n, D, 0.3, 0.3, np.random.default_rng(seed))
    tf = interop.fleet_spec(
        interop.delay_params(jf.edge.a, jf.edge.mu, jf.edge.tau, jf.edge.p),
        interop.delay_params(jf.server.a, jf.server.mu, jf.server.tau,
                             jf.server.p),
        jf.mac_rates, jf.link_rates, jf.packet_bits, jf.d, jf.nu_comp,
        jf.nu_link)
    return jf, tf


def _data(n, seed):
    rng = np.random.default_rng(100 + seed)
    xs = rng.standard_normal((n, ELL, D)).astype(np.float32)
    beta = rng.standard_normal(D).astype(np.float32)
    ys = (xs @ beta + rng.standard_normal((n, ELL))).astype(np.float32)
    return (j_api.TrainData(jnp.asarray(xs), jnp.asarray(ys),
                            jnp.asarray(beta)),
            interop.train_data(xs, ys, beta, device=CPU))


# (n, fleet seed, lanes, lane_width, chunk, NMSE target, arrival rate):
# lanes are ("cfl", key, c) / ("uncoded", lr) / ("gradcode", r), the
# coded ones at J_LR; c = 143 at n = 8 is the dense layout, at n = 10
# c = 179 packs 512 rows and c = 40 stays dense.  At J_LR the lanes exit
# between epochs 13 and 17, and the slow uncoded lane runs its budget.
J_LR = 0.05
WORKLOADS = {
    "three-cfl-one-uncoded": (
        8, 3, [("cfl", 1, 143), ("cfl", 2, 143), ("cfl", 3, 143),
               ("uncoded", J_LR)], 2, 7, 0.2, None),
    "churn-mixed-layouts": (
        10, 5, [("cfl", 1, 179), ("cfl", 2, 179), ("uncoded", J_LR),
                ("cfl", 3, 40), ("gradcode", 2), ("cfl", 4, 179),
                ("uncoded", 0.03), ("cfl", 5, 40)], 2, 5, 0.3, 0.5),
}


def _workload(name):
    n, seed, lanes, width, chunk, target, rate = WORKLOADS[name]
    jf, tf = _fleets(n, seed)
    jdata, tdata = _data(n, seed)
    plans = {}
    j_sess, j_states, t_sess, t_states = [], [], [], []
    for i, lane in enumerate(lanes):
        if lane[0] == "cfl":
            _, key, c = lane
            if c not in plans:
                plans[c] = solve_redundancy_reference(
                    jf.edge, jf.server, np.full(n, ELL), fixed_c=c)
            plan = plans[c]
            js = j_api.CodedFL(key=jax.random.PRNGKey(key), fixed_c=c,
                               redundancy_plan=plan,
                               include_upload_delay=False)
            jstate = js.plan_with(jf, jdata, plan)
            tplan = interop.redundancy_plan(
                plan.loads, plan.c, plan.t_star, plan.p_return,
                plan.expected_agg, plan.loads_cap_total)
            ts = make_strategy("cfl", key_seed=key, fixed_c=c,
                               redundancy_plan=tplan,
                               include_upload_delay=False)
            tstate = interop.cfl_state(
                tplan, np.asarray(jstate.weights),
                np.asarray(jstate.load_mask), np.asarray(jstate.x_parity),
                np.asarray(jstate.y_parity), tf.edge, tf.server, device=CPU)
            lr = J_LR
        elif lane[0] == "uncoded":
            js, ts, lr = j_api.UncodedFL(), make_strategy("uncoded"), lane[1]
            jstate, tstate = js.plan(jf, jdata), ts.plan(tf, tdata)
        else:
            js = j_api.GradientCodingFL(r=lane[1])
            ts = make_strategy("gradcode", r=lane[1])
            jstate = js.plan(jf, jdata)
            tstate = interop.gradcoding_state(
                lane[1], jstate.plan.groups, jstate.n_groups, jstate.ell,
                jstate.share_bits, jstate.shard_time)
            lr = J_LR
        j_sess.append(j_api.Session(js, jf, lr, EPOCHS, seed=i))
        t_sess.append(Session(ts, tf, lr, EPOCHS, seed=i, device=CPU))
        j_states.append(jstate)
        t_states.append(tstate)
    arrivals = None if rate is None else \
        list(poisson_arrivals(len(lanes), rate, np.random.default_rng(1)))
    return (jdata, tdata, j_sess, j_states, t_sess, t_states, width, chunk,
            target, arrivals)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_serving_matches_the_jax_engine(name):
    (jdata, tdata, j_sess, j_states, t_sess, t_states, width, chunk,
     target, arrivals) = _workload(name)
    j_engine = j_serving.FedServeEngine(
        jdata, lane_width=width, chunk=chunk,
        criterion=j_serving.ConvergenceCriterion(nmse_target=target))
    want = j_engine.serve(j_sess, arrivals=arrivals, states=j_states)
    t_engine = FedServeEngine(
        tdata, lane_width=width, chunk=chunk,
        criterion=ConvergenceCriterion(nmse_target=target), device=CPU)
    got = t_engine.serve(t_sess, arrivals=arrivals, states=t_states)
    # the knife edge: an exit epoch can flip on rounding alone only where
    # the reference's NMSE lies within the trace bound of the target at
    # an epoch that decides it (every epoch up to the exit)
    margin = min(float(np.min(np.abs(w.nmse[1:] - target) / w.nmse[1:]))
                 for w in want)
    assert margin > 1e-4, margin
    assert any(w.extras["serve_converged"] for w in want)
    for g, w in zip(got, want):
        for k in ("serve_exit_epoch", "serve_converged", "serve_uid"):
            assert g.extras[k] == w.extras[k], k
        np.testing.assert_array_equal(g.times, w.times)
        np.testing.assert_array_equal(g.epoch_durations, w.epoch_durations)
        assert g.uplink_bits_total == w.uplink_bits_total
        assert g.setup_time == w.setup_time
        np.testing.assert_allclose(g.nmse, w.nmse, rtol=1e-4, atol=0.0)
    assert t_engine.steps == j_engine.steps
    assert t_engine.n_groups == j_engine.n_groups
    assert t_engine.now == j_engine.now
