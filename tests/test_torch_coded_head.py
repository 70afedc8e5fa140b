"""`repro_torch.fed.coded_head` and the `repro_torch.nonlinear_quickstart`
entry, on the CPU.

`extract_features` is held to the reference's on the same backbone
weights (within 1e-6).  `train_coded_head` is held to the reference's
own function on both routes (`d_feat=None` and the RFF map): its
batched planner fails on this JAX (ROADMAP "Reference state", R1) and
so does its `Session.run` (R2), so the reference's coded strategies are
handed the NumPy oracle's plan as `redundancy_plan=` (the CodedFedL one
with its edge `p_return` from `mec_total_cdf`) and its `Session` is
swapped for one that trains through the jitted epoch step.  The port's
strategies take the reference's state (plan, weights, parity) and, on
the RFF route, its features, so what is held is the function's own
logic: the float64 least-squares reference head, the pre-mapped
uncoded arm and the shared generator consumed uncoded first.  Times
identical, NMSE within rtol 1e-4 (the bound of
`tests/test_torch_slice.py`).  The port's runs are also held to the
configuration and assertions of `tests/test_coded_head.py` (final NMSE
< 5e-2, coded time minus set-up below the uncoded time) and to the
`Session` runs written out (bit-equal).  The quickstart entry runs at
its own configuration and passes the example's accuracy assertion.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fed.coded_head as j_coded_head
from repro import api as j_api
from repro.api.session import _lane_report
from repro.core import aggregation as j_agg
from repro.data import classification_dataset as j_classification_dataset
from repro.data import one_vs_rest_targets as j_one_vs_rest_targets
from repro.fed.coded_head import extract_features as j_extract_features
from repro.plan.reference import solve_redundancy_reference
from repro.sim.network import paper_fleet as j_paper_fleet
from repro.sim.network import wireless_fleet as j_wireless_fleet
from repro_torch import interop, nonlinear_quickstart
from repro_torch.api import Session, TrainData
from repro_torch.api.strategy import CodedFL, UncodedFL
from repro_torch.data import (classification_dataset, one_vs_rest_targets,
                              rff_map)
from repro_torch.fed import coded_head, extract_features, train_coded_head
from repro_torch.schemes import CodedFedL, rff_seed
from repro_torch.sim.network import paper_fleet, wireless_fleet
from test_torch_codedfedl import mec_oracle_plan
from test_torch_schemes import port_plan
from test_torch_slice import _assert_same_run


def test_extract_features_vmaps_backbone():
    w = torch.tensor(np.random.default_rng(0).standard_normal((4, 3)),
                     dtype=torch.float32)

    def backbone(x):  # (ell, d_in) -> (ell, d_out)
        return torch.tanh(x @ w)

    xs = torch.tensor(np.random.default_rng(1).standard_normal((5, 7, 4)),
                      dtype=torch.float32)
    f = extract_features(backbone, xs)
    assert f.shape == (5, 7, 3)
    for i in range(5):
        assert torch.equal(f[i], backbone(xs[i]))
    want = j_extract_features(lambda x: jnp.tanh(x @ jnp.asarray(w.numpy())),
                              jnp.asarray(xs.numpy()))
    np.testing.assert_allclose(f.numpy(), np.asarray(want), atol=1e-6)


def _linreg_head():
    """The configuration of tests/test_coded_head.py, drawn with NumPy."""
    n, ell, d = 10, 40, 24
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, ell, d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    ys = (feats @ beta
          + 0.05 * rng.standard_normal((n, ell))).astype(np.float32)
    fleet = paper_fleet(0.25, 0.25, seed=3, n=n, d=d)
    return fleet, torch.tensor(feats), torch.tensor(ys), torch.tensor(beta)


def test_coded_head_trains_and_beats_uncoded_wallclock():
    fleet, feats, ys, beta = _linreg_head()
    c = int(0.3 * feats.shape[0] * feats.shape[1])
    out = train_coded_head(fleet, None, feats, ys, beta, lr=0.05,
                           epochs=250, key=1, rng=np.random.default_rng(0),
                           fixed_c=c)
    assert sorted(out) == ["cfl", "uncoded"]
    assert out["cfl"].final_nmse() < 5e-2
    # same epoch count, coded deadline < uncoded straggler-wait
    assert out["cfl"].times[-1] - out["cfl"].setup_time \
        < out["uncoded"].times[-1]

    # the shared generator is consumed uncoded first, then coded
    rng = np.random.default_rng(0)
    data = TrainData(feats, ys, beta)
    u = Session(UncodedFL(), fleet, 0.05, 250, device="cpu").run(data,
                                                                  rng=rng)
    cfl = Session(CodedFL(key=1, fixed_c=c, include_upload_delay=False,
                          use_kernel=True),
                  fleet, 0.05, 250, device="cpu").run(data, rng=rng)
    np.testing.assert_array_equal(out["uncoded"].nmse, u.nmse)
    np.testing.assert_array_equal(out["cfl"].nmse, cfl.nmse)
    np.testing.assert_array_equal(out["cfl"].times, cfl.times)


def test_coded_head_through_a_backbone():
    fleet, feats, ys, beta = _linreg_head()
    lift = torch.eye(24)

    out = train_coded_head(fleet, lambda x: x @ lift, feats, ys, beta,
                           lr=0.05, epochs=40, key=1,
                           rng=np.random.default_rng(2), fixed_c=120,
                           uncoded_baseline=False)
    ref = train_coded_head(fleet, None, feats, ys, beta, lr=0.05, epochs=40,
                           key=1, rng=np.random.default_rng(2), fixed_c=120,
                           uncoded_baseline=False)
    assert sorted(out) == ["cfl"]
    np.testing.assert_array_equal(out["cfl"].nmse, ref["cfl"].nmse)


def test_rff_route_trains_both_arms_on_the_same_features():
    """The d_feat route: the float64 least-squares head of the mapped
    features as beta_true, the uncoded arm on those features first, then
    CodedFedL (MEC plan) on the raw inputs it maps itself."""
    n, ell, d_raw, d_feat = 8, 40, 6, 32
    fleet = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=n, d=d_feat)
    xs, labels = classification_dataset(torch.Generator().manual_seed(3), n,
                                        ell, d_raw, n_classes=2, centers=16,
                                        gamma=2.0)
    ys = one_vs_rest_targets(labels, 1)
    kw = {"d_feat": d_feat, "rff_gamma": 2.0 / d_raw, "fixed_c": 96}
    out = train_coded_head(fleet, None, xs, ys, torch.zeros(d_raw),
                           lr=0.3, epochs=30, key=4,
                           rng=np.random.default_rng(1), **kw)
    assert sorted(out) == ["cfedl", "uncoded"]

    phi = rff_map(xs, d_feat, rff_seed(4), gamma=kw["rff_gamma"])
    beta_ref, *_ = np.linalg.lstsq(
        phi.numpy().astype(np.float64).reshape(-1, d_feat),
        ys.numpy().astype(np.float64).ravel(), rcond=None)
    beta_ref = torch.tensor(beta_ref, dtype=torch.float32)
    rng = np.random.default_rng(1)
    u = Session(UncodedFL(), fleet, 0.3, 30, device="cpu").run(
        TrainData(phi, ys, beta_ref), rng=rng)
    coded = CodedFedL(key=4, include_upload_delay=False, use_kernel=True,
                      **kw)
    c = Session(coded, fleet, 0.3, 30, device="cpu").run(
        TrainData(xs, ys, beta_ref), rng=rng)
    np.testing.assert_array_equal(out["uncoded"].nmse, u.nmse)
    np.testing.assert_array_equal(out["uncoded"].times, u.times)
    np.testing.assert_array_equal(out["cfedl"].nmse, c.nmse)
    np.testing.assert_array_equal(out["cfedl"].times, c.times)
    assert out["cfedl"].extras["mec_comm"] == 1.0
    assert out["cfedl"].final_nmse() < out["cfedl"].nmse[0]


class _EpochStepSession:
    """The reference's `Session` with its scan engine (R2) replaced by the
    jitted epoch step; each run's strategy and state are kept by label."""

    runs: dict = {}

    def __init__(self, strategy, fleet, lr, epochs):
        self.strategy, self.fleet = strategy, fleet
        self.lr, self.epochs = lr, epochs

    def run(self, data, rng):
        s = self.strategy
        state = s.plan(self.fleet, data)
        self.runs[s.label] = (s, state)
        sched = s.sample_epochs(state, self.fleet, self.epochs, rng)
        dev = s.device_state(state, data)
        step = jax.jit(j_api.make_epoch_step(s, state, data.m))
        beta = jnp.zeros(data.model_dim, jnp.float32)
        lr = jnp.asarray(self.lr, jnp.float32)
        trace = [float(j_agg.nmse(beta, data.beta_true))]
        for e in range(self.epochs):
            arr = {k: jnp.asarray(v[e]) for k, v in sched.arrivals.items()}
            beta, err = step(beta, dev, lr, data.beta_true, arr)
            trace.append(float(err))
        return _lane_report(self, state, sched, np.asarray(trace),
                            beta=np.asarray(beta))


def _crossed_strategies():
    """The port's coded strategies with the reference's planned state and
    feature map: `plan` returns the state the reference's run planned,
    crossed over with `interop`."""
    runs = _EpochStepSession.runs

    @dataclasses.dataclass(frozen=True)
    class CrossedCodedFL(CodedFL):
        def plan(self, fleet, data):
            js = runs["cfl"][1]
            return interop.cfl_state(
                port_plan(js.plan), np.asarray(js.weights),
                np.asarray(js.load_mask), np.asarray(js.x_parity),
                np.asarray(js.y_parity), fleet.edge, fleet.server,
                device="cpu")

    @dataclasses.dataclass(frozen=True)
    class CrossedCodedFedL(CodedFedL):
        def features(self, data):
            jdata = j_api.TrainData(jnp.asarray(data.xs.numpy()),
                                    jnp.asarray(data.ys.numpy()),
                                    jnp.zeros(0))
            return torch.tensor(np.asarray(runs["cfedl"][0].features(jdata)))

        def plan(self, fleet, data):
            js = runs["cfedl"][1]
            return interop.codedfedl_state(
                port_plan(js.plan), np.asarray(js.load_mask),
                np.asarray(js.x_parity), np.asarray(js.y_parity),
                fleet.edge, fleet.server, np.asarray(js.features),
                device="cpu")

    return CrossedCodedFL, CrossedCodedFedL


def _head_problem(route):
    """(fleets, xs, ys, beta_true, oracle plan, keyword arguments) of one
    route: the linear head of `_linreg_head`, or the RFF head on the
    teacher's data of `tests/test_nonlinear.py`'s fixture."""
    if route == "cfl":
        fleet, feats, ys, beta = _linreg_head()
        n, ell, d = feats.shape
        jf = j_paper_fleet(0.25, 0.25, seed=3, n=n, d=d)
        c = int(0.3 * n * ell)
        plan = solve_redundancy_reference(jf.edge, jf.server,
                                          np.full(n, ell), fixed_c=c)
        return ((jf, fleet), feats.numpy(), ys.numpy(), beta.numpy(), plan,
                {"lr": 0.05, "fixed_c": c})
    n, ell, d_raw, d_feat = 12, 60, 6, 32
    jf = j_wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=n, d=d_feat)
    tf = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=n, d=d_feat)
    xs, labels = j_classification_dataset(jax.random.PRNGKey(2), n, ell,
                                          d_raw, n_classes=2, centers=16,
                                          gamma=2.0)
    ys = j_one_vs_rest_targets(labels, 1)
    c = int(0.3 * n * ell)
    return ((jf, tf), np.asarray(xs), np.asarray(ys),
            np.zeros(d_raw, np.float32), mec_oracle_plan(jf, n, ell, c),
            {"lr": 0.3, "fixed_c": c, "d_feat": d_feat,
             "rff_gamma": 2.0 / d_raw})


@pytest.mark.parametrize("route", ["cfl", "cfedl"])
def test_train_coded_head_matches_reference(route, monkeypatch):
    """Both arms of the reference's `train_coded_head` and the port's on
    the same plan, state and features: times identical, NMSE within rtol
    1e-4, the same set-up time."""
    (jf, tf), xs, ys, beta, plan, kw = _head_problem(route)
    key_seed, epochs = 7, 30
    _EpochStepSession.runs.clear()
    monkeypatch.setattr(j_coded_head, "Session", _EpochStepSession)
    for name in ("CodedFL", "CodedFedL"):
        monkeypatch.setattr(j_coded_head, name, functools.partial(
            getattr(j_coded_head, name), redundancy_plan=plan))
    want = j_coded_head.train_coded_head(
        jf, None, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(beta),
        epochs=epochs, key=jax.random.PRNGKey(key_seed),
        rng=np.random.default_rng(0), **kw)

    crossed_cfl, crossed_cfedl = _crossed_strategies()
    monkeypatch.setattr(coded_head, "CodedFL", crossed_cfl)
    monkeypatch.setattr(coded_head, "CodedFedL", crossed_cfedl)
    got = train_coded_head(tf, None, torch.tensor(xs), torch.tensor(ys),
                           torch.tensor(beta), epochs=epochs, key=key_seed,
                           rng=np.random.default_rng(0), **kw)
    assert sorted(got) == sorted(want) == sorted(["uncoded", route])
    for arm in want:
        _assert_same_run(got[arm], want[arm])
        assert got[arm].setup_time == want[arm].setup_time
        assert got[arm].nmse[-1] < got[arm].nmse[0]


def test_nonlinear_quickstart_passes_its_assertion_on_the_cpu(capsys):
    nonlinear_quickstart.main(device="cpu")
    printed = capsys.readouterr().out
    assert "MEC delay model, d_feat=256" in printed
    out = nonlinear_quickstart.run(epochs=30, device="cpu")
    plan = out["state"].plan
    assert plan.c == nonlinear_quickstart.FIXED_C
    assert np.all(plan.loads <= nonlinear_quickstart.ELL)
    assert out["report"].nmse.shape == (31,)
    assert out["report"].extras["mec_comm"] == 1.0
    assert 0.5 < out["linear_accuracy"] < 1.0


def test_nonlinear_quickstart_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nonlinear_quickstart.run(epochs=1)
