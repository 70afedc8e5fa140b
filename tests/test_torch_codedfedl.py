"""`CodedFedL`, the RFF map, the classification teacher, the MEC delay
model and the planner's `mec_comm` objective of the port against the JAX
package, on the CPU.

The JAX batched planner fails on this JAX (ROADMAP "Reference state",
R1), so the JAX strategy is handed a `redundancy_plan=` from the NumPy
oracle `repro.plan.reference_schemes.solve_codedfedl_reference`.  That
oracle's `p_return` is the base-model CDF (its docstring says so); its
edge entries are replaced by `mec_total_cdf` at the oracle's loads and
t* before either package sees the plan, so both train with the weights
the real main path computes.  The reference's features (its
`jax.random` RFF draw) and encoded parity cross into the port with
`repro_torch.interop`; the JAX side trains epoch by epoch through
`jax.jit(repro.api.make_epoch_step(...))`.

Bounds:
  * `mec_total_cdf`, `sample_total_mec` and the epoch schedules:
    bit-equal (NumPy copies, the same generator draws);
  * the MEC planner against the oracle at eps_rel 1e-4: t* within rtol
    1e-3 (`tests/test_nonlinear.py`'s bound), loads and c equal to the
    oracle's allocation rule at the port's t*; at eps_rel 1e-12, loads
    and c equal to the oracle's and t* within rtol 1e-9;
    `p_return` equal to `mec_total_cdf` at the plan;
  * `rff_features` on the reference's weights within atol 5e-6 of its
    `rff_map` and of its float64 oracle (`tests/test_nonlinear.py`);
  * the teacher's labels equal on the reference's operands, outside
    near-ties (top-two gap under 1e-5 of the score scale);
  * training, flat and under `HierarchicalCFL` at T = 3, on both
    gradient paths: times identical, NMSE within rtol 1e-4 over 30
    epochs (the bound of `tests/test_torch_slice.py`);
  * T = 1 and `d_feat=None` (against `CodedFL`) bit-equal inside the
    port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro import api as j_api
from repro import fleet as j_fleet
from repro.core.delay_model import DeviceDelayParams as JParams
from repro.core.delay_model import mec_total_cdf as j_mec_total_cdf
from repro.core.delay_model import sample_total_mec as j_sample_total_mec
from repro.data import classification_dataset as j_classification_dataset
from repro.data import one_vs_rest_targets as j_one_vs_rest_targets
from repro.data import rff_map as j_rff_map
from repro.data import rff_map_reference as j_rff_map_reference
from repro.data.rff import _rff_weights as j_rff_weights
from repro.plan.reference import optimal_loads_loop
from repro.plan.reference_schemes import (optimal_loads_mec_loop,
                                          solve_codedfedl_reference)
from repro.schemes.codedfedl import _RFF_FOLD as J_RFF_FOLD
from repro.sim.network import wireless_fleet as j_wireless_fleet
from repro_torch import api as t_api
from repro_torch import interop
from repro_torch.core import encoding
from repro_torch.core.delay_model import DeviceDelayParams as TParams
from repro_torch.core.delay_model import mec_total_cdf, sample_total_mec
from repro_torch.core.redundancy import systematic_weights
from repro_torch.data import (classification_dataset, one_vs_rest_targets,
                              rff_features, rff_map, rff_map_reference,
                              rff_weights, teacher_labels)
from repro_torch.fleet import (FleetTopology, HierarchicalCFL, HierState,
                               solve_fleet)
from repro_torch.plan import PlanRequest, solve_redundancy_batched
from repro_torch.schemes import CodedFedL, rff_seed
from repro_torch.sim.network import wireless_fleet
from test_torch_plan import _problem
from test_torch_schemes import port_plan
from test_torch_slice import EPOCHS, LR, _assert_same_run, _jax_run

# the JAX fixture of tests/test_nonlinear.py
N, ELL, D_RAW, D_FEAT = 12, 60, 6, 32
KEY_SEED, GAMMA = 7, 2.0 / 6
FIXED_C = int(0.3 * N * ELL)


def _edge(seed, n):
    (je, _), (te, _), _, _ = _problem(n, 40, "free", seed)
    return je, te


# ---------------------------------------------------------------------------
# the MEC delay model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [2, 3, 17])
def test_mec_total_cdf_bit_equal(seed):
    je, te = _edge(seed, 6)
    ell = np.array([12, 25, 0, 30, 18, 9])
    for t in (0.0, 0.05, 0.4, 1.1, 2.2, 50.0):
        np.testing.assert_array_equal(mec_total_cdf(te, ell, t),
                                      j_mec_total_cdf(je, ell, t))
    # a batch of loads broadcasts as in total_cdf
    grid = np.arange(0, 31)[:, None] * np.ones(6)
    np.testing.assert_array_equal(mec_total_cdf(te, grid, 0.9),
                                  j_mec_total_cdf(je, grid, 0.9))


def test_mec_total_cdf_branches_bit_equal():
    """Zero loads, deterministic links (p = 0 or tau = 0: the compute CDF
    at the residual) and colliding rates (the equal-rate limit)."""
    p = np.array([0.2, 0.0, 0.25, 0.1, 0.3, 0.15])
    tau = np.array([0.01, 0.02, 0.0, 0.03, 0.005, 0.04])
    ell = np.array([10, 20, 15, 0, 8, 25], dtype=np.float64)
    a = np.full(6, 0.01)
    gm = (1.0 - p) / np.maximum(2.0 * tau * p, 1e-30)
    mu = np.array([50.0, 80.0, 60.0, 70.0, 0.0, 90.0])
    mu[4] = gm[4] * ell[4]          # gc == gm: the equal-rate branch
    mu[5] = gm[5] * ell[5] * (1.0 + 1e-9)   # inside the 1e-8 tie margin
    je, te = JParams(a, mu, tau, p), TParams(a, mu, tau, p)
    gc = mu / np.maximum(ell, 1.0)
    close = np.abs(gm - gc) <= 1e-8 * np.maximum(gm, gc)
    assert close[4] and close[5] and not close[:4].any()
    for t in (0.0, 0.05, 0.1, 0.2, 0.5, 1.0, 5.0):
        got = mec_total_cdf(te, ell, t)
        np.testing.assert_array_equal(got, j_mec_total_cdf(je, ell, t))
        assert np.all((got >= 0.0) & (got <= 1.0))
    # the zero-load device is done once its 2 tau floor has passed
    assert mec_total_cdf(te, ell, 2.0 * tau[3])[3] == 1.0
    # the server-style device (tau = 0) is the compute CDF at the residual
    t = 0.5
    u = t - ell[2] * a[2]
    assert mec_total_cdf(te, ell, t)[2] == -np.expm1(-mu[2] / ell[2] * u)


@pytest.mark.parametrize("size", [None, 5])
def test_sample_total_mec_bit_equal(size):
    je, te = _edge(4, 7)
    ell = np.array([10, 0, 30, 12, 5, 40, 22])
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        got = sample_total_mec(te, ell, r1, size=size)
        np.testing.assert_array_equal(got,
                                      j_sample_total_mec(je, ell, r2,
                                                         size=size))
    # two draws per device per call, whatever the loads
    assert r1.bit_generator.state == r2.bit_generator.state
    fresh = np.random.default_rng(3)
    fresh.exponential(1.0, size=(4 * 2,) + ((size,) if size else ())
                      + (7,))
    assert fresh.bit_generator.state == r1.bit_generator.state


# ---------------------------------------------------------------------------
# the planner's mec_comm objective
# ---------------------------------------------------------------------------

def _mec_oracle_at(edge, server, sizes, kw, t):
    """The oracle's allocation rule at deadline `t`: its MEC edge loads and
    c (the fixed budget, or its server load under `c_up`)."""
    loads, _ = optimal_loads_mec_loop(edge, sizes, t)
    if "fixed_c" in kw:
        return loads, int(kw["fixed_c"])
    s_load, _ = optimal_loads_loop(server, np.array([kw["c_up"]]), t)
    return loads, int(s_load[0])


@settings(max_examples=8, deadline=None)
@given(n=st.integers(2, 8), ell=st.integers(8, 60),
       mode=st.sampled_from(["free", "fixed"]), seed=st.integers(0, 10**6))
def test_mec_planner_matches_oracle(n, ell, mode, seed):
    (je, js), (te, ts), sizes, kw = _problem(n, ell, mode, seed)

    def solve(eps_rel):
        ref = solve_codedfedl_reference(je, js, sizes, eps_rel=eps_rel, **kw)
        got = solve_redundancy_batched(
            [PlanRequest(te, ts, sizes, mec_comm=True, **kw)],
            eps_rel=eps_rel, device="cpu")[0]
        return ref, got

    ref, got = solve(1e-4)
    np.testing.assert_allclose(got.t_star, ref.t_star, rtol=1e-3)
    # Each solve stops somewhere within eps_rel above the true t*, so a
    # device whose best load switches inside that window gets one side
    # from each (n=8, ell=42, free, seed 530313): at eps_rel 1e-4 the
    # loads and c are the oracle's own rule at the port's t* ...
    loads, c = _mec_oracle_at(je, js, sizes, kw, got.t_star)
    np.testing.assert_array_equal(got.loads, loads)
    assert got.c == c
    # ... and with t* resolved to 1e-12 they are the oracle's whole solve
    ref_t, got_t = solve(1e-12)
    np.testing.assert_array_equal(got_t.loads, ref_t.loads)
    assert got_t.c == ref_t.c
    np.testing.assert_allclose(got_t.t_star, ref_t.t_star, rtol=1e-9)
    # the Eq.-17 weights see what the solve optimized
    np.testing.assert_array_equal(
        got.p_return[:-1], j_mec_total_cdf(je, got.loads, got.t_star))


def test_mixed_mec_batch_matches_solo():
    """Base, weighted and MEC requests in ONE call plan as they do alone
    (MEC requests group apart by the flag)."""
    (_, _), (te, ts), _, _ = _problem(6, 40, "free", 13)
    sizes = np.full(6, 40)
    reqs = [PlanRequest(te, ts, sizes, c_up=100),
            PlanRequest(te, ts, sizes, c_up=100, mec_comm=True),
            PlanRequest(te, ts, sizes, fixed_c=60, mec_comm=True),
            PlanRequest(te, ts, sizes, fixed_c=60, srv_weight=0.8)]
    batch = solve_redundancy_batched(reqs, device="cpu")
    for req, got in zip(reqs, batch):
        solo = solve_redundancy_batched([req], device="cpu")[0]
        assert got.t_star == solo.t_star and got.c == solo.c
        np.testing.assert_array_equal(got.loads, solo.loads)
        np.testing.assert_array_equal(got.p_return, solo.p_return)
    assert np.abs(batch[1].p_return - batch[0].p_return).max() > 0


@pytest.mark.parametrize("mode", ["free", "fixed"])
def test_p_return_is_mec_total_cdf(mode):
    (_, _), (te, ts), sizes, kw = _problem(8, 60, mode, 4242)
    plan = solve_redundancy_batched(
        [PlanRequest(te, ts, sizes, mec_comm=True, **kw)], device="cpu")[0]
    np.testing.assert_array_equal(
        plan.p_return[:-1], mec_total_cdf(te, plan.loads, plan.t_star))
    assert np.all(plan.loads <= sizes)
    assert plan.expected_agg >= sizes.sum() * (1.0 - 1e-9)


def test_solve_fleet_refuses_mec_comm():
    """The reference's solve_fleet plans a MEC request with the base
    model (ROADMAP R6); the port's refuses it, naming the objective."""
    (_, _), (te, ts), sizes, _ = _problem(5, 40, "free", 123)
    with pytest.raises(ValueError, match="mec_comm"):
        solve_fleet(PlanRequest(te, ts, sizes, mec_comm=True),
                    device="cpu")
    with pytest.raises(ValueError, match="mec_comm"):
        PlanRequest(te, ts, sizes, mec_comm=True, edge_chunks=2)


# ---------------------------------------------------------------------------
# the RFF map and the teacher
# ---------------------------------------------------------------------------

def test_rff_features_on_jax_weights_match_jax():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (40, D_RAW)))
    key = jax.random.PRNGKey(4)
    w = np.asarray(j_rff_weights(key, D_RAW, D_FEAT, 1.3))
    got = rff_features(torch.tensor(x), torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_rff_map(x, D_FEAT, key,
                                                         gamma=1.3)),
                               atol=5e-6)
    np.testing.assert_allclose(got, j_rff_map_reference(x, D_FEAT, key,
                                                        gamma=1.3),
                               atol=5e-6)


def test_rff_map_shape_norms_and_oracle():
    x = torch.randn((3, 5, D_RAW), generator=torch.Generator().manual_seed(0))
    z1 = rff_map(x, D_FEAT, 1, gamma=0.7)
    assert z1.shape == (3, 5, D_FEAT) and z1.dtype == torch.float32
    assert torch.equal(z1, rff_map(x, D_FEAT, 1, gamma=0.7))
    assert (z1 - rff_map(x, D_FEAT, 2, gamma=0.7)).abs().max() > 1e-3
    # unit diagonal: z(x).z(x) = (2/D) * sum(cos^2 + sin^2) = 1
    np.testing.assert_allclose(
        np.sum(z1.numpy().astype(np.float64) ** 2, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(
        z1.numpy(), rff_map_reference(x.numpy(), D_FEAT, 1, gamma=0.7),
        atol=5e-6)
    w = rff_weights(torch.Generator().manual_seed(1), D_RAW, D_FEAT, 0.7)
    assert torch.equal(z1, rff_features(x, w))


def test_rff_inner_products_approximate_gaussian_kernel():
    gamma = 0.5
    u, v = np.random.default_rng(5).standard_normal((2, 8, 4))
    zu = rff_map_reference(u, 4096, 6, gamma=gamma)
    zv = rff_map_reference(v, 4096, 6, gamma=gamma)
    exact = np.exp(-gamma * np.sum((u - v) ** 2, axis=-1))
    # error ~ 1/sqrt(d_feat); 0.05 is ~3 sigma at 4096 features
    np.testing.assert_allclose(np.sum(zu * zv, axis=-1), exact, atol=0.05)


def test_rff_map_validates_feature_count():
    x = torch.zeros((2, 3))
    for bad in (7, 0, 1):
        with pytest.raises(ValueError, match="even"):
            rff_map(x, bad, 0)
    with pytest.raises(ValueError, match="even"):
        CodedFedL(key=0, d_feat=9)


@pytest.mark.parametrize("n_classes,centers", [(2, 16), (2, 32), (10, 32)])
def test_teacher_labels_equal_jax_outside_near_ties(n_classes, centers):
    """The reference's own xs, centers and amplitudes through the port's
    labelling step; rows whose top-two scores are within 1e-5 of the
    score scale may flip under a float32 reordering and are excluded."""
    key = jax.random.PRNGKey(2)
    xs, labels = j_classification_dataset(key, N, ELL, D_RAW,
                                          n_classes=n_classes,
                                          centers=centers, gamma=2.0)
    k1, k2, k3 = jax.random.split(key, 3)
    j_xs = jax.random.normal(k1, (N, ELL, D_RAW), dtype=jnp.float32)
    zc = np.asarray(jax.random.normal(k2, (centers, D_RAW), jnp.float32))
    amp = np.asarray(jax.random.normal(k3, (n_classes, centers),
                                       jnp.float32))
    np.testing.assert_array_equal(np.asarray(j_xs), np.asarray(xs))
    x64 = np.asarray(xs, np.float64)
    sq = (np.sum(x64 ** 2, -1, keepdims=True) - 2.0 * x64 @ zc.T
          + np.sum(zc.astype(np.float64) ** 2, -1))
    scores = np.exp(-2.0 * sq / D_RAW) @ amp.T.astype(np.float64)
    top2 = np.sort(scores, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < 1e-5 * np.abs(scores).max()
    got = teacher_labels(torch.tensor(np.asarray(xs)), torch.tensor(zc),
                         torch.tensor(amp), gamma=2.0)
    assert got.dtype == torch.int32
    print(f"\nnear-tie rows excluded: {int(tie.sum())} of {tie.size}")
    np.testing.assert_array_equal(got.numpy()[~tie],
                                  np.asarray(labels)[~tie])
    np.testing.assert_array_equal(
        one_vs_rest_targets(got, 1).numpy()[~tie],
        np.asarray(j_one_vs_rest_targets(labels, 1))[~tie])


def test_classification_dataset_draws_and_labels():
    gen = torch.Generator().manual_seed(2)
    xs, labels = classification_dataset(gen, 4, 30, D_RAW, n_classes=3,
                                        centers=8, gamma=2.0)
    assert xs.shape == (4, 30, D_RAW) and labels.shape == (4, 30)
    gen = torch.Generator().manual_seed(2)
    xs2 = torch.randn((4, 30, D_RAW), generator=gen)
    zc = torch.randn((8, D_RAW), generator=gen)
    amp = torch.randn((3, 8), generator=gen)
    assert torch.equal(xs, xs2)
    assert torch.equal(labels, teacher_labels(xs2, zc, amp, 2.0))
    assert set(labels.unique().tolist()) <= {0, 1, 2}
    t = one_vs_rest_targets(labels, 1)
    assert t.dtype == torch.float32 and set(t.unique().tolist()) <= {-1, 1}
    with pytest.raises(ValueError, match="n_classes"):
        classification_dataset(gen, 2, 3, 4, n_classes=1)


# ---------------------------------------------------------------------------
# the strategy against the reference
# ---------------------------------------------------------------------------

def mec_oracle_plan(jf, n, ell, fixed_c):
    """The NumPy oracle's CodedFedL plan with its edge `p_return` replaced
    by `mec_total_cdf` at its loads and t*, the probabilities the real
    main path gives the Eq.-17 weights."""
    plan = solve_codedfedl_reference(jf.edge, jf.server, np.full(n, ell),
                                     fixed_c=fixed_c)
    p_edge = j_mec_total_cdf(jf.edge, plan.loads, plan.t_star)
    return dataclasses.replace(
        plan, p_return=np.append(p_edge, plan.p_return[-1]))


@pytest.fixture(scope="module")
def kernel_pair():
    """The JAX fixture of tests/test_nonlinear.py in both packages: the
    fleets, the teacher's data, the reference's features and reference
    head, and the oracle's MEC plan (its p_return from mec_total_cdf)."""
    jf = j_wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=N, d=D_FEAT)
    tf = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=N, d=D_FEAT)
    xs, labels = j_classification_dataset(jax.random.PRNGKey(2), N, ELL,
                                          D_RAW, n_classes=2, centers=16,
                                          gamma=2.0)
    ys = j_one_vs_rest_targets(labels, 1)
    probe = j_api.make_strategy("codedfedl", key_seed=KEY_SEED,
                                d_feat=D_FEAT, rff_gamma=GAMMA,
                                fixed_c=FIXED_C)
    phi = np.asarray(probe.features(j_api.TrainData(
        xs=xs, ys=ys, beta_true=jnp.zeros(D_FEAT))))
    beta_ref, *_ = np.linalg.lstsq(phi.reshape(-1, D_FEAT).astype(np.float64),
                                   np.asarray(ys, np.float64).ravel(),
                                   rcond=None)
    beta_ref = beta_ref.astype(np.float32)
    plan = mec_oracle_plan(jf, N, ELL, FIXED_C)
    jdata = j_api.TrainData(xs, ys, jnp.asarray(beta_ref))
    tdata = interop.train_data(np.asarray(xs), np.asarray(ys), beta_ref,
                               device="cpu")
    return {"jf": jf, "tf": tf, "jdata": jdata, "tdata": tdata, "phi": phi,
            "plan": plan}


def cfedl_pair(kp, grad_path="fused"):
    """(jax strategy, jax state, port strategy, port state) on the
    oracle's MEC plan; the port state carries the reference's features
    and parity."""
    plan = kp["plan"]
    j_s = j_api.make_strategy("codedfedl", key_seed=KEY_SEED, d_feat=D_FEAT,
                              rff_gamma=GAMMA, fixed_c=FIXED_C,
                              redundancy_plan=plan, grad_path=grad_path)
    jstate = j_s.plan_with(kp["jf"], kp["jdata"], plan)
    tplan = port_plan(plan)
    t_s = t_api.make_strategy("codedfedl", key_seed=KEY_SEED, d_feat=D_FEAT,
                              rff_gamma=GAMMA, fixed_c=FIXED_C,
                              redundancy_plan=tplan, grad_path=grad_path)
    tstate = interop.codedfedl_state(
        tplan, np.asarray(jstate.load_mask), np.asarray(jstate.x_parity),
        np.asarray(jstate.y_parity), kp["tf"].edge, kp["tf"].server,
        np.asarray(jstate.features), device="cpu")
    return j_s, jstate, t_s, tstate


def test_fleets_and_feature_fold_match(kernel_pair):
    kp = kernel_pair
    for f in ("a", "mu", "tau", "p"):
        np.testing.assert_array_equal(getattr(kp["tf"].edge, f),
                                      getattr(kp["jf"].edge, f))
    assert J_RFF_FOLD == 0x52FF
    # the reference's feature map is rff_map at fold_in(key, 0x52FF)
    want = j_rff_map(kp["jdata"].xs, D_FEAT,
                     jax.random.fold_in(jax.random.PRNGKey(KEY_SEED),
                                        J_RFF_FOLD), gamma=GAMMA)
    np.testing.assert_array_equal(kp["phi"], np.asarray(want))


def test_codedfedl_plan_and_schedules_bit_equal(kernel_pair):
    """The port's own plan_with on the oracle's MEC plan: the load mask
    and the Eq.-17 weights from the plan's MEC probabilities; the parity
    exactly the encode of its own features; its features the map at
    rff_seed(key); schedules bit-equal to the reference's MEC draws."""
    kp = kernel_pair
    j_s, jstate, t_s, tstate = cfedl_pair(kp)
    own = t_s.plan_with(kp["tf"], kp["tdata"], tstate.plan)
    np.testing.assert_array_equal(own.load_mask.numpy(),
                                  np.asarray(jstate.load_mask))
    assert own.features.shape == (N, ELL, D_FEAT)
    assert torch.equal(own.features,
                       rff_map(kp["tdata"].xs, D_FEAT, rff_seed(KEY_SEED),
                               gamma=GAMMA))
    w = torch.tensor(np.stack(systematic_weights(tstate.plan,
                                                 np.full(N, ELL))))
    x_par, y_par = encoding.encode_fleet(
        torch.Generator().manual_seed(KEY_SEED), own.features,
        kp["tdata"].ys, w.to(torch.float32), FIXED_C)
    assert torch.equal(own.x_parity, x_par)
    assert torch.equal(own.y_parity, y_par)
    assert t_s.report_extras(own) == j_s.report_extras(jstate)
    want = j_s.sample_epochs(jstate, kp["jf"], 40, np.random.default_rng(5))
    got = t_s.sample_epochs(tstate, kp["tf"], 40, np.random.default_rng(5))
    for k in want.arrivals:
        np.testing.assert_array_equal(got.arrivals[k], want.arrivals[k])
        assert got.arrivals[k].dtype == want.arrivals[k].dtype
    np.testing.assert_array_equal(got.durations, want.durations)
    assert (got.setup_time, got.t0) == (want.setup_time, want.t0)
    # an explicit rff_key seeds the map directly
    other = dataclasses.replace(t_s, rff_key=11)
    assert torch.equal(other.features(kp["tdata"]),
                       rff_map(kp["tdata"].xs, D_FEAT, 11, gamma=GAMMA))


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
def test_codedfedl_matches_reference(kernel_pair, grad_path):
    kp = kernel_pair
    j_s, jstate, t_s, tstate = cfedl_pair(kp, grad_path)
    want = _jax_run(j_s, jstate, kp["jdata"], kp["jf"], KEY_SEED)
    got = t_api.Session(t_s, kp["tf"], LR, EPOCHS, device="cpu").run(
        kp["tdata"], rng=np.random.default_rng(KEY_SEED), state=tstate)
    _assert_same_run(got, want)
    assert got.nmse[-1] < got.nmse[0]
    assert got.extras == j_s.report_extras(jstate)
    assert got.extras["mec_comm"] == 1.0 and got.extras["d_feat"] == D_FEAT
    assert got.uplink_bits_total == j_s.uplink_bits(jstate, kp["jf"],
                                                    EPOCHS)
    if grad_path == "fused":
        layout = t_s.device_state(tstate, kp["tdata"])
        assert ("sys_x" in layout) == \
            ("sys_x" in j_s.device_state(jstate, kp["jdata"]))


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
def test_codedfedl_hierarchical_matches_reference(kernel_pair, grad_path):
    kp = kernel_pair
    j_b, jbs, t_b, tbs = cfedl_pair(kp, grad_path)
    j_topo = j_fleet.FleetTopology.uniform(N, 3)
    t_topo = FleetTopology.uniform(N, 3)
    j_h = j_fleet.HierarchicalCFL(j_b, j_topo)
    want = _jax_run(j_h, j_fleet.HierState(base=jbs, topology=j_topo),
                    kp["jdata"], kp["jf"], KEY_SEED)
    got = t_api.Session(HierarchicalCFL(t_b, t_topo), kp["tf"], LR, EPOCHS,
                        device="cpu").run(
        kp["tdata"], rng=np.random.default_rng(KEY_SEED),
        state=HierState(tbs, t_topo))
    _assert_same_run(got, want)


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
def test_codedfedl_single_tier_is_bit_equal_to_flat(kernel_pair, grad_path):
    _, _, t_s, tstate = cfedl_pair(kernel_pair, grad_path)
    tf, tdata = kernel_pair["tf"], kernel_pair["tdata"]
    topo = FleetTopology.uniform(N, 1)
    flat = t_api.Session(t_s, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(3), state=tstate)
    hier = t_api.Session(HierarchicalCFL(t_s, topo), tf, LR, EPOCHS,
                         device="cpu").run(
        tdata, rng=np.random.default_rng(3), state=HierState(tstate, topo))
    np.testing.assert_array_equal(hier.nmse, flat.nmse)
    np.testing.assert_array_equal(hier.times, flat.times)


# ---------------------------------------------------------------------------
# the port's own path
# ---------------------------------------------------------------------------

def test_identity_map_is_codedfl():
    """d_feat=None: identity features and the base delay model — the
    same plan, parity (`torch.equal`), trace and clocks as `CodedFL`
    from the same key (`tests/test_nonlinear.py`'s linreg fixture)."""
    fleet = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=N, d=40)
    data = t_api.TrainData.linreg(0, n=N, ell=ELL, d=40, device="cpu")
    c = int(0.3 * data.m)
    cfl = t_api.make_strategy("cfl", key_seed=5, fixed_c=c)
    cfedl = CodedFedL(key=5, fixed_c=c)
    st_c, st_f = cfl.plan(fleet, data), cfedl.plan(fleet, data)
    assert st_c.plan.t_star == st_f.plan.t_star
    np.testing.assert_array_equal(st_c.plan.loads, st_f.plan.loads)
    np.testing.assert_array_equal(st_c.plan.p_return, st_f.plan.p_return)
    assert torch.equal(st_c.x_parity, st_f.x_parity)
    assert torch.equal(st_c.y_parity, st_f.y_parity)
    assert st_f.features is data.xs
    r_c = t_api.Session(cfl, fleet, 0.05, 80, device="cpu").run(
        data, rng=np.random.default_rng(3), state=st_c)
    r_f = t_api.Session(cfedl, fleet, 0.05, 80, device="cpu").run(
        data, rng=np.random.default_rng(3), state=st_f)
    np.testing.assert_array_equal(r_f.nmse, r_c.nmse)
    np.testing.assert_array_equal(r_f.times, r_c.times)
    np.testing.assert_array_equal(r_f.epoch_durations, r_c.epoch_durations)
    assert r_f.setup_time == r_c.setup_time
    assert r_f.extras["mec_comm"] == 0.0


def test_port_plans_and_trains_on_its_own():
    """The port's own data, feature map, MEC plan, encode and both
    gradient paths, end to end at the JAX fixture's size."""
    fleet = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=N, d=D_FEAT)
    xs, labels = classification_dataset(torch.Generator().manual_seed(2), N,
                                        ELL, D_RAW, n_classes=2, centers=16,
                                        gamma=2.0)
    ys = one_vs_rest_targets(labels, 1)
    strat = CodedFedL(key=KEY_SEED, d_feat=D_FEAT, rff_gamma=GAMMA,
                      fixed_c=FIXED_C)
    phi = strat.features(t_api.TrainData(xs, ys, torch.zeros(D_FEAT)))
    beta_ref, *_ = np.linalg.lstsq(
        phi.numpy().reshape(-1, D_FEAT).astype(np.float64),
        ys.numpy().astype(np.float64).ravel(), rcond=None)
    data = t_api.TrainData(xs, ys, torch.tensor(beta_ref, dtype=torch.float32))
    state = strat.plan(fleet, data)
    plan = state.plan
    assert plan.c == FIXED_C and np.all(plan.loads <= ELL)
    np.testing.assert_array_equal(
        plan.p_return[:-1], mec_total_cdf(fleet.edge, plan.loads,
                                          plan.t_star))
    reps = {}
    for gp in ("fused", "reference"):
        s = dataclasses.replace(strat, grad_path=gp)
        reps[gp] = t_api.Session(s, fleet, LR, EPOCHS, device="cpu").run(
            data, rng=np.random.default_rng(0), state=state)
    np.testing.assert_array_equal(reps["fused"].times, reps["reference"].times)
    np.testing.assert_allclose(reps["fused"].nmse, reps["reference"].nmse,
                               rtol=1e-4)
    rep = reps["fused"]
    assert np.all(np.isfinite(rep.nmse)) and rep.final_nmse() < rep.nmse[0]
    acc = np.mean((phi.numpy().reshape(-1, D_FEAT) @ rep.beta > 0)
                  == (ys.numpy().ravel() > 0))
    assert acc > 0.6
