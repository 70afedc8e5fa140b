"""The port's privacy accounting (`repro_torch.privacy`,
`plan.srv_weight_for_epsilon`, `StochasticCodedFL(epsilon_target=...)`,
`TraceReport.privacy_budget`) against the reference's float64 NumPy
oracle `repro.privacy.reference`, on the CPU.

The JAX accountant and calibration run under a scoped x64 this JAX no
longer has (ROADMAP "Reference state", R1); the oracle runs unpatched.
Inputs are drawn from NumPy seeds.

Bounds (the reference's own, `tests/test_privacy.py`):
  * epsilon against `epsilon_spent_reference`: 1e-6 relative; at
    sample_frac = 1 the per-round RDP equals the Gaussian closed form
    alpha / (2 sigma^2) within 1e-6 relative;
  * monotone in rounds and in 1/noise, and subsampling only lowers
    epsilon (1e-12 slack);
  * calibration: the oracle's epsilon at the calibrated sigma within 1e-3
    relative of the target and never above it (1e-3 slack); batched
    targets bit-equal to solo ones; infeasible targets raise;
  * the strategy's extras: the reference's schema; the schedule equal to
    the oracle's epsilon after the first, a third, half and the last
    round within 1e-6 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.privacy.reference import (epsilon_spent_reference,
                                     gaussian_rdp_closed_form,
                                     rdp_sgm_reference)
from repro_torch import api as t_api
from repro_torch.plan import effective_srv_weight, srv_weight_for_epsilon
from repro_torch.privacy import (DEFAULT_ORDERS, calibrate_noise,
                                 epsilon_schedule, epsilon_spent)
from repro_torch.privacy import accountant
from repro_torch.schemes import StochasticCodedFL
from repro_torch.sim.network import wireless_fleet

CPU = "cpu"


def _draws(seed, k, **ranges):
    """k points of a seeded uniform draw over each named range; integer
    ranges are drawn as integers."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        point = {}
        for name, (lo, hi) in ranges.items():
            point[name] = int(rng.integers(lo, hi + 1)) \
                if isinstance(lo, int) else float(rng.uniform(lo, hi))
        out.append(point)
    return out


# ---------------------------------------------------------------------------
# the accountant against the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pt", _draws(0, 12, sigma=(0.3, 8.0),
                                      q=(0.02, 1.0), rounds=(1, 2000),
                                      dexp=(3, 8)))
def test_accountant_matches_reference(pt):
    delta = 10.0 ** -pt["dexp"]
    got = epsilon_spent(pt["sigma"], pt["q"], pt["rounds"], delta,
                        device=CPU)
    want = epsilon_spent_reference(pt["sigma"], pt["q"], pt["rounds"],
                                   delta)
    assert abs(got - want) <= 1e-6 * max(want, 1e-12)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.3, 4.0])
def test_rdp_at_q1_is_the_gaussian_closed_form(sigma):
    """q = 1 collapses the binomial sum to alpha / (2 sigma^2); the
    port's RDP equals the closed form and the oracle's curve."""
    got = accountant._rdp_all_orders(
        torch.tensor(sigma, dtype=torch.float64),
        torch.tensor(1.0, dtype=torch.float64)).numpy()
    closed = gaussian_rdp_closed_form(sigma, DEFAULT_ORDERS)
    np.testing.assert_allclose(got, closed, rtol=1e-6)
    np.testing.assert_allclose(got, rdp_sgm_reference(sigma, 1.0),
                               rtol=1e-6)
    assert np.all(np.isfinite(got))


def test_rdp_rows_with_minus_inf_terms_stay_finite():
    """`_LOG_BINOM` marks k > alpha with -inf; the logsumexp over rows
    that mix -inf with finite terms must not turn into NaN, at q < 1 and
    at q = 1 (where log(1 - q) = -inf as well)."""
    sig = torch.tensor([0.3, 1.0, 7.0], dtype=torch.float64)
    for q in (0.01, 0.5, 0.999, 1.0):
        rdp = accountant._rdp_all_orders(
            sig, torch.full((3,), q, dtype=torch.float64))
        assert rdp.shape == (3, DEFAULT_ORDERS.size)
        assert bool(torch.isfinite(rdp).all())
    assert np.isneginf(accountant._LOG_BINOM).sum() == \
        sum(64 - a for a in range(2, 65))


def test_zero_noise_is_infinite_epsilon():
    assert np.isinf(epsilon_spent(0.0, 1.0, 10, 1e-5, device=CPU))
    assert np.all(np.isinf(epsilon_schedule(0.0, 0.5, 7, 1e-5, device=CPU)))


def test_epsilon_spent_broadcasts():
    sigmas = np.array([0.8, 1.6, 3.2])
    out = epsilon_spent(sigmas, 0.9, 200, 1e-5, device=CPU)
    assert out.shape == (3,)
    for s, e in zip(sigmas, out):
        assert e == epsilon_spent(float(s), 0.9, 200, 1e-5, device=CPU)
        assert abs(e - epsilon_spent_reference(float(s), 0.9, 200, 1e-5)) \
            <= 1e-6 * e


@pytest.mark.parametrize("sigma,q,rounds,delta", [
    (1.1, 0.8, 600, 1e-5), (0.45, 0.05, 37, 1e-3), (6.0, 1.0, 1, 1e-8)])
def test_schedule_is_the_oracle_round_by_round(sigma, q, rounds, delta):
    sched = epsilon_schedule(sigma, q, rounds, delta, device=CPU)
    assert sched.shape == (rounds,) and sched.dtype == np.float64
    picks = sorted({0, rounds // 3, rounds // 2, rounds - 1})
    for t in picks:
        want = epsilon_spent_reference(sigma, q, t + 1, delta)
        assert abs(sched[t] - want) <= 1e-6 * max(want, 1e-12)
    assert sched[-1] == epsilon_spent(sigma, q, rounds, delta, device=CPU)


# ---------------------------------------------------------------------------
# DP structure: monotonicity and subsampling amplification
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pt", _draws(1, 8, sigma=(0.4, 6.0), q=(0.05, 1.0),
                                      t1=(1, 500), extra=(1, 500)))
def test_epsilon_monotone_in_rounds(pt):
    e1 = epsilon_spent(pt["sigma"], pt["q"], pt["t1"], 1e-5, device=CPU)
    e2 = epsilon_spent(pt["sigma"], pt["q"], pt["t1"] + pt["extra"], 1e-5,
                       device=CPU)
    assert e2 >= e1 - 1e-12
    sched = epsilon_schedule(pt["sigma"], pt["q"], 20, 1e-5, device=CPU)
    assert np.all(np.diff(sched) >= -1e-12)


@pytest.mark.parametrize("pt", _draws(2, 8, sigma=(0.4, 6.0), q=(0.05, 1.0),
                                      factor=(1.05, 4.0), rounds=(1, 500)))
def test_epsilon_monotone_in_inverse_noise(pt):
    """More noise can only shrink the budget spent."""
    e_lo = epsilon_spent(pt["sigma"] * pt["factor"], pt["q"], pt["rounds"],
                         1e-5, device=CPU)
    e_hi = epsilon_spent(pt["sigma"], pt["q"], pt["rounds"], 1e-5,
                         device=CPU)
    assert e_lo <= e_hi + 1e-12


@pytest.mark.parametrize("pt", _draws(3, 8, sigma=(0.4, 6.0),
                                      q=(0.02, 0.999), rounds=(1, 500)))
def test_subsampling_amplification(pt):
    """epsilon(rho < 1) <= epsilon(rho = 1)."""
    assert epsilon_spent(pt["sigma"], pt["q"], pt["rounds"], 1e-5,
                         device=CPU) \
        <= epsilon_spent(pt["sigma"], 1.0, pt["rounds"], 1e-5,
                         device=CPU) + 1e-12


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pt", _draws(4, 8, target=(0.2, 30.0),
                                      q=(0.05, 1.0), rounds=(1, 1000)))
def test_calibration_roundtrip_vs_oracle(pt):
    """calibrate_noise, then the ORACLE's epsilon_spent: within 1e-3
    relative of the target, never over it; the port's own accountant
    never over it at all (the bracket's feasible end)."""
    sigma = calibrate_noise(pt["target"], delta=1e-5, rounds=pt["rounds"],
                            sample_frac=pt["q"], device=CPU)
    back = epsilon_spent_reference(sigma, pt["q"], pt["rounds"], 1e-5)
    assert back <= pt["target"] * (1.0 + 1e-3)
    assert abs(back - pt["target"]) <= 1e-3 * pt["target"]
    assert epsilon_spent(sigma, pt["q"], pt["rounds"], 1e-5,
                         device=CPU) <= pt["target"]


def test_calibration_batched_matches_solo():
    targets = np.array([0.5, 1.0, 2.0, 8.0, 32.0])
    batch = calibrate_noise(targets, delta=1e-5, rounds=300,
                            sample_frac=0.8, device=CPU)
    solo = [calibrate_noise(float(t), delta=1e-5, rounds=300,
                            sample_frac=0.8, device=CPU) for t in targets]
    np.testing.assert_array_equal(batch, np.array(solo))
    # broadcast over mixed budgets: each entry is its solo solve
    grid = calibrate_noise(np.array([[1.0], [4.0]]),
                           delta=np.array([1e-5, 1e-6]), rounds=50,
                           sample_frac=np.array([0.5, 1.0]), device=CPU)
    assert grid.shape == (2, 2)
    assert grid[1, 0] == calibrate_noise(4.0, delta=1e-5, rounds=50,
                                         sample_frac=0.5, device=CPU)


def test_calibration_infeasible_target_raises():
    with pytest.raises(RuntimeError, match="achievable floor"):
        calibrate_noise(1e-5, delta=1e-5, rounds=10, device=CPU)


def test_calibration_input_validation():
    with pytest.raises(ValueError):
        calibrate_noise(-1.0, delta=1e-5, rounds=10, device=CPU)
    with pytest.raises(ValueError):
        calibrate_noise(1.0, delta=2.0, rounds=10, device=CPU)
    with pytest.raises(ValueError):
        calibrate_noise(1.0, delta=1e-5, rounds=0, device=CPU)
    with pytest.raises(ValueError):
        epsilon_spent(1.0, sample_frac=0.0, rounds=10, device=CPU)
    with pytest.raises(ValueError):
        epsilon_spent(-1.0, rounds=10, device=CPU)


def test_srv_weight_for_epsilon_matches_calibration():
    targets = np.array([1.0, 4.0, 16.0])
    w = srv_weight_for_epsilon(targets, delta=1e-5, rounds=200,
                               sample_frac=0.8, device=CPU)
    sigma = calibrate_noise(targets, delta=1e-5, rounds=200,
                            sample_frac=0.8, device=CPU)
    np.testing.assert_array_equal(w, effective_srv_weight(sigma, 0.8))
    np.testing.assert_allclose(w, 0.8 / (1.0 + sigma ** 2), rtol=1e-12)
    assert srv_weight_for_epsilon(4.0, rounds=200, sample_frac=0.8,
                                  device=CPU) \
        == float(effective_srv_weight(
            calibrate_noise(4.0, rounds=200, sample_frac=0.8, device=CPU),
            0.8))


# ---------------------------------------------------------------------------
# StochasticCodedFL with a budget
# ---------------------------------------------------------------------------

def test_epsilon_target_construction_calibrates():
    strat = StochasticCodedFL(key=1, fixed_c=100, epsilon_target=4.0,
                              delta=1e-5, rounds=50, sample_frac=0.8,
                              device=CPU)
    sigma = calibrate_noise(4.0, delta=1e-5, rounds=50, sample_frac=0.8,
                            device=CPU)
    assert strat.noise_multiplier == sigma
    assert strat.srv_weight == float(effective_srv_weight(sigma, 0.8))
    back = epsilon_spent_reference(sigma, 0.8, 50, 1e-5)
    assert abs(back - 4.0) <= 4e-3


def test_epsilon_target_strategy_survives_replace():
    """dataclasses.replace re-runs __post_init__ with both epsilon_target
    and the calibrated noise set; that must not be a conflict."""
    s = StochasticCodedFL(key=1, fixed_c=100, epsilon_target=4.0, rounds=50,
                          sample_frac=0.8, device=CPU)
    s2 = dataclasses.replace(s, label="renamed")
    assert s2.noise_multiplier == s.noise_multiplier
    with pytest.raises(ValueError, match="noise_multiplier=None"):
        dataclasses.replace(s, rounds=100)
    s3 = dataclasses.replace(s, rounds=100, noise_multiplier=None)
    assert s3.noise_multiplier == calibrate_noise(
        4.0, delta=1e-5, rounds=100, sample_frac=0.8, device=CPU)


def test_epsilon_target_validation():
    with pytest.raises(ValueError, match="not both"):
        StochasticCodedFL(key=0, epsilon_target=1.0, rounds=10,
                          noise_multiplier=0.5, device=CPU)
    with pytest.raises(ValueError, match="rounds"):
        StochasticCodedFL(key=0, epsilon_target=1.0)
    for kw in ({"delta": 0.0}, {"delta": 1.0}, {"rounds": 0}):
        with pytest.raises(ValueError):
            StochasticCodedFL(key=0, **kw)
    assert StochasticCodedFL(key=0).noise_multiplier == 0.5


@pytest.fixture(scope="module")
def small():
    fleet = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=12, d=40)
    data = t_api.TrainData.linreg(0, n=12, ell=60, d=40, device=CPU)
    return fleet, data


def test_epsilon_target_trains_and_reports(small):
    """Construct by budget through the registry, train, and read the
    reference's extras schema and the budget off the report."""
    fleet, data = small
    epochs = 30
    strat = t_api.make_strategy(
        "stochastic", key_seed=7, fixed_c=int(0.3 * data.m),
        epsilon_target=8.0, delta=1e-5, rounds=epochs, sample_frac=0.8,
        include_upload_delay=False, device=CPU)
    rep = t_api.Session(strat, fleet, 0.05, epochs, device=CPU).run(
        data, rng=np.random.default_rng(0))
    assert np.all(np.isfinite(rep.nmse))
    assert rep.final_nmse() < rep.nmse[0]
    assert set(rep.extras) == {
        "noise_multiplier", "sample_frac", "srv_weight", "noise_scale_x",
        "noise_scale_y", "delta", "accounting_rounds", "epsilon_schedule",
        "epsilon_spent", "epsilon_target"}
    eps, delta = rep.privacy_budget()
    assert delta == 1e-5 and eps <= 8.0
    assert abs(epsilon_spent_reference(strat.noise_multiplier, 0.8, epochs,
                                       1e-5) - 8.0) <= 8e-3
    assert rep.extras["epsilon_target"] == 8.0
    sched = rep.extras["epsilon_schedule"]
    assert sched.shape == (epochs,)
    assert np.all(np.diff(sched) >= 0.0) and sched[-1] == eps
    assert rep.extras["accounting_rounds"] == epochs
    assert rep.extras["noise_multiplier"] == strat.noise_multiplier


def test_manual_noise_with_horizon_reports_spend(small):
    """rounds= alone prices a manually chosen noise level."""
    fleet, data = small
    strat = StochasticCodedFL(key=3, fixed_c=int(0.3 * data.m),
                              noise_multiplier=1.5, sample_frac=0.5,
                              rounds=20, include_upload_delay=False,
                              device=CPU)
    rep = t_api.Session(strat, fleet, 0.05, 20, device=CPU).run(
        data, rng=np.random.default_rng(0))
    eps, _ = rep.privacy_budget()
    want = epsilon_spent_reference(1.5, 0.5, 20, 1e-5)
    assert abs(eps - want) <= 1e-6 * want
    assert "epsilon_target" not in rep.extras


def test_no_horizon_reports_no_budget(small):
    fleet, data = small
    strat = StochasticCodedFL(key=3, fixed_c=int(0.3 * data.m),
                              noise_multiplier=0.5,
                              include_upload_delay=False)
    rep = t_api.Session(strat, fleet, 0.05, 5, device=CPU).run(
        data, rng=np.random.default_rng(0))
    assert rep.privacy_budget() is None
    assert "epsilon_spent" not in rep.extras
