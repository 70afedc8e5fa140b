"""Parity of the port's host-side NumPy layer with the JAX package.

`repro_torch.core.delay_model`, `core.returns`, `core.redundancy`
(`systematic_weights`), `sim.network` and `api.report` are NumPy copies of
their `repro` counterparts, so every comparison here is bit-for-bit
(`assert_array_equal`, `==`) on the same inputs and the same
`np.random.default_rng` seeds — there is no tolerance to state.
"""
import numpy as np
import pytest

from repro.api import report as j_report
from repro.core import delay_model as j_dm
from repro.core import redundancy as j_red
from repro.core import returns as j_ret
from repro.sim import network as j_net
from repro_torch import interop
from repro_torch.api import report as t_report
from repro_torch.core import delay_model as t_dm
from repro_torch.core import redundancy as t_red
from repro_torch.core import returns as t_ret
from repro_torch.sim import network as t_net


def _params(mod, seed, n=7, server=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(1e-3, 5e-2, n)
    mu = (2.0 / a) * rng.uniform(0.5, 2.0, n)
    tau = np.zeros(n) if server else rng.uniform(1e-3, 5e-2, n)
    p = np.zeros(n) if server else rng.uniform(0.0, 0.3, n)
    return mod.DeviceDelayParams(a, mu, tau, p)


FLEET_FIELDS = ("mac_rates", "link_rates", "packet_bits", "d", "nu_comp",
                "nu_link")


def _assert_fleets_equal(jf, tf):
    for side in ("edge", "server"):
        for f in ("a", "mu", "tau", "p"):
            np.testing.assert_array_equal(getattr(getattr(tf, side), f),
                                          getattr(getattr(jf, side), f))
    for f in FLEET_FIELDS:
        np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f))


@pytest.mark.parametrize("nu_comp,nu_link,seed", [(0.2, 0.2, 0),
                                                  (0.0, 0.5, 3),
                                                  (0.4, 0.1, 11)])
def test_paper_fleet_bit_equal(nu_comp, nu_link, seed):
    _assert_fleets_equal(j_net.paper_fleet(nu_comp, nu_link, seed=seed),
                         t_net.paper_fleet(nu_comp, nu_link, seed=seed))


def test_make_fleet_bit_equal_with_array_erasure():
    p = np.linspace(0.05, 0.3, 6)
    kw = dict(n=6, d=40, nu_comp=0.3, nu_link=0.25, erasure_p=p,
              server_speedup=4.0)
    _assert_fleets_equal(
        j_net.make_fleet(rng=np.random.default_rng(9), **kw),
        t_net.make_fleet(rng=np.random.default_rng(9), **kw))


@pytest.mark.parametrize("ell_shape", ["scalar", "vector", "grid"])
@pytest.mark.parametrize("t", [0.0, 0.05, 0.4, 3.0])
def test_total_and_compute_cdf_bit_equal(ell_shape, t):
    jp, tp = _params(j_dm, 1), _params(t_dm, 1)
    ell = {"scalar": 17.0,
           "vector": np.arange(7) * 5.0,
           "grid": np.arange(30, dtype=np.float64)[:, None]}[ell_shape]
    np.testing.assert_array_equal(t_dm.total_cdf(tp, ell, t),
                                  j_dm.total_cdf(jp, ell, t))
    np.testing.assert_array_equal(t_dm.compute_cdf(tp, ell, t),
                                  j_dm.compute_cdf(jp, ell, t))
    np.testing.assert_array_equal(tp.mean_total(np.arange(7) * 3.0),
                                  jp.mean_total(np.arange(7) * 3.0))


def test_total_cdf_server_bit_equal():
    jp, tp = _params(j_dm, 2, n=1, server=True), \
        _params(t_dm, 2, n=1, server=True)
    for t in (0.0, 0.01, 1.0):
        np.testing.assert_array_equal(t_dm.total_cdf(tp, [40.0], t),
                                      j_dm.total_cdf(jp, [40.0], t))


@pytest.mark.parametrize("size", [None, 5])
def test_sample_total_bit_equal(size):
    jp, tp = _params(j_dm, 4), _params(t_dm, 4)
    loads = np.array([0, 3, 10, 20, 0, 7, 30])
    got = t_dm.sample_total(tp, loads, np.random.default_rng(123), size=size)
    want = j_dm.sample_total(jp, loads, np.random.default_rng(123), size=size)
    np.testing.assert_array_equal(got, want)


def test_optimal_loads_bit_equal():
    jp, tp = _params(j_dm, 5), _params(t_dm, 5)
    caps = np.array([10, 40, 25, 60, 5, 33, 48])
    for t in (0.2, 1.0, 2.5):
        got = t_ret.optimal_loads(tp, caps, t, chunk=16)
        want = j_ret.optimal_loads(jp, caps, t, chunk=16)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_systematic_weights_bit_equal():
    loads = np.array([30, 0, 12, 30, 7])
    p_return = np.array([0.9, 0.0, 0.999999, 1.0, 0.3, 0.5])
    fields = dict(loads=loads, c=9, t_star=1.25, p_return=p_return,
                  expected_agg=100.0, loads_cap_total=150)
    sizes = np.full(5, 30)
    want = j_red.systematic_weights(j_red.RedundancyPlan(**fields), sizes)
    got = t_red.systematic_weights(interop.redundancy_plan(**fields), sizes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert interop.redundancy_plan(**fields).delta == \
        j_red.RedundancyPlan(**fields).delta


def test_report_functions_match():
    """TraceReport, convergence_time and coding_gain on the same traces."""
    traces = {}
    for mod in (j_report, t_report):
        r = np.random.default_rng(7)
        out = []
        for scale in (1.0, 0.25):
            nmse = np.exp(-scale * np.arange(41) / 4.0)
            durations = r.uniform(1.0, 3.0, 40) / scale
            times = 2.0 + np.concatenate([[0.0], np.cumsum(durations)])
            out.append(mod.TraceReport(times=times, nmse=nmse,
                                       epoch_durations=durations,
                                       label=f"s{scale}"))
        traces[mod] = out
    (ju, jc), (tu, tc) = traces[j_report], traces[t_report]
    for target in (0.5, 1e-2, 1e-9):
        assert t_report.convergence_time(tu, target) == \
            j_report.convergence_time(ju, target)
        gain_t = t_report.coding_gain(tu, tc, target)
        gain_j = j_report.coding_gain(ju, jc, target)
        assert gain_t == gain_j or (np.isnan(gain_t) and np.isnan(gain_j))
        assert tu.epochs_to(target) == ju.epochs_to(target)
    assert tc.final_nmse() == jc.final_nmse() and tc.epochs == jc.epochs
