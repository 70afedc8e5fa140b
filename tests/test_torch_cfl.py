"""Parity of the port's CFL state (`repro_torch.core.cfl`) with
`repro.core.cfl`: packing, both fused layouts, the reference-path
operands, the Gram factors and the upload accounting.

Index and layout facts are compared exactly.  The Gram factors are
float32 products of the same parity rows summed in another order:
rtol 1e-5 (about 100 float32 ulps) with atol 1e-5 * max|G|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import TrainData as JTrainData
from repro.core import cfl as j_cfl
from repro.core.redundancy import RedundancyPlan as JPlan
from repro.sim.network import make_fleet as j_make_fleet
from repro_torch import interop
from repro_torch.core import cfl as t_cfl
from repro_torch.sim.network import make_fleet as t_make_fleet


@pytest.mark.parametrize("case", ["empty", "full", "sparse", "ragged",
                                  "over_block"])
def test_packed_row_indices_bit_equal(case):
    rng = np.random.default_rng(0)
    load = {"empty": np.zeros(100),
            "full": np.ones(700),
            "sparse": (rng.uniform(size=900) < 0.2).astype(np.float32),
            "ragged": (np.arange(640) % 64 < 50).astype(np.float32),
            "over_block": (rng.uniform(size=1500) < 0.5).astype(np.float32),
            }[case]
    got, want = t_cfl.packed_row_indices(load), j_cfl.packed_row_indices(load)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _states(loads, n=10, ell=64, d=8, c=40, seed=0):
    """The same setup in both packages: the JAX `cfl.setup` on a given
    plan, carried into the port through `interop`."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, ell, d)).astype(np.float32)
    ys = rng.standard_normal((n, ell)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    jf = j_make_fleet(n, d, 0.3, 0.3, np.random.default_rng(seed))
    fields = dict(loads=np.asarray(loads), c=c, t_star=1.0,
                  p_return=rng.uniform(0.2, 0.9, n + 1),
                  expected_agg=float(n * ell), loads_cap_total=n * ell)
    jstate = j_cfl.setup(jax.random.PRNGKey(seed), jnp.asarray(xs),
                         jnp.asarray(ys), jf.edge, jf.server,
                         plan=JPlan(**fields))
    jdata = JTrainData(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(beta))
    tf = t_make_fleet(n, d, 0.3, 0.3, np.random.default_rng(seed))
    tstate = interop.cfl_state(
        interop.redundancy_plan(**fields), np.asarray(jstate.weights),
        np.asarray(jstate.load_mask), np.asarray(jstate.x_parity),
        np.asarray(jstate.y_parity), tf.edge, tf.server, device="cpu")
    tdata = interop.train_data(xs, ys, beta, device="cpu")
    return jstate, jdata, tstate, tdata, tf


LAYOUTS = {
    # 6 of 10 clients loaded: 384 rows pad to 512 < 0.85 * 640 -> packed
    "packed": [64, 0, 64, 30, 0, 64, 0, 64, 64, 0],
    # every client loaded: 640 rows -> dense fallback
    "dense": [64, 64, 64, 64, 50, 64, 64, 64, 64, 64],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fused_device_state_layouts(layout):
    jstate, jdata, tstate, tdata, _ = _states(LAYOUTS[layout])
    want = j_cfl.fused_coded_device_state(jstate, jdata)
    got = t_cfl.fused_coded_device_state(tstate, tdata)
    assert set(got) == set(want)
    assert ("sys_x" in got) == (layout == "packed")
    for key in got:
        if key in ("par_gram", "par_gramy"):
            continue
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("par_gram", "par_gramy"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fused_device_state_parity_rows(layout):
    """parity_rows=True ships the raw parity rows in place of the Gram
    factors, which the reference computes there but never reads."""
    jstate, jdata, tstate, tdata, _ = _states(LAYOUTS[layout])
    want = j_cfl.fused_coded_device_state(jstate, jdata, parity_rows=True)
    got = t_cfl.fused_coded_device_state(tstate, tdata, parity_rows=True)
    assert set(got) == set(want) - {"par_gram", "par_gramy"}
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


def test_coded_device_state_and_accounting():
    jstate, jdata, tstate, tdata, tf = _states(LAYOUTS["packed"])
    want = j_cfl.coded_device_state(jstate, jdata)
    got = t_cfl.coded_device_state(tstate, tdata)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(tstate.parity_upload_bits(),
                                  jstate.parity_upload_bits())
    jf = j_make_fleet(10, 8, 0.3, 0.3, np.random.default_rng(0))
    assert t_cfl.sample_parity_upload_time(
        tstate, tf, np.random.default_rng(5)) == \
        j_cfl.sample_parity_upload_time(jstate, jf, np.random.default_rng(5))
    assert t_cfl.coded_uplink_bits(tstate, tf, 17) == \
        j_cfl.coded_uplink_bits(jstate, jf, 17)


def test_setup_weights_and_mask_bit_equal():
    """The port's own `setup` on the same plan builds the same Eq.-17
    weights and load mask (its parity is drawn from a torch.Generator,
    so only its shapes are compared)."""
    jstate, _, _, tdata, tf = _states(LAYOUTS["packed"])
    state = t_cfl.setup(7, tdata.xs, tdata.ys, tf.edge, tf.server,
                        plan=interop.redundancy_plan(
                            loads=jstate.plan.loads, c=jstate.plan.c,
                            t_star=jstate.plan.t_star,
                            p_return=jstate.plan.p_return,
                            expected_agg=jstate.plan.expected_agg,
                            loads_cap_total=jstate.plan.loads_cap_total))
    np.testing.assert_array_equal(state.weights.numpy(),
                                  np.asarray(jstate.weights))
    np.testing.assert_array_equal(state.load_mask.numpy(),
                                  np.asarray(jstate.load_mask))
    assert state.x_parity.shape == (40, 8) and state.y_parity.shape == (40,)
    assert state.c == jstate.c == 40
    assert torch.isfinite(state.x_parity).all()
