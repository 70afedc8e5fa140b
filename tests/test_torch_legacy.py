"""The legacy per-epoch API of the port (`core.cfl.epoch_gradient` over
`core.aggregation.client_partial_gradients`, `parity_gradient` and
`combine`) and the least-squares gradient kernel's plain version against
the JAX package, on the CPU.

Both packages get the reference's CFL state (its plan from
`repro.plan.reference`, `cfl.setup` on it) carried across with
`repro_torch.interop`, the same NumPy data, beta and arrival masks; the
JAX `lsq_gradient` runs its Pallas kernel in interpret mode.

Bounds:
  * each gradient within rtol 1e-5 plus an atol of 1e-5 x max|ref|:
    float32 sums over at most a few hundred terms taken in another order
    (an einsum against XLA's dot, or the Pallas kernel's row blocks)
    differ by rounding that scales with the largest component, so an
    element-wise rtol alone fails at cancelled components;
  * a 30-epoch legacy loop (epoch_gradient -> gd_update -> nmse): NMSE
    within rtol 1e-4, the bound of `tests/test_torch_slice.py`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as j_agg
from repro.core import cfl as j_cfl
from repro.kernels.coded_grad import coded_grad as j_cg
from repro.plan.reference import solve_redundancy_reference
from repro_torch import api as t_api
from repro_torch import interop
from repro_torch.core import aggregation as t_agg
from repro_torch.core import cfl as t_cfl
from repro_torch.kernels.coded_grad import ops as cg_ops
from test_torch_slice import ELL, EPOCHS, LR, _data, _fleets

N, SEED = 10, 5


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _states(c):
    """(jax state, port state, xs, ys, beta_true, port fleet) at c."""
    jf, tf = _fleets(N, SEED)
    xs, ys, beta = _data(N, SEED)
    plan = solve_redundancy_reference(jf.edge, jf.server, np.full(N, ELL),
                                      fixed_c=c)
    jstate = j_cfl.setup(jax.random.PRNGKey(SEED), jnp.asarray(xs),
                         jnp.asarray(ys), jf.edge, jf.server, plan=plan)
    tplan = interop.redundancy_plan(plan.loads, plan.c, plan.t_star,
                                    plan.p_return, plan.expected_agg,
                                    plan.loads_cap_total)
    tstate = interop.cfl_state(tplan, np.asarray(jstate.weights),
                               np.asarray(jstate.load_mask),
                               np.asarray(jstate.x_parity),
                               np.asarray(jstate.y_parity), tf.edge,
                               tf.server, device="cpu")
    assert tstate.c == jstate.c == c
    return jstate, tstate, xs, ys, beta, tf


C_CASES = [179, 0]


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    beta = rng.standard_normal(16).astype(np.float32)
    received = (rng.random(N) < 0.7).astype(np.float32)
    return beta, received


@pytest.mark.parametrize("c", C_CASES)
def test_client_partial_gradients_and_combine(c):
    jstate, tstate, xs, ys, _, _ = _states(c)
    beta, received = _operands()
    want = j_agg.client_partial_gradients(
        jnp.asarray(xs), jnp.asarray(ys), jstate.load_mask,
        jnp.asarray(beta))
    got = t_agg.client_partial_gradients(
        torch.tensor(xs), torch.tensor(ys), tstate.load_mask,
        torch.tensor(beta))
    _close(got, want)
    g_par = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    for ok in (0.0, 1.0):
        _close(t_agg.combine(got, torch.tensor(received),
                             torch.tensor(g_par), torch.tensor(ok)),
               j_agg.combine(want, jnp.asarray(received),
                             jnp.asarray(g_par), jnp.asarray(ok)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_parity_gradient(use_kernel):
    jstate, tstate, *_ = _states(179)
    beta, _ = _operands(2)
    want = j_agg.parity_gradient(jstate.x_parity, jstate.y_parity,
                                 jnp.asarray(beta), use_kernel=use_kernel)
    got = t_agg.parity_gradient(tstate.x_parity, tstate.y_parity,
                                torch.tensor(beta), use_kernel=use_kernel)
    _close(got, want)


@pytest.mark.parametrize("c", C_CASES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_epoch_gradient(c, use_kernel):
    jstate, tstate, xs, ys, _, _ = _states(c)
    beta, received = _operands(3)
    for ok in (0.0, 1.0):
        want = j_cfl.epoch_gradient(jstate, jnp.asarray(xs), jnp.asarray(ys),
                                    jnp.asarray(beta), jnp.asarray(received),
                                    jnp.asarray(ok), use_kernel=use_kernel)
        got = t_cfl.epoch_gradient(tstate, torch.tensor(xs),
                                   torch.tensor(ys), torch.tensor(beta),
                                   torch.tensor(received), torch.tensor(ok),
                                   use_kernel=use_kernel)
        _close(got, want)


@pytest.mark.parametrize("m,d,block_m", [(179, 16, 64), (37, 13, 8),
                                         (1, 1, 1024), (300, 40, 1024)])
def test_lsq_gradient_plain_matches_pallas(m, d, block_m):
    rng = np.random.default_rng(m + d)
    a = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    want = j_cg.lsq_gradient(jnp.asarray(a), jnp.asarray(y),
                             jnp.asarray(beta), block_m=block_m,
                             interpret=True)
    before = cg_ops.COUNTER.launches
    got = cg_ops.lsq_gradient(torch.tensor(a), torch.tensor(y),
                              torch.tensor(beta))
    assert cg_ops.COUNTER.launches == before  # the CPU runs no kernel
    _close(got, want)


@pytest.mark.parametrize("c", C_CASES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_legacy_loop_matches_reference(c, use_kernel):
    """30 epochs of epoch_gradient -> gd_update -> nmse over the arrival
    masks of the CodedFL schedule, in both packages."""
    jstate, tstate, xs, ys, beta_true, tf = _states(c)
    strategy = t_api.CodedFL(key=SEED, fixed_c=tstate.c,
                             redundancy_plan=tstate.plan,
                             include_upload_delay=False)
    sched = strategy.sample_epochs(tstate, tf, EPOCHS,
                                   np.random.default_rng(SEED))
    received, parity_ok = (sched.arrivals["received"],
                           sched.arrivals["parity_ok"])
    m = N * ELL
    jx, jy, jb = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(beta_true)
    tx, ty, tb = torch.tensor(xs), torch.tensor(ys), torch.tensor(beta_true)
    j_beta, t_beta = jnp.zeros(16, jnp.float32), torch.zeros(16)
    j_lr, t_lr = jnp.asarray(LR, jnp.float32), torch.tensor(LR)
    want, got = [], []
    for e in range(EPOCHS):
        g = j_cfl.epoch_gradient(jstate, jx, jy, j_beta,
                                 jnp.asarray(received[e]),
                                 jnp.asarray(parity_ok[e]),
                                 use_kernel=use_kernel)
        j_beta = j_agg.gd_update(j_beta, g, j_lr, m)
        want.append(float(j_agg.nmse(j_beta, jb)))
        g = t_cfl.epoch_gradient(tstate, tx, ty, t_beta,
                                 torch.tensor(received[e]),
                                 torch.tensor(parity_ok[e]),
                                 use_kernel=use_kernel)
        t_beta = t_agg.gd_update(t_beta, g, t_lr, m)
        got.append(float(t_agg.nmse(t_beta, tb)))
    assert np.all(np.isfinite(got)) and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_epoch_gradient_drops_parity_at_c0():
    """c == 0: the parity term is dropped whatever parity_received says."""
    _, tstate, xs, ys, _, _ = _states(0)
    beta, received = _operands(4)
    args = (torch.tensor(xs), torch.tensor(ys), torch.tensor(beta),
            torch.tensor(received))
    partials = t_agg.client_partial_gradients(args[0], args[1],
                                              tstate.load_mask, args[2])
    want = torch.einsum("nd,n->d", partials, args[3])
    for ok in (0.0, 1.0):
        assert torch.equal(t_cfl.epoch_gradient(tstate, *args,
                                                torch.tensor(ok)), want)
