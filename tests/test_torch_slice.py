"""The slice as a whole: the §IV training path of the port against the JAX
package on a small fleet, run on the CPU.

Both packages get the same NumPy data, the reference's plan
(`repro.plan.reference`), the reference's encoded parity (`cfl.setup` on
that plan, carried across with `repro_torch.interop`) and the same
`np.random.default_rng` seed.  The JAX side runs epoch by epoch through
`jax.jit(repro.api.make_epoch_step(...))`, the port through
`Session.run(..., state=...)` on the CPU.

Bounds:
  * times and epoch durations identical: both sample the same host-side
    NumPy schedule in the same draw order;
  * NMSE traces within rtol 1e-4: float32 gradients summed in another
    order over 30 epochs (the reference's own fused-versus-reference gap
    over 600 epochs at §IV is 2.3e-6);
  * equal coding gain where both runs cross the target.

The "packed" case uses n = 10 clients: the packed layout needs more than
512 / 0.85 = 602 rows, which n <= 8 at ell = 64 cannot give.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as j_api
from repro.core import aggregation as j_agg
from repro.core import cfl as j_cfl
from repro.plan.reference import solve_redundancy_reference
from repro.sim.network import make_fleet as j_make_fleet
from repro_torch import api as t_api
from repro_torch import interop

EPOCHS = 30
LR = 0.3
TARGET = 0.05
ELL, D = 64, 16

CASES = {
    # (n clients, fleet seed, fixed_c) at nu_comp = nu_link = 0.3
    "dense": (8, 3, 143),
    "packed": (10, 5, 179),
}


def _fleets(n, seed):
    jf = j_make_fleet(n, D, 0.3, 0.3, np.random.default_rng(seed))
    port = interop.fleet_spec(
        interop.delay_params(jf.edge.a, jf.edge.mu, jf.edge.tau, jf.edge.p),
        interop.delay_params(jf.server.a, jf.server.mu, jf.server.tau,
                             jf.server.p),
        jf.mac_rates, jf.link_rates, jf.packet_bits, jf.d, jf.nu_comp,
        jf.nu_link)
    return jf, port


def _data(n, seed):
    rng = np.random.default_rng(100 + seed)
    xs = rng.standard_normal((n, ELL, D)).astype(np.float32)
    beta = rng.standard_normal(D).astype(np.float32)
    ys = (xs @ beta + rng.standard_normal((n, ELL))).astype(np.float32)
    return xs, ys, beta


def _jax_run(strategy, state, data, fleet, seed):
    """The reference's training program, one jitted epoch at a time."""
    sched = strategy.sample_epochs(state, fleet, EPOCHS,
                                   np.random.default_rng(seed))
    dev = strategy.device_state(state, data)
    step = jax.jit(j_api.make_epoch_step(strategy, state, data.m))
    beta = jnp.zeros(data.model_dim, jnp.float32)
    lr = jnp.asarray(LR, jnp.float32)
    trace = [float(j_agg.nmse(beta, data.beta_true))]
    for e in range(EPOCHS):
        arr_t = {k: jnp.asarray(v[e]) for k, v in sched.arrivals.items()}
        beta, err = step(beta, dev, lr, data.beta_true, arr_t)
        trace.append(float(err))
    times = sched.t0 + np.concatenate([[0.0], np.cumsum(sched.durations)])
    return j_api.TraceReport(times=times, nmse=np.asarray(trace),
                             epoch_durations=np.asarray(sched.durations),
                             label=strategy.label)


def _assert_same_run(got, want):
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.epoch_durations, want.epoch_durations)
    np.testing.assert_allclose(got.nmse, want.nmse, rtol=1e-4)
    assert np.all(np.isfinite(got.nmse))


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_matches_reference(case, grad_path):
    n, seed, fixed_c = CASES[case]
    jf, tf = _fleets(n, seed)
    xs, ys, beta = _data(n, seed)
    plan = solve_redundancy_reference(jf.edge, jf.server, np.full(n, ELL),
                                      fixed_c=fixed_c)
    key = jax.random.PRNGKey(seed)
    jstate = j_cfl.setup(key, jnp.asarray(xs), jnp.asarray(ys), jf.edge,
                         jf.server, plan=plan)
    jdata = j_api.TrainData(jnp.asarray(xs), jnp.asarray(ys),
                            jnp.asarray(beta))
    j_coded = j_api.CodedFL(key=key, fixed_c=fixed_c, redundancy_plan=plan,
                            include_upload_delay=False, grad_path=grad_path)
    j_uncoded = j_api.UncodedFL(grad_path=grad_path)
    want_c = _jax_run(j_coded, jstate, jdata, jf, seed)
    want_u = _jax_run(j_uncoded, j_uncoded.plan(jf, jdata), jdata, jf, seed)

    tplan = interop.redundancy_plan(plan.loads, plan.c, plan.t_star,
                                    plan.p_return, plan.expected_agg,
                                    plan.loads_cap_total)
    tstate = interop.cfl_state(tplan, np.asarray(jstate.weights),
                               np.asarray(jstate.load_mask),
                               np.asarray(jstate.x_parity),
                               np.asarray(jstate.y_parity), tf.edge,
                               tf.server, device="cpu")
    tdata = interop.train_data(xs, ys, beta, device="cpu")
    t_coded = t_api.CodedFL(key=seed, fixed_c=fixed_c, redundancy_plan=tplan,
                            include_upload_delay=False, grad_path=grad_path)
    got_c = t_api.Session(t_coded, tf, LR, EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed), state=tstate)
    got_u = t_api.Session(t_api.UncodedFL(grad_path=grad_path), tf, LR,
                          EPOCHS, device="cpu").run(
        tdata, rng=np.random.default_rng(seed))

    if grad_path == "fused":
        layout = t_coded.device_state(tstate, tdata)
        assert ("sys_x" in layout) == (case == "packed")
    _assert_same_run(got_c, want_c)
    _assert_same_run(got_u, want_u)
    gain_t = t_api.coding_gain(got_u, got_c, TARGET)
    gain_j = j_api.coding_gain(want_u, want_c, TARGET)
    assert np.isfinite(gain_j)  # both runs cross the target
    assert gain_t == gain_j
    assert got_c.uplink_bits_total == \
        j_coded.uplink_bits(jstate, jf, EPOCHS)


def test_port_plans_and_trains_on_its_own():
    """The port's own path end to end on the CPU (its planner, its
    torch.Generator encode, both strategies) converges and reports."""
    _, tf = _fleets(8, 3)
    data = t_api.TrainData.linreg(0, 8, ELL, D, device="cpu")
    coded = t_api.Session(t_api.CodedFL(key=1, fixed_c=143, use_kernel=True,
                                        include_upload_delay=False),
                          tf, LR, EPOCHS, device="cpu")
    state = coded.plan(data)
    assert state.c == 143 and state.x_parity.shape == (143, D)
    rep_c = coded.run(data, rng=np.random.default_rng(0), state=state)
    rep_u = t_api.Session(t_api.UncodedFL(), tf, LR, EPOCHS,
                          device="cpu").run(data,
                                            rng=np.random.default_rng(0))
    for rep in (rep_c, rep_u):
        assert rep.nmse.shape == (EPOCHS + 1,) and rep.nmse[0] == 1.0
        assert rep.nmse[-1] < 0.1 and rep.beta.shape == (D,)
    assert t_api.coding_gain(rep_u, rep_c, TARGET) > 1.0
