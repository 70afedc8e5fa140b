"""The port's straggler-aware federated LM trainer (`repro_torch.fed.
trainer`, `launch.steps.make_fed_train_step` / `make_fed_grad_fn`)
against the JAX package, on the CPU.

The plan and the arrivals are host NumPy over the port's own delay model
and `optimal_loads`: `fed_setup`'s plans (t*, loads, `p_return`,
expected return) and the sampled weights (`round_weights`,
`presample_round_weights`, the `min_return_prob` gate and clip) are
bit-equal to the reference's on the same fleet and generator.  The
model side runs the reduced granite-8b (2 layers, d_model 256, vocab
512; and the reduced mamba2-1.3b for one step) from JAX's
`init_params(PRNGKey(0))`:
  * one federated step (float32, SGD at lr 1): the loss within rtol 1e-5
    and each gradient leaf (the parameters' change) within rtol 1e-4 /
    atol 1e-6 * max(1, max|ref|), as `tests/test_torch_train.py`;
  * `fed_train`, 10 rounds of AdamW on fresh batches with arrivals drawn
    from the fleet: losses within rtol 1e-3 of the reference's
    `fed_train` (AdamW's sign-like steps amplify rounding over rounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.delay_model import DeviceDelayParams as JDelay
from repro.core.redundancy import RedundancyPlan as JPlan
from repro.data.synthetic import token_batches as j_token_batches
from repro.fed import trainer as JF
from repro.launch.steps import make_fed_train_step as j_make_fed_step
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.sim.network import paper_fleet as j_paper_fleet
from repro_torch import fed, interop, tree
from repro_torch.configs import get_config
from repro_torch.data.synthetic import token_batches
from repro_torch.fed import trainer as F
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.sim.network import paper_fleet

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _same_plan(got, want):
    np.testing.assert_array_equal(got.loads, want.loads)
    assert got.c == want.c == 0
    assert got.t_star == want.t_star
    np.testing.assert_array_equal(got.p_return, want.p_return)
    assert got.expected_agg == want.expected_agg
    assert got.loads_cap_total == want.loads_cap_total


FLEETS = [(0.2, 0, 8, 100, 16, 64), (0.3, 1, 6, 50, 8, 24),
          (0.1, 0, 4, 64, 2, 8), (0.2, 0, 8, 768, 1, 8),
          (0.4, 3, 12, 32, 5, 100)]


@pytest.mark.parametrize("nu,seed,n,d,per,target", FLEETS)
def test_fed_setup_is_bit_equal(nu, seed, n, d, per, target):
    jfleet = j_paper_fleet(nu, nu, seed=seed, n=n, d=d)
    fleet = paper_fleet(nu, nu, seed=seed, n=n, d=d)
    want = JF.fed_setup(jfleet.edge, JF.FedConfig(n, per, target))
    got = F.fed_setup(fleet.edge, F.FedConfig(n, per, target))
    _same_plan(got.plan, want.plan)
    np.testing.assert_array_equal(got.p_return, want.p_return)
    assert got.min_return_prob == want.min_return_prob
    assert got.plan.expected_agg >= min(target, n * per) * 0.999


@pytest.mark.parametrize("nu,seed,n,d,per,target", FLEETS)
def test_round_weights_are_bit_equal(nu, seed, n, d, per, target):
    jstate = JF.fed_setup(j_paper_fleet(nu, nu, seed=seed, n=n, d=d).edge,
                          JF.FedConfig(n, per, target))
    state = F.fed_setup(paper_fleet(nu, nu, seed=seed, n=n, d=d).edge,
                        F.FedConfig(n, per, target))
    clients = np.repeat(np.arange(n), per)
    jrng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        jw, jdt = JF.round_weights(jstate, jrng, clients)
        w, dt = F.round_weights(state, rng, clients)
        np.testing.assert_array_equal(w, jw)
        assert dt == jdt
    np.testing.assert_array_equal(
        F.presample_round_weights(state, np.random.default_rng(9), 7),
        JF.presample_round_weights(jstate, np.random.default_rng(9), 7))


def test_min_return_prob_gates_scheduling_and_clips_weights():
    """The reference's case: a client below the floor never lands, the
    weights are clipped at 1/floor, and both packages draw the same."""
    def state(delay, plan, mod):
        edge = delay(a=np.array([1e-3, 1e-3]), mu=np.array([100.0, 100.0]),
                     tau=np.array([0.01, 0.01]), p=np.array([0.1, 0.1]))
        return mod.FedState(
            plan=plan(loads=np.array([8, 8]), c=0, t_star=1e9,
                      p_return=np.array([0.9, 1e-5, 1.0]),
                      expected_agg=16.0, loads_cap_total=16),
            p_return=np.array([0.9, 1e-5]), edge=edge, min_return_prob=1e-3)

    from repro_torch.core.delay_model import DeviceDelayParams
    from repro_torch.core.redundancy import RedundancyPlan
    mine = state(DeviceDelayParams, RedundancyPlan, F)
    ref = state(JDelay, JPlan, JF)
    clients = np.array([0, 0, 1, 1])
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        w, _ = F.round_weights(mine, rng, clients)
        np.testing.assert_array_equal(w, JF.round_weights(ref, jrng,
                                                          clients)[0])
        assert np.all(w[2:] == 0.0)
        assert np.all(w[:2] <= 1.0 / 1e-3 + 1e-9)
    pre = F.presample_round_weights(mine, np.random.default_rng(5), 1)
    w0, _ = F.round_weights(mine, np.random.default_rng(5), clients)
    np.testing.assert_array_equal(pre[0][clients], w0)


def test_fed_round_unbiasedness():
    """E[masked weighted sum] == plain sum over many arrival draws."""
    state = F.fed_setup(paper_fleet(0.3, 0.3, seed=1, n=6, d=50).edge,
                        F.FedConfig(6, 8, 24))
    rng = np.random.default_rng(1)
    clients = np.repeat(np.arange(6), 2)
    vals = np.arange(12, dtype=np.float64) + 1.0
    est = np.zeros(12)
    trials = 4000
    for _ in range(trials):
        w, _ = F.round_weights(state, rng, clients)
        est += w * vals
    est /= trials
    scheduled = state.plan.loads[clients] > 0
    np.testing.assert_allclose(est[scheduled], vals[scheduled], rtol=0.12)


def test_masked_loss_matches_reference():
    per_seq = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    for w in ([0.0, 2.0, 0.0, 1.25], [0.0] * 4, [1.0] * 4):
        w = np.array(w, np.float32)
        want = JF.masked_loss(lambda p, b: jnp.asarray(per_seq), None, {},
                              jnp.asarray(w))
        got = F.masked_loss(lambda p, b: torch.from_numpy(per_seq), None, {},
                            torch.from_numpy(w))
        assert float(got) == float(want)


@pytest.fixture(scope="module", params=["granite-8b", "mamba2-1.3b"])
def model(request):
    arch = request.param
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, interop.lm_params(_np(jp), CPU)


def test_fed_train_step_matches_reference(model):
    jcfg, cfg, jp, p = model
    jb = next(j_token_batches(3, batch=4, seq_len=24, vocab=cfg.vocab))
    b = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    for w in ([0.0, 1.5, 0.0, 1.0], [0.0] * 4):
        w = np.array(w, np.float32)
        jp2, _, jm = jax.jit(j_make_fed_step(jcfg, JO.sgd(1.0)))(
            jp, JO.sgd(1.0).init(jp), jb, jnp.asarray(w))
        mine = tree.tree_map(torch.clone, p)
        step = steps.make_fed_train_step(cfg, O.sgd(1.0))
        out, state, m = step(mine, O.sgd(1.0).init(mine), b,
                             torch.from_numpy(w))
        assert out is mine and sorted(m) == ["loss"]
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for p0, p1, j0, j1 in zip(tree.leaves(p), tree.leaves(out),
                                  tree.leaves(_np(jp)),
                                  tree.leaves(_np(jp2))):
            want = j0 - j1
            np.testing.assert_allclose(
                (p0 - p1).double().numpy(), want, rtol=1e-4,
                atol=1e-6 * max(1.0, float(np.abs(want).max())))
        if not w.any():  # nothing landed: zero loss, no change
            assert float(m["loss"]) == 0.0
            assert all(torch.equal(a, c) for a, c in
                       zip(tree.leaves(p), tree.leaves(out)))


def test_fed_train_matches_reference_loop():
    """`fed_train` on the reduced granite-8b, 10 rounds of AdamW over a
    paper fleet of 4 clients x 2 sequences, each round on a fresh batch,
    against the reference's `fed_train` with the same arrivals."""
    jcfg = j_get_config("granite-8b").reduced()
    cfg = get_config("granite-8b").reduced()
    n, per = 4, 2
    B = n * per
    fcfg = (n, per, B)
    jstate = JF.fed_setup(j_paper_fleet(0.3, 0.3, seed=2, n=n, d=64).edge,
                          JF.FedConfig(*fcfg))
    state = F.fed_setup(paper_fleet(0.3, 0.3, seed=2, n=n, d=64).edge,
                        F.FedConfig(*fcfg))
    clients = np.repeat(np.arange(n), per)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = interop.lm_params(_np(jp), CPU)

    @jax.jit
    def j_grad_fn(params, batch, w):
        def lf(q):
            logits, _ = JT.forward_train(jcfg, q, batch)
            logp = jax.nn.log_softmax(logits, axis=-1)
            nll = -jnp.take_along_axis(logp, batch["targets"][..., None],
                                       axis=-1)[..., 0]
            return jnp.sum(jnp.mean(nll, -1) * w) / jnp.maximum(
                jnp.sum(w > 0), 1)
        return jax.value_and_grad(lf)(params)

    jbatches = ((b, clients) for b in j_token_batches(4, B, 24, cfg.vocab))
    batches = ((b, clients) for b in token_batches(4, B, 24, cfg.vocab,
                                                   device=CPU))
    _, jlosses = JF.fed_train(jstate, j_grad_fn, jp, JO.adamw(3e-3),
                              jbatches, 10, seed=5)
    out, losses = F.fed_train(state, steps.make_fed_grad_fn(cfg), p,
                              O.adamw(3e-3), batches, 10, seed=5,
                              device="cpu")
    assert out is p
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert state.round_idx == 10
    assert state.wall_clock == jstate.wall_clock
    with pytest.raises(ValueError, match="parameters are on"):
        F.fed_train(state, steps.make_fed_grad_fn(cfg), p, O.adamw(3e-3),
                    batches, 1, device="meta")


def test_fed_lm_training_reduces_loss():
    """The counterpart of the reference's `test_fed_lm_training_reduces_
    loss`: ten rounds of the federated step on one batch, arrivals from a
    paper fleet, the loss goes down."""
    cfg = get_config("granite-8b").reduced()
    n_clients, per_client = 4, 2
    B = n_clients * per_client
    state = fed.fed_setup(paper_fleet(0.1, 0.1, seed=0, n=n_clients,
                                      d=64).edge,
                          fed.FedConfig(n_clients=n_clients,
                                        sequences_per_client=per_client,
                                        target_sequences=B))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = O.make_optimizer("adamw", 3e-3)
    opt_state = opt.init(params)
    step = steps.make_fed_train_step(cfg, opt)
    batch = next(token_batches(0, batch=B, seq_len=16, vocab=cfg.vocab,
                               device="cpu"))
    rng = np.random.default_rng(0)
    batch_clients = np.repeat(np.arange(n_clients), per_client)
    losses = []
    for _ in range(10):
        w, _ = fed.round_weights(state, rng, batch_clients)
        params, opt_state, m = step(params, opt_state, batch,
                                    torch.as_tensor(w, dtype=torch.float32))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_fed_round_applies_one_round():
    cfg = get_config("granite-8b").reduced()
    state = F.fed_setup(paper_fleet(0.0, 0.0, seed=0, n=2, d=8).edge,
                        F.FedConfig(2, 1, 2))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    before = params["embed"].clone()
    opt = O.sgd(0.5)
    batch = next(token_batches(0, 2, 8, cfg.vocab, device="cpu"))
    out, st, loss = F.fed_round(state, steps.make_fed_grad_fn(cfg), params,
                                opt, opt.init(params), batch,
                                np.array([0, 1]), np.random.default_rng(0))
    assert np.isfinite(loss) and int(st.step) == 1
    assert state.round_idx == 1 and state.wall_clock == state.plan.t_star
    assert not torch.equal(out["embed"], before)
