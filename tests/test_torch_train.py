"""The port's LM training path against the JAX package, on the CPU:
`optim` (optimizers, schedules), `models.transformer.forward_train` /
`loss_fn`, `launch.steps.make_train_step`, `data.synthetic.
token_batches` and the `launch.train` command line, on the reduced
lm-100m, granite-8b (2 layers, d_model 256, 4 heads and 2 key/value
heads of 64, d_ff 512, vocab 512) and mamba2-1.3b (2 layers, d_model
256, 16 heads of 32, d_state 16, chunk 16, vocab 512) with JAX's
`init_params(PRNGKey(0))` carried across by `interop.lm_params`, on
batches of 2 sequences of 40 tokens (the ssm family pads its last
chunk).  The JAX functions run through `jax.jit`, as
`tests/test_arch_smoke.py` runs them.

Bounds:
  * one optimizer update (SGD with and without momentum, AdamW with
    weight decay and with bf16 moments) from the same grads, and the
    schedules and clipping: rtol 1e-6 (float32 expressions in the same
    order; the bias corrections' float32 powers may differ by an ulp);
    the in-place update equal to the functional one;
  * logits: rtol 1e-5 / atol 1e-5 * max|ref| (float32 products over
    256- to 512-wide rows in another order; seen ~1e-6 of max); the
    loss: rtol 1e-6 (seen <= 7e-8);
  * `remat=True` gradients `torch.equal` to `remat=False` (the
    recomputation repeats the same float32 operations);
  * one float32 train step: the loss rtol 1e-5, and every gradient leaf
    (directly, through the SGD update at lr 1 and through `grad_norm`)
    within rtol 1e-4 / atol 1e-6 * max(1, max|ref|) (seen <= 0.42 of
    it), `grad_norm` rtol 1e-5;
  * bfloat16 compute against JAX at bfloat16: bf16 keeps 8 significand
    bits, a rounding of up to u = 2^-8 relative.  The loss is a float32
    mean of float32 log-softmaxes of logits whose operands were rounded
    to bf16 a few times: rtol u (seen <= 1.4e-4).  A gradient leaf comes
    back through two blocks of some eight bf16-rounded tensors each, so
    its first-order relative error is at most 16 u in norm: each leaf
    within ||port - ref|| <= 16 u ||ref|| (seen <= 2.7e-2 = 7 u; JAX's
    own bf16 gradients differ from its float32 ones by as much).  So
    that a port that ignored `compute_dtype` cannot pass, the same test
    also holds the port's bf16-minus-float32 perturbation to JAX's: the
    loss within half JAX's own bf16/float32 gap of JAX's bf16 loss
    (seen <= 0.35 of the gap), and over the whole gradient tree the
    port's perturbation within a factor 2 of JAX's in norm (seen
    0.93-1.0) and at cosine >= 0.25 with it (seen >= 0.55; a float32
    port's perturbation is float32 rounding, some 1e-4 of JAX's in
    norm and uncorrelated with it);
  * five AdamW steps (clipping and a cosine warmup on): losses rtol
    1e-3 (AdamW's sign-like steps on near-zero gradients amplify
    rounding, so parameters are a poor multi-step comparison);
  * `token_batches`: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.synthetic import token_batches as j_token_batches
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro_torch import interop, tree
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.data.synthetic import token_batches
from repro_torch.launch import steps, train
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.optim import schedules as S

ARCHS = ["lm-100m", "granite-8b", "mamba2-1.3b"]
CPU = torch.device("cpu")
U_BF16 = 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Small tensors: two intra-op threads, restored after the module,
    keep the file cheap when the suite runs beside others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol, atol_scale=None):
    """got within rtol / atol of want; atol = atol_scale * max(1,
    max|want|) when given, else rtol * max|want|."""
    want = np.asarray(want, dtype=np.float64)
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, dtype=np.float64))
    assert got.shape == want.shape
    top = float(np.abs(want).max()) if want.size else 0.0
    atol = (atol_scale * max(1.0, top) if atol_scale is not None
            else rtol * top)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _tree_pair(seed=0, dtype=np.float32):
    """A nested tree of (params, grads) as NumPy, mixed magnitudes and
    some near-zero gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (6, 4), "blocks": {"w": (2, 4, 3), "b": (2, 3)},
              "final_norm": {"scale": (4,)}}

    def draw(scale):
        return jax.tree.map(lambda s: (scale * rng.standard_normal(s))
                            .astype(dtype), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))

    params, grads = draw(1.0), draw(0.1)
    grads["blocks"]["b"][0] = 1e-9
    return params, grads


OPTS = {
    "sgd": (lambda m: m.sgd(0.1)),
    "sgd_momentum": (lambda m: m.sgd(0.05, momentum=0.9)),
    "adamw_wd": (lambda m: m.adamw(3e-3, weight_decay=0.1)),
    "adamw_bf16": (lambda m: m.adamw(
        1e-2, state_dtype=(jnp.bfloat16 if m is JO else torch.bfloat16))),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_update_matches_reference(name):
    """Two updates: from init, then from the reference's state after the
    first (carried by `interop.opt_state`), each within rtol 1e-6 of the
    reference's updates and moments; `update_` writes what `update`
    returns, bit for bit."""
    np_params, np_grads = _tree_pair()
    jopt, opt = OPTS[name](JO), OPTS[name](O)
    jp = jax.tree.map(jnp.asarray, np_params)
    jg = jax.tree.map(jnp.asarray, np_grads)
    jstate = jopt.init(jp)
    p, g = interop.lm_params(np_params, CPU), interop.lm_params(np_grads,
                                                                CPU)
    state = opt.init(p)
    for _ in range(2):
        jupd, jstate_new = jax.jit(jopt.update)(jg, jstate, jp)
        upd, new = opt.update(g, state, p)
        assert int(new.step) == int(jstate_new.step)
        for (k, u), (_, ju) in zip(tree.flatten_with_path(upd),
                                   tree.flatten_with_path(_np(jupd))):
            _close(u, ju, rtol=1e-6)
        for mine, ref in ((new.mu, jstate_new.mu), (new.nu, jstate_new.nu)):
            assert (mine is None) == (ref is None)
            if mine is not None:
                for m, jm in zip(tree.leaves(mine), tree.leaves(_np(ref))):
                    assert m.dtype == (torch.bfloat16 if name == "adamw_bf16"
                                       else torch.float32)
                    _close(m.float(), np.asarray(jm, np.float32), rtol=1e-6)
        # in place: the same numbers into the same tensors
        p2 = tree.tree_map(torch.clone, p)
        st2 = O.OptState(state.step.clone(),
                         *(None if t is None else tree.tree_map(torch.clone,
                                                                t)
                           for t in (state.mu, state.nu)))
        st2 = opt.update_(g, st2, p2)
        for a, b in zip(tree.leaves(p2), tree.leaves(O.apply_updates(p, upd))):
            assert torch.equal(a, b)
        for mine, want in ((st2.mu, new.mu), (st2.nu, new.nu)):
            if want is not None:
                assert all(torch.equal(a, b) for a, b in
                           zip(tree.leaves(mine), tree.leaves(want)))
        # next round from the reference's state, on both sides
        jp = jax.jit(JO.apply_updates)(jp, jupd)
        jstate = jstate_new
        p = interop.lm_params(_np(jp), CPU)
        state = interop.opt_state(_np(jstate), CPU)


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adamw"])
def test_optimizers_minimize_quadratic(name):
    opt = {"sgd": O.sgd(0.1), "sgd_momentum": O.sgd(0.05, momentum=0.9),
           "adamw": O.adamw(0.3)}[name]
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor([1.5])}
    state = opt.init(params)
    for _ in range(200):
        grads = tree.tree_map(lambda x: 2.0 * x, params)
        updates, state = opt.update(grads, state, params)
        params = O.apply_updates(params, updates)
    assert sum(float(v.abs().sum()) for v in tree.leaves(params)) < 0.15


def test_adamw_bf16_states_and_weight_decay():
    opt = O.adamw(1e-2, state_dtype=torch.bfloat16)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor([1.5])}
    state = opt.init(params)
    assert all(m.dtype == torch.bfloat16 for m in tree.leaves(state.mu))
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    updates, state = opt.update(tree.tree_map(lambda x: 2 * x, params),
                                state, params)
    assert all(bool(torch.isfinite(u).all()) for u in tree.leaves(updates))
    opt = O.adamw(1e-2, weight_decay=0.5)
    p = {"w": torch.ones(4)}
    state = opt.init(p)
    for _ in range(10):
        state = opt.update_({"w": torch.zeros(4)}, state, p)
    assert float(p["w"].abs().max()) < 1.0
    assert int(state.step) == 10


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError):
        O.make_optimizer("lion", 1e-3)
    assert O.init_opt_state(O.make_optimizer("sgd", 0.1),
                            {"w": torch.ones(2)}).mu is None


def test_schedules_match_reference():
    steps_ = np.arange(0, 121)
    for peak, warm, total, frac in ((1.0, 10, 110, 0.1), (3e-4, 0, 50, 0.0),
                                    (2.0, 25, 100, 0.3)):
        j = jax.jit(jax.vmap(JS.cosine_with_warmup(peak, warm, total, frac)))
        got = S.cosine_with_warmup(peak, warm, total, frac)(
            torch.from_numpy(steps_.astype(np.int32)))
        _close(got, j(jnp.asarray(steps_, jnp.int32)), rtol=1e-6)
        assert got.dtype == torch.float32
    # a step count held as the optimizer state's 0-d int32 tensor
    s = S.cosine_with_warmup(1.0, warmup_steps=10, total_steps=110)
    assert float(s(torch.tensor(5, dtype=torch.int32))) == pytest.approx(0.5)
    assert float(S.constant(3e-4)(torch.tensor(7))) == pytest.approx(3e-4)
    assert S.constant(3e-4)(10_000).dtype == torch.float32


def test_cosine_with_warmup_shape():
    s = S.cosine_with_warmup(1.0, warmup_steps=10, total_steps=110,
                             final_frac=0.1)
    assert float(s(0)) == 0.0
    assert float(s(10)) == pytest.approx(1.0, abs=1e-6)
    assert 0.1 < float(s(60)) < 1.0
    assert float(s(110)) == pytest.approx(0.1, abs=1e-6)
    vals = [float(s(t)) for t in range(10, 111, 10)]
    assert all(a >= b - 1e-9 for a, b in zip(vals, vals[1:]))


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_global_norm_and_clip_match_reference(max_norm):
    _, np_grads = _tree_pair(seed=3)
    jg = jax.tree.map(jnp.asarray, np_grads)
    g = interop.lm_params(np_grads, CPU)
    _close(S.global_norm(g), JS.global_norm(jg), rtol=1e-6)
    clipped, norm = S.clip_by_global_norm(g, max_norm)
    jclipped, jnorm = jax.jit(JS.clip_by_global_norm,
                              static_argnums=1)(jg, max_norm)
    _close(norm, jnorm, rtol=1e-6)
    for a, b in zip(tree.leaves(clipped), tree.leaves(_np(jclipped))):
        _close(a, b, rtol=1e-6)
    # the reference's own case
    g = {"a": torch.ones(4) * 3.0, "b": torch.ones(9) * 4.0}
    n = float(S.global_norm(g))
    assert n == pytest.approx(np.sqrt(4 * 9 + 9 * 16))
    clipped, pre = S.clip_by_global_norm(g, max_norm=1.0)
    assert float(pre) == pytest.approx(n)
    assert float(S.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = S.clip_by_global_norm({"a": torch.ones(2) * 0.1}, 10.0)
    assert torch.equal(same["a"], torch.ones(2) * 0.1)


# ---------------------------------------------------------------------------
# the model's training forward and the train steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX cfg, port cfg, JAX params, port params, JAX batch, port
    batch) at the reduced size."""
    arch = request.param
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = interop.lm_params(_np(jp), CPU)
    jb = next(j_token_batches(0, batch=2, seq_len=40, vocab=cfg.vocab))
    b = {k: _t(v).long() for k, v in jb.items()}
    return arch, jcfg, cfg, jp, p, jb, b


def test_forward_train_and_loss_match_reference(model):
    _, jcfg, cfg, jp, p, jb, b = model
    logits, aux = T.forward_train(cfg, p, b)
    assert aux == {} and logits.dtype == torch.float32
    jlogits = jax.jit(lambda q: JT.forward_train(jcfg, q, jb)[0])(jp)
    _close(logits, jlogits, rtol=1e-5)
    loss, _ = T.loss_fn(cfg, p, b)
    jloss = jax.jit(lambda q: JT.loss_fn(jcfg, q, jb)[0])(jp)
    _close(loss, jloss, rtol=1e-6)


@pytest.mark.parametrize("remat", [True, "save_ar"])
def test_remat_gradients_equal_no_remat(model, remat):
    _, _, cfg, _, p, _, b = model
    loss0, _, g0 = steps.value_and_grad(
        lambda q: T.loss_fn(cfg, q, b, remat=False), p)
    loss1, _, g1 = steps.value_and_grad(
        lambda q: T.loss_fn(cfg, q, b, remat=remat), p)
    assert torch.equal(loss0, loss1)
    for a, c in zip(tree.leaves(g0), tree.leaves(g1)):
        assert torch.equal(a, c)
    with pytest.raises(ValueError, match="remat"):
        T.loss_fn(cfg, p, b, remat="offload")


def _grad_close(got, want):
    _close(got, want, rtol=1e-4, atol_scale=1e-6)


def test_train_step_float32_matches_reference(model):
    """One step at float32 with SGD at lr 1 and clipping above the norm:
    the loss, `grad_norm`, the gradients themselves and the parameters'
    change (p - p' = g up to the rounding of p') against the reference's
    step."""
    _, jcfg, cfg, jp, p, jb, b = model
    jstep = jax.jit(j_make_train_step(jcfg, JO.sgd(1.0),
                                      compute_dtype=jnp.float32, remat=False,
                                      clip_norm=1e6))
    jp2, _, jm = jstep(jp, JO.sgd(1.0).init(jp), jb)
    jgrads = jax.jit(jax.grad(lambda q: JT.loss_fn(jcfg, q, jb)[0]))(jp)
    mine = tree.tree_map(torch.clone, p)
    step = steps.make_train_step(cfg, O.sgd(1.0), compute_dtype=torch.float32,
                                 remat=False, clip_norm=1e6)
    out, state, m = step(mine, O.sgd(1.0).init(mine), b)
    assert out is mine and int(state.step) == 1
    assert sorted(m) == ["grad_norm", "loss"]
    _close(m["loss"], jm["loss"], rtol=1e-5)
    _close(m["grad_norm"], jm["grad_norm"], rtol=1e-5)
    _, _, grads = steps.value_and_grad(lambda q: T.loss_fn(cfg, q, b), p)
    for (k, g), (_, jg) in zip(tree.flatten_with_path(grads),
                               tree.flatten_with_path(_np(jgrads))):
        _grad_close(g, jg)
    for p0, p1, jp0, jp1 in zip(tree.leaves(p), tree.leaves(out),
                                tree.leaves(_np(jp)), tree.leaves(_np(jp2))):
        _grad_close(p0 - p1, jp0 - jp1)


def _flat(leaves):
    return np.concatenate([np.asarray(x, dtype=np.float64).ravel()
                           for x in leaves])


def test_train_step_bfloat16_matches_reference_bf16(model):
    """The default step (bf16 compute, remat) against the reference's
    default step; the bounds, and the checks that tell bf16 compute from
    float32, are derived in the module docstring."""
    _, jcfg, cfg, jp, p, jb, b = model
    ref, port = {}, {}
    for name, jd, td in (("bf16", jnp.bfloat16, torch.bfloat16),
                         ("f32", jnp.float32, torch.float32)):
        jl, jg = jax.jit(jax.value_and_grad(lambda q: JT.loss_fn(
            jcfg, q, jb, compute_dtype=jd, remat=True)[0]))(jp)
        loss, _, g = steps.value_and_grad(lambda q: T.loss_fn(
            cfg, q, b, compute_dtype=td, remat=True), p)
        ref[name], port[name] = (float(jl), _np(jg)), (float(loss), g)
    (jl, jg), (loss, g) = ref["bf16"], port["bf16"]
    _close(loss, jl, rtol=U_BF16)
    for (k, a), (_, want) in zip(tree.flatten_with_path(g),
                                 tree.flatten_with_path(jg)):
        assert a.dtype == torch.float32
        err = np.linalg.norm(a.double().numpy() - want)
        assert err <= 16 * U_BF16 * np.linalg.norm(want), k
    # the port really computes in bf16: its perturbation is JAX's
    assert abs(loss - jl) <= 0.5 * abs(jl - ref["f32"][0])
    d_port = (_flat(t.double() for t in tree.leaves(g))
              - _flat(t.double() for t in tree.leaves(port["f32"][1])))
    d_ref = _flat(jax.tree.leaves(jg)) - _flat(jax.tree.leaves(ref["f32"][1]))
    ratio = np.linalg.norm(d_port) / np.linalg.norm(d_ref)
    assert 0.5 <= ratio <= 2.0, ratio
    assert d_port @ d_ref >= 0.25 * np.linalg.norm(d_port) * np.linalg.norm(
        d_ref)
    # the step itself runs at its defaults and moves the parameters
    mine = tree.tree_map(torch.clone, p)
    jstep = jax.jit(j_make_train_step(jcfg, JO.sgd(0.1)))
    _, _, jm = jstep(jp, JO.sgd(0.1).init(jp), jb)
    _, _, m = steps.make_train_step(cfg, O.sgd(0.1))(mine,
                                                     O.sgd(0.1).init(mine), b)
    _close(m["loss"], jm["loss"], rtol=U_BF16)
    assert not torch.equal(mine["embed"], p["embed"])


def test_five_adamw_steps_match_reference(model):
    _, jcfg, cfg, jp, p, _, _ = model
    kw = dict(clip_norm=1.0)
    jstep = jax.jit(j_make_train_step(
        jcfg, JO.adamw(3e-3), compute_dtype=jnp.float32, remat=False,
        lr_schedule=JS.cosine_with_warmup(1.0, 2, 5), **kw))
    step = steps.make_train_step(
        cfg, O.adamw(3e-3), compute_dtype=torch.float32, remat=False,
        lr_schedule=S.cosine_with_warmup(1.0, 2, 5), **kw)
    jstate, jlosses = JO.adamw(3e-3).init(jp), []
    mine = tree.tree_map(torch.clone, p)
    state, losses = O.adamw(3e-3).init(mine), []
    jit_, it = (j_token_batches(1, 2, 40, cfg.vocab),
                token_batches(1, 2, 40, cfg.vocab, device=CPU))
    for _ in range(5):
        jp, jstate, jm = jstep(jp, jstate, next(jit_))
        mine, state, m = step(mine, state, next(it))
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert int(state.step) == 5


def test_train_steps_leave_no_reference_cycle(model):
    """A plain and a federated AdamW step free everything they allocate
    when they return, with the cyclic garbage collector off: nothing is
    left for it to find (a cycle through a tree walk once kept a step's
    gradient leaves alive until the collector ran, a whole gradient a step
    on the card)."""
    import gc

    _, _, cfg, _, p, _, b = model
    mine = tree.tree_map(torch.clone, p)
    opt = O.adamw(3e-4)
    plain = steps.make_train_step(cfg, opt, compute_dtype=torch.float32,
                                  remat=False)
    fed = steps.make_fed_train_step(cfg, opt)
    state = opt.init(mine)
    gc.collect()
    gc.disable()
    try:
        mine, state, _ = plain(mine, state, b)
        mine, state, _ = fed(mine, state, b, torch.ones(2))
        assert gc.collect() == 0
    finally:
        gc.enable()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_token_batches_equal_the_reference(seed):
    jit_ = j_token_batches(seed, batch=4, seq_len=32, vocab=100)
    it = token_batches(seed, batch=4, seq_len=32, vocab=100, device=CPU)
    for _ in range(3):
        jb, b = next(jit_), next(it)
        for k in ("tokens", "targets"):
            assert b[k].dtype == torch.int64 and b[k].is_contiguous()
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
        assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_lm_100m_is_ported():
    import dataclasses
    assert "lm-100m" in list_archs()
    cfg = get_config("lm-100m")
    for tc, jc in ((cfg, j_get_config("lm-100m")),
                   (cfg.reduced(), j_get_config("lm-100m").reduced())):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    params = T.init_params(cfg, None, device="meta")
    n = sum(x.numel() for x in tree.leaves(params))
    jshapes = jax.eval_shape(lambda: JT.init_params(
        j_get_config("lm-100m"), jax.random.PRNGKey(0)))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    for (k, a), (_, want) in zip(tree.flatten_with_path(params),
                                 tree.flatten_with_path(jshapes)):
        assert tuple(a.shape) == tuple(want.shape), k


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_train_main_plain_and_federated(tmp_path, capsys):
    base = ["--arch", "granite-8b", "--reduced", "--steps", "3",
            "--batch", "4", "--seq", "24", "--log-every", "1"]
    ckpt = str(tmp_path / "ckpt")
    assert train.main(base + ["--optimizer", "sgd", "--warmup", "2",
                              "--clip-norm", "1.0", "--ckpt-dir", ckpt,
                              "--ckpt-every", "2"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "arch=granite-8b-reduced params=" in out
    assert "step     3 loss" in out and "final loss" in out
    step, restored = restore_checkpoint(ckpt)
    assert step == 2 and "opt/step" in restored
    assert int(restored["opt/step"]) == 2
    res = train.run(base + ["--federated", "--n-clients", "2"], device="cpu")
    out = capsys.readouterr().out
    assert "federated: t*=" in out and "loads=" in out and "sim_wall" in out
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
    assert res["fed"].round_idx == 0  # launch.train samples per step
    assert res["peak_bytes"] is None
    res = train.run(["--arch", "mamba2-1.3b", "--reduced", "--steps", "2",
                     "--batch", "2", "--seq", "20", "--federated"],
                    device="cpu")
    assert "clamping n_clients" in capsys.readouterr().out
    assert res["args"].n_clients == 2


def test_train_main_refuses_what_is_not_ported(capsys, monkeypatch):
    """`--distributed`, once refused, starts no group without a cluster
    environment and says so in the reference's line.  The name is the
    one the test had while `--distributed` was refused."""
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert train.main(["--reduced", "--distributed", "--steps", "1",
                       "--batch", "2", "--seq", "8"], device="cpu") == 0
    assert "distributed: 1 processes (single-host)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    cfg = get_config("granite-8b").reduced()
    assert train.add_modality_stubs({"tokens": 0}, cfg) == {"tokens": 0}
    import dataclasses
    from repro_torch.configs import VLMSpec
    vlm = dataclasses.replace(
        cfg, vlm=VLMSpec(cross_every=2, n_patches=4, d_vision=8))
    batch = train.add_modality_stubs(
        {"tokens": torch.zeros((3, 5), dtype=torch.int64)}, vlm)
    assert batch["patches"].shape == (3, 4, 8)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_vlm_and_audio_train_on_meta_at_the_reference_shapes(arch):
    """`forward_train` and `loss_fn` of the vlm and audio families at full
    width on the meta device, with their stub patches or frames: JAX's
    `eval_shape` of the reference's logits, a scalar loss, and no aux."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    B, S = 2, 6
    stub = (("patches", (B, cfg.vlm.n_patches, cfg.vlm.d_vision)) if cfg.vlm
            else ("frames", (B, cfg.encdec.n_frames, cfg.d_model)))
    params = T.init_params(cfg, None, device="meta")
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int64, device="meta"),
             "targets": torch.zeros((B, S), dtype=torch.int64,
                                    device="meta"),
             stub[0]: torch.empty(stub[1], device="meta")}
    logits, aux = T.forward_train(cfg, params, batch)
    want = jax.eval_shape(lambda: JT.forward_train(
        jcfg, JT.init_params(jcfg, jax.random.PRNGKey(0)),
        {"tokens": jnp.zeros((B, S), jnp.int32),
         stub[0]: jnp.zeros(stub[1])})[0])
    assert tuple(logits.shape) == want.shape == (B, S, cfg.vocab)
    assert logits.dtype == torch.float32 and aux == {}
    loss, _ = T.loss_fn(cfg, params, batch)
    assert loss.shape == () and loss.device.type == "meta"
