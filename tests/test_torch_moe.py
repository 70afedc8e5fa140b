"""The port's moe family against the JAX package, on the CPU:
`models.moe` (`moe_ffn`, `_top_k_mask`, the dispatch group), and
`models.transformer` with the reduced phi3.5-moe (2 MoE layers, `every`
1, 4 experts top-2) and the reduced llama4-maverick (one dense layer
then one MoE layer, `every` 2, 4 experts top-1): prefill, decode_step,
`launch.serve.greedy_generate`, `serving.ServeEngine`, `loss_fn` with
the aux term and its gradients, `launch.steps.make_train_step`'s
`moe_aux_loss` and `make_fed_grad_fn` against the reference's federated
step.  Both reduced configs: d_model 256, 4 heads and 2 key/value heads
of 64, per-expert d_ff 512, vocab 512, group 64.  JAX's
`init_params(PRNGKey(0))` crosses by `interop.lm_params`.

Bounds, those of `tests/test_torch_lm_serve.py` and
`tests/test_torch_train.py`:
  * `moe_ffn`'s output, logits and caches: rtol 1e-4 and atol 1e-4 *
    max(1, max|ref|); the aux and z losses rtol 1e-5; `dropped_frac`
    equal (a count);
  * the loss rtol 1e-6 (the federated and train steps' rtol 1e-5, as in
    `tests/test_torch_fed_trainer.py`), every gradient leaf and the
    parameters' change under SGD at lr 1 rtol 1e-4 / atol 1e-6 *
    max(1, max|ref|);
  * tokens (greedy_generate, the engine): equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.synthetic import token_batches as j_token_batches
from repro.launch import serve as j_serve
from repro.launch.steps import make_fed_train_step as j_make_fed_step
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import interop, tree
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.serving import Request, ServeEngine

PHI = "phi3.5-moe-42b-a6.6b"
MAVERICK = "llama4-maverick-400b-a17b"
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _close(got, want, rtol=1e-4, atol_scale=None):
    want = np.asarray(want, dtype=np.float64)
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, dtype=np.float64))
    assert got.shape == want.shape
    top = max(1.0, float(np.abs(want).max()))
    atol = (atol_scale if atol_scale is not None else rtol) * top
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _leaves(tree_, prefix=""):
    out = {}
    for k, v in tree_.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _prompt(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _ffn_case(seed, B, S, capacity_factor=2.0, zero_router=False):
    """(JAX dims, port dims, JAX params, port params, x) at the reduced
    phi3.5-moe's widths: 4 experts, top-2, d_model 256, d_ff 512, group
    64."""
    dims = dict(n_experts=4, top_k=2, d_model=256, d_ff=512, group_size=64,
                capacity_factor=capacity_factor)
    jdims, tdims = JM.MoEDims(**dims), M.MoEDims(**dims)
    jp = JM.init_moe(jax.random.PRNGKey(seed), jdims, jnp.float32)
    if zero_router:
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    x = np.random.default_rng(seed).standard_normal((B, S, 256)).astype(
        np.float32)
    return jdims, tdims, jp, interop.lm_params(_np(jp), CPU), x


def _hold_ffn(jdims, tdims, jp, p, x):
    y, aux = M.moe_ffn(p, torch.from_numpy(x), tdims)
    jy, jaux = JM.moe_ffn(jp, jnp.asarray(x), jdims)
    _close(y, jy)
    assert sorted(aux) == sorted(jaux) == ["aux_loss", "dropped_frac",
                                           "z_loss"]
    for k in ("aux_loss", "z_loss"):
        _close(aux[k], jaux[k], rtol=1e-5, atol_scale=0.0)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    return aux


@pytest.mark.parametrize("B,S,group", [(2, 37, 2), (1, 96, 32)])
def test_moe_ffn_matches_jax(B, S, group):
    """74 tokens (group 64 halves to 2) and 96 (64 halves to 32): the
    output and the aux terms; nothing dropped at capacity factor 2."""
    case = _ffn_case(B + S, B, S)
    assert M.group_size(case[1], B * S) == group
    aux = _hold_ffn(*case)
    assert float(aux["dropped_frac"]) == 0.0


def test_moe_ffn_drops_tokens_like_jax():
    """At capacity factor 0.5 (a capacity of 16 in a group of 64 for 128
    (token, choice) pairs over 4 experts) overflowing tokens drop: their
    slot row is all zeros, as `jax.nn.one_hot` makes it; the output and
    `dropped_frac` equal JAX's."""
    case = _ffn_case(3, 2, 64, capacity_factor=0.5)
    assert case[1].capacity(64) == 16
    aux = _hold_ffn(*case)
    assert 0.0 < float(aux["dropped_frac"]) < 1.0


def test_zero_router_selects_every_expert():
    """A zero router: every expert ties at 1/E, so `_top_k_mask` selects
    all four (not top-2) with equal gates, as the reference's; at
    capacity factor 4 (a capacity of 128) no token drops, and every
    token's (token, choice) count is 4 = 2 k, so `dropped_frac` is -1."""
    case = _ffn_case(4, 1, 64, capacity_factor=4.0, zero_router=True)
    probs = torch.full((3, 4), 0.25)
    mask, gates = M._top_k_mask(probs, 2)
    jmask, jgates = JM._top_k_mask(jnp.asarray(probs.numpy()), 2)
    assert mask.tolist() == np.asarray(jmask).tolist() == [[1.0] * 4] * 3
    assert gates.tolist() == np.asarray(jgates).tolist() == [[0.25] * 4] * 3
    aux = _hold_ffn(*case)
    assert float(aux["dropped_frac"]) == -1.0


def test_group_size_halves_until_it_divides():
    dims = M.MoEDims(16, 2, 4096, 6400)
    assert [M.group_size(dims, t) for t in (2048, 1537, 3000, 100, 1)] == \
        [2048, 1537, 8, 100, 1]
    assert dims.capacity(2048) == 512 and dims.capacity(1537) == 384
    decode = dataclasses.replace(dims, capacity_factor=16.0)
    assert decode.capacity(4) == 8  # k * group: nothing drops


# ---------------------------------------------------------------------------
# the moe family in models.transformer
# ---------------------------------------------------------------------------

def _build(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, interop.lm_params(_np(jparams), CPU)


@pytest.fixture(scope="module", params=[PHI, MAVERICK])
def model(request):
    return _build(request.param)


def test_tree_layout(model):
    """phi: MoE blocks only; maverick: one dense block and one MoE block;
    the router float32."""
    _, _, cfg, params = model
    every = cfg.moe.every
    assert params["moe_blocks"]["moe"]["w_gate"].shape == (
        cfg.n_layers // every, 4, 256, 512)
    assert params["moe_blocks"]["moe"]["router"].dtype == torch.float32
    assert ("blocks" in params) == (every > 1)
    bf = T.init_params(cfg, None, dtype=torch.bfloat16, device="meta")
    assert bf["moe_blocks"]["moe"]["router"].dtype == torch.float32
    assert bf["moe_blocks"]["moe"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("S", [1, 37])
def test_prefill_matches_jax(model, S):
    """Logits and the attention cache (in layer order: maverick's dense
    layer's row first) with `cache_len` = S + 4."""
    jcfg, jparams, cfg, params = model
    toks = _prompt(S, (2, S), cfg.vocab)
    logits, cache = T.prefill(cfg, params, {"tokens": torch.as_tensor(toks)},
                              cache_len=S + 4)
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(toks, jnp.int32)},
                                   compute_dtype=jnp.float32,
                                   cache_len=S + 4)
    _close(logits, j_logits)
    got, want = _leaves(cache), _leaves(j_cache)
    assert sorted(got) == sorted(want) == ["attn.k", "attn.v"]
    for k in got:
        _close(got[k], want[k])


def test_decode_steps_match_jax(model):
    """Prefill 21 tokens, then six decode steps fed JAX's greedy tokens."""
    jcfg, jparams, cfg, params = model
    toks = _prompt(1, (2, 21), cfg.vocab)
    _, cache = T.prefill(cfg, params, {"tokens": torch.as_tensor(toks)},
                         cache_len=27)
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(toks, jnp.int32)},
                                   compute_dtype=jnp.float32, cache_len=27)
    j_decode = jax.jit(lambda p, b, c: JT.decode_step(
        jcfg, p, b, c, compute_dtype=jnp.float32))
    tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1)[:, None]
    for i in range(6):
        logits, cache = T.decode_step(
            cfg, params, {"token": torch.as_tensor(tok), "pos": 21 + i}, cache)
        j_logits, j_cache = j_decode(
            jparams, {"token": jnp.asarray(tok, jnp.int32),
                      "pos": jnp.asarray(21 + i, jnp.int32)}, j_cache)
        _close(logits, j_logits)
        for k in ("k", "v"):
            _close(cache["attn"][k], j_cache["attn"][k])
        tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1)[:, None]


def test_greedy_generate_matches_jax(model):
    jcfg, jparams, cfg, params = model
    prompt = _prompt(2, (2, 12), cfg.vocab)
    out, _, _ = serve.greedy_generate(cfg, params, torch.as_tensor(prompt),
                                      8, {}, device="cpu")
    j_out, _, _ = j_serve.greedy_generate(
        jcfg, jparams, jnp.asarray(prompt, jnp.int32), 8, {})
    assert out.tolist() == np.asarray(j_out).tolist()


def _requests(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=m)
            for i, (n, m) in enumerate(((9, 4), (20, 6), (5, 3), (14, 5)))]


def test_serve_engine_matches_jax(model):
    """Four requests on three slots: the port's batched decode (one
    dispatch group of three rows at a capacity that drops nothing) gives
    the tokens of JAX's engine, which decodes each slot alone, and of
    `greedy_generate` on each prompt alone."""
    jcfg, jparams, cfg, params = model
    done = ServeEngine(cfg, params, n_slots=3, max_seq=32,
                       device="cpu").run(_requests(Request, cfg.vocab),
                                         max_steps=100)
    j_done = JServeEngine(jcfg, jparams, n_slots=3, max_seq=32).run(
        _requests(JRequest, cfg.vocab), max_steps=100)
    got = {r.uid: r.out_tokens for r in done}
    assert sorted(got) == [0, 1, 2, 3]
    assert got == {r.uid: r.out_tokens for r in j_done}
    for r in done:
        out, _, _ = serve.greedy_generate(
            cfg, params, torch.as_tensor(r.prompt, dtype=torch.int64)[None],
            r.max_new_tokens, {}, device="cpu")
        assert r.out_tokens == out[0, len(r.prompt):].tolist()


def test_prefill_launches_kernel_8_once_per_layer(model, monkeypatch):
    """With the kernel route forced (a stub library for CPU tensors) a
    prefill launches kernel 8 once per attention layer, dense or MoE, and
    never reaches its plain version; decode launches nothing."""
    from unittest import mock

    _, _, cfg, params = model
    lib = mock.MagicMock()
    lib.flash_attn_launch.return_value = 0
    monkeypatch.setattr(fa_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(fa_ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))

    def plain(*args):
        raise AssertionError("the plain version ran on the kernel route")

    monkeypatch.setattr(fa_ops.ref, "causal_attention", plain)
    toks = torch.as_tensor(_prompt(3, (1, 20), cfg.vocab))
    before = fa_ops.FLASH_COUNTER.launches
    _, cache = T.prefill(cfg, params, {"tokens": toks}, cache_len=21)
    assert fa_ops.FLASH_COUNTER.launches == before + cfg.n_layers
    assert {c.args[4:9] for c in lib.flash_attn_launch.call_args_list} == {
        (1, 4, 2, 20, 64)}
    T.decode_step(cfg, params, {"token": toks[:, :1], "pos": 20}, cache)
    assert fa_ops.FLASH_COUNTER.launches == before + cfg.n_layers


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0, batch=2):
    jb = next(j_token_batches(seed, batch=batch, seq_len=40,
                              vocab=cfg.vocab))
    return jb, {k: torch.from_numpy(np.array(v)).long()
                for k, v in jb.items()}


def _grad_close(got, want):
    _close(got, want, rtol=1e-4, atol_scale=1e-6)


def test_loss_and_gradients_match_jax(model):
    """`loss_fn` (next-token loss + 0.01 x moe_aux_loss), its aux and the
    gradient of every leaf, the router's included, against the
    reference's."""
    jcfg, jparams, cfg, params = model
    jb, b = _batch(cfg)
    loss, aux, grads = steps.value_and_grad(
        lambda q: T.loss_fn(cfg, q, b), params)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda q: JT.loss_fn(jcfg, q, jb), has_aux=True))(jparams)
    assert sorted(aux) == sorted(jaux) == ["moe_aux_loss"]
    _close(aux["moe_aux_loss"], jaux["moe_aux_loss"], rtol=1e-5,
           atol_scale=0.0)
    _close(loss, jloss, rtol=1e-6, atol_scale=0.0)
    logits, _ = T.forward_train(cfg, params, b)
    plain = torch.mean(T.token_nll(logits, b["targets"]))
    assert torch.allclose(loss, plain + 0.01 * aux["moe_aux_loss"])
    flat, jflat = tree.flatten_with_path(grads), tree.flatten_with_path(
        _np(jgrads))
    assert [k for k, _ in flat] == [k for k, _ in jflat]
    assert float(dict(flat)["moe_blocks/moe/router"].abs().max()) > 0
    for (k, g), (_, jg) in zip(flat, jflat):
        _grad_close(g, jg)


def test_train_step_reports_moe_aux_loss(model):
    """`make_train_step`'s metrics carry `moe_aux_loss` as the
    reference's; the loss and the SGD change at lr 1 match."""
    jcfg, jparams, cfg, params = model
    jb, b = _batch(cfg, seed=1)
    jstep = jax.jit(j_make_train_step(jcfg, JO.sgd(1.0),
                                      compute_dtype=jnp.float32,
                                      remat=False))
    jp2, _, jm = jstep(jparams, JO.sgd(1.0).init(jparams), jb)
    mine = tree.tree_map(torch.clone, params)
    step = steps.make_train_step(cfg, O.sgd(1.0), compute_dtype=torch.float32,
                                 remat=False)
    out, _, m = step(mine, O.sgd(1.0).init(mine), b)
    assert sorted(m) == sorted(jm) == ["loss", "moe_aux_loss"]
    assert not m["moe_aux_loss"].requires_grad
    _close(m["loss"], jm["loss"], rtol=1e-5, atol_scale=0.0)
    _close(m["moe_aux_loss"], jm["moe_aux_loss"], rtol=1e-5, atol_scale=0.0)
    for p0, p1, j0, j1 in zip(tree.leaves(params), tree.leaves(out),
                              tree.leaves(_np(jparams)),
                              tree.leaves(_np(jp2))):
        _grad_close(p0 - p1, j0 - j1)


def test_fed_grad_fn_matches_the_reference_federated_step(model):
    """`make_fed_grad_fn`: the deadline-masked loss plus 0.01 x the aux
    loss of the whole batch's forward, as the reference's federated step
    computes it; the loss and the gradients (its SGD change at lr 1)."""
    jcfg, jparams, cfg, params = model
    jb, b = _batch(cfg, seed=3, batch=4)
    w = np.array([0.0, 1.5, 0.0, 1.0], np.float32)
    jp2, _, jm = jax.jit(j_make_fed_step(jcfg, JO.sgd(1.0)))(
        jparams, JO.sgd(1.0).init(jparams), jb, jnp.asarray(w))
    loss, grads = steps.make_fed_grad_fn(cfg)(params, b, torch.from_numpy(w))
    _close(loss, jm["loss"], rtol=1e-5, atol_scale=0.0)
    logits, aux = T.forward_train(cfg, params, b)
    per_seq = torch.mean(T.token_nll(logits, b["targets"]), dim=-1)
    masked = torch.sum(per_seq * torch.from_numpy(w)) / 2
    assert torch.allclose(loss, masked + 0.01 * aux["moe_aux_loss"])
    for g, j0, j1 in zip(tree.leaves(grads), tree.leaves(_np(jparams)),
                         tree.leaves(_np(jp2))):
        _grad_close(g, j0 - j1)


def test_train_main_reports_moe_aux_loss(capsys):
    res = train.run(["--arch", PHI, "--reduced", "--steps", "3", "--batch",
                     "2", "--seq", "24", "--log-every", "1"], device="cpu")
    assert sorted(res["metrics"]) == ["loss", "moe_aux_loss"]
    assert np.isfinite(res["metrics"]["moe_aux_loss"])
    assert "arch=phi3.5-moe-42b-a6.6b-reduced" in capsys.readouterr().out
