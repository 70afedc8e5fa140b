"""The port's hybrid family (Zamba2: a Mamba2 backbone with one
weight-shared [attention + MLP] block after every `attn_every`-th layer)
against the JAX package, on the CPU: `models.transformer` (prefill,
decode_step, loss_fn and its gradients), `launch.serve.greedy_generate`
and `serving.ServeEngine`.

The reduced zamba2-1.2b (d_model 256, 16 Mamba2 heads of 32, d_state
16, chunk 16; 4 attention heads and 2 key/value heads of 64, d_ff 512;
vocab 512) has 2 layers and `attn_every` 2: one use of the shared block
and no tail.  Here both packages take it at 5 layers: two uses (after
layers 2 and 4) and one tail layer after the last use.  JAX's
`init_params(PRNGKey(0))` crosses by `interop.lm_params`.  The port's
prefill takes its kernel wrappers (kernel 7 for every Mamba2 layer,
kernel 8 for every use of the shared block), which compute the plain
versions on CPU tensors; the JAX prefill runs its jnp path.

Bounds, those of `tests/test_torch_lm_serve.py` and
`tests/test_torch_train.py`:
  * logits and caches: rtol 1e-4 and atol 1e-4 * max(1, max|ref|);
  * the loss rtol 1e-6; every gradient leaf (the shared block's, the sum
    over its uses, included) rtol 1e-4 / atol 1e-6 * max(1, max|ref|) of
    the reference's gradient in float64, as the reference's float32 one;
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
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import interop, tree
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve, steps
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine

ARCH = "zamba2-1.2b"
N_LAYERS = 5
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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


def _close_caches(got, want, skip=()):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in got:
        if k not in skip:
            _close(got[k], want[k])


def _prompt(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX params, port config, port params): the reduced
    zamba2 at 5 layers, attn_every 2, on both sides."""
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(),
                               n_layers=N_LAYERS)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=N_LAYERS)
    assert cfg.hybrid.attn_every == 2 and cfg.ssm.chunk == 16
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.lm_params(jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, jparams, cfg, params


def test_tree_and_cache_layout(model):
    """38 Mamba2 layers stacked plus one unstacked shared block at full
    width; reduced, the Mamba2 cache spans all 5 layers and the attention
    cache holds one row per use."""
    _, _, cfg, params = model
    assert params["blocks"]["mixer"]["w_in"].shape[0] == N_LAYERS
    assert params["shared_attn"]["attn"]["wq"].shape == (256, 256)
    cache = T.init_cache(cfg, 3, 20, device="cpu")
    assert cache["mamba"]["ssm"].shape == (N_LAYERS, 3, 16, 32, 16)
    assert cache["attn"]["k"].shape == (2, 3, 20, 2, 64)
    full = T.init_params(get_config(ARCH), None, device="meta")
    assert full["blocks"]["norm"]["scale"].shape == (38, 2048)
    assert full["shared_attn"]["mlp"]["w_up"].shape == (2048, 8192)


@pytest.mark.parametrize("S", [1, 5, 16, 37])
def test_prefill_matches_jax(model, S):
    """Logits and every cache leaf with `cache_len` = S + 4; the conv
    rows of a prompt shorter than d_conv - 1 are R4's (ROADMAP.md) and
    are skipped, as for the ssm family."""
    jcfg, jparams, cfg, params = model
    toks = _prompt(S, (2, S), cfg.vocab)
    logits, cache = T.prefill(cfg, params, {"tokens": torch.as_tensor(toks)},
                              cache_len=S + 4)
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(toks, jnp.int32)},
                                   compute_dtype=jnp.float32,
                                   cache_len=S + 4)
    _close(logits, j_logits)
    _close_caches(cache, j_cache, skip=("mamba.conv",) if S < 3 else ())


def test_decode_steps_match_jax(model):
    """Prefill 21 tokens, then six decode steps fed JAX's greedy tokens:
    logits and both caches after every step."""
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
        _close_caches(cache, j_cache)
        tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1)[:, None]


def test_greedy_generate_matches_jax(model):
    jcfg, jparams, cfg, params = model
    prompt = _prompt(2, (2, 12), cfg.vocab)
    out, _, steps_ = serve.greedy_generate(
        cfg, params, torch.as_tensor(prompt), 8, {}, device="cpu")
    j_out, _, _ = j_serve.greedy_generate(
        jcfg, jparams, jnp.asarray(prompt, jnp.int32), 8, {})
    assert out.tolist() == np.asarray(j_out).tolist()
    assert len(steps_) == 8


def _requests(cls, vocab):
    rng = np.random.default_rng(6)
    return [cls(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=m)
            for i, (n, m) in enumerate(((9, 4), (20, 6), (5, 3), (14, 5)))]


def test_serve_engine_matches_jax(model):
    """Four requests on two slots: the port's engine (one batched decode,
    one position per slot) gives JAX's engine's tokens, and each request
    `greedy_generate`'s on its prompt alone."""
    jcfg, jparams, cfg, params = model
    done = ServeEngine(cfg, params, n_slots=2, max_seq=32,
                       device="cpu").run(_requests(Request, cfg.vocab),
                                         max_steps=100)
    j_done = JServeEngine(jcfg, jparams, n_slots=2, max_seq=32).run(
        _requests(JRequest, cfg.vocab), max_steps=100)
    got = {r.uid: r.out_tokens for r in done}
    assert sorted(got) == [0, 1, 2, 3]
    assert got == {r.uid: r.out_tokens for r in j_done}
    for r in done:
        out, _, _ = serve.greedy_generate(
            cfg, params, torch.as_tensor(r.prompt, dtype=torch.int64)[None],
            r.max_new_tokens, {}, device="cpu")
        assert r.out_tokens == out[0, len(r.prompt):].tolist()


def _stub_library(monkeypatch, ops, entry):
    """A stub kernel library for CPU tensors (the kernel route forced)."""
    from unittest import mock

    lib = mock.MagicMock()
    getattr(lib, entry).return_value = 0
    monkeypatch.setattr(ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))
    return lib


def test_prefill_launches_both_kernels(model, monkeypatch):
    """With both kernel routes forced (stub libraries for CPU tensors),
    one prefill launches kernel 7 once per Mamba2 layer and kernel 8 once
    per use of the shared block, never reaching a plain version; decode
    launches nothing."""
    _, _, cfg, params = model

    def plain(*args):
        raise AssertionError("a plain version ran on the kernel route")

    ssd_lib = _stub_library(monkeypatch, ssd_ops, "ssd_chunk_launch")
    fa_lib = _stub_library(monkeypatch, fa_ops, "flash_attn_launch")
    monkeypatch.setattr(ssd_ops.ref, "ssd_chunk_reference", plain)
    monkeypatch.setattr(fa_ops.ref, "causal_attention", plain)
    toks = torch.as_tensor(_prompt(3, (1, 20), cfg.vocab))
    before = (ssd_ops.SSD_COUNTER.launches, fa_ops.FLASH_COUNTER.launches)
    _, cache = T.prefill(cfg, params, {"tokens": toks}, cache_len=21)
    after = (ssd_ops.SSD_COUNTER.launches, fa_ops.FLASH_COUNTER.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (N_LAYERS, 2)
    assert ssd_lib.ssd_chunk_launch.call_count == N_LAYERS
    assert fa_lib.flash_attn_launch.call_count == 2
    # (B, nc, Q, H, P, G, N): 20 tokens in 2 chunks; (B, Hq, Hkv, S, D)
    assert {c.args[7:14] for c in ssd_lib.ssd_chunk_launch.call_args_list} \
        == {(1, 2, 16, 16, 32, 1, 16)}
    assert {c.args[4:9] for c in fa_lib.flash_attn_launch.call_args_list} \
        == {(1, 4, 2, 20, 64)}
    T.decode_step(cfg, params, {"token": toks[:, :1], "pos": 20}, cache)
    assert (ssd_ops.SSD_COUNTER.launches,
            fa_ops.FLASH_COUNTER.launches) == after


def test_loss_and_gradients_match_jax(model):
    """`loss_fn` against the reference's, and the gradient of every leaf,
    the shared block's (the sum over its two uses) included, against the
    reference's gradient computed in float64 (`jax.enable_x64`, the
    parameters and compute dtype float64) within the stated bound, which
    the reference's own float32 gradient meets as well, and against that
    float32 gradient within the same bound.  The embedding gradient sits
    nearest it (~0.88 of it against the float32 gradient, each of the two
    at ~0.7 of it from the float64 value), where the two packages'
    rounding of the backward pass adds; it sat past it (1.09) while the
    port's rope tables were torch's float32 cos and sin (ROADMAP.md §3).
    `pytest -s` prints the shares.  Remat gives the same gradients bit
    for bit."""
    jcfg, jparams, cfg, params = model
    jb = next(j_token_batches(0, batch=2, seq_len=40, vocab=cfg.vocab))
    b = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    loss, aux, grads = steps.value_and_grad(
        lambda q: T.loss_fn(cfg, q, b), params)
    assert aux == {}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: JT.loss_fn(jcfg, q, jb)[0]))(jparams)
    _close(loss, jloss, rtol=1e-6, atol_scale=0.0)
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                            jparams)
        g64 = jax.jit(jax.grad(lambda q: JT.loss_fn(
            jcfg, q, jb, compute_dtype=jnp.float64)[0]))(jp64)
        g64 = dict(tree.flatten_with_path(jax.tree.map(np.asarray, g64)))
    j32 = dict(tree.flatten_with_path(jax.tree.map(np.asarray, jgrads)))
    flat = dict(tree.flatten_with_path(grads))
    assert sorted(flat) == sorted(g64) == sorted(j32)
    assert any(k.startswith("shared_attn/") for k in flat)
    assert all(v.dtype == np.float64 for v in g64.values())
    shares = {name: max(_grad_share(got[k], g64[k]) for k in flat)
              for name, got in (("port", flat), ("reference float32", j32))}
    shares["port vs reference float32"] = max(
        _grad_share(flat[k], j32[k]) for k in flat)
    print("gradient leaves, worst share of rtol 1e-4 / atol 1e-6 * "
          "max(1, max|ref|): " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in shares.items()))
    for k, g in flat.items():
        _close(g, g64[k], rtol=1e-4, atol_scale=1e-6)
        _close(j32[k], g64[k], rtol=1e-4, atol_scale=1e-6)
        _close(g, j32[k], rtol=1e-4, atol_scale=1e-6)
    _, _, again = steps.value_and_grad(
        lambda q: T.loss_fn(cfg, q, b, remat=True), params)
    assert all(torch.equal(a, c) for a, c in
               zip(tree.leaves(grads), tree.leaves(again)))


def _grad_share(got, want) -> float:
    """The largest |got - want| over rtol 1e-4 |want| + 1e-6 max(1,
    max|want|)."""
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, dtype=np.float64))
    want = np.asarray(want, dtype=np.float64)
    bound = 1e-4 * np.abs(want) + 1e-6 * max(1.0, float(np.abs(want).max()))
    return float((np.abs(got - want) / bound).max())


def test_rounding_of_both_kernels_moves_deep_logits_inside_the_bound(
        monkeypatch):
    """How far rounding-level changes of the intra-chunk step and of the
    attention core move the logits of a deep hybrid prefill: the scale
    that `chip_smoke.py`'s bound on the zamba2 kernel prefill against the
    plain one (HYBRID_LOGIT_RTOL, 1e-3 of max(1, max|logit|)) has to
    allow for.

    zamba2's 38 layers and attn_every 6 (six uses of the shared block) at
    d_model 512 (16 Mamba2 heads of 64, d_state 64, chunk 256; 8
    attention heads of 64 with 8 key/value heads, d_ff 1024; vocab 1024;
    weights from seed 0) prefill one 512-token prompt with the plain
    float32 steps, then with both computed in float64 and rounded to
    float32.  `pytest -s` prints the reading.
    """
    cfg = dataclasses.replace(get_config(ARCH), d_model=512, n_heads=8,
                              n_kv_heads=8, d_ff=1024, vocab=1024)
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, device="cpu")
    toks = {"tokens": torch.randint(0, cfg.vocab, (1, 512), generator=gen)}
    plain, _ = T.prefill(cfg, params, toks)

    def ssd_float64(xc, dtc, da, bc, cc):
        y, states, _, _ = ssd_ops.ref.float64_reference_and_bound(
            xc, dtc, da, bc, cc)
        return y.float(), states.float()

    def attn_float64(q, k, v):
        o64, _ = fa_ops.ref.float64_reference_and_bound(q, k, v)
        return o64.float()

    monkeypatch.setattr(ssd_ops.ref, "ssd_chunk_reference", ssd_float64)
    monkeypatch.setattr(fa_ops.ref, "causal_attention", attn_float64)
    other, _ = T.prefill(cfg, params, toks)
    diff = float((plain - other).abs().max())
    top = float(plain.abs().max())
    print(f"max|logit| {top!r}, max |logit difference| {diff!r} "
          f"({diff / top!r} of max)")
    assert 0.0 < diff <= 1e-3 * max(1.0, top)
    assert int(plain.argmax()) == int(other.argmax())
