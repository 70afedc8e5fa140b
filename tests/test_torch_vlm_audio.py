"""The port's vlm family (Llama-3.2-Vision: groups of self blocks, each
followed by a gated cross-attention block over stub patch embeddings)
and audio family (Whisper: an encoder of unmasked self blocks over stub
frame embeddings, then a decoder of self and gated cross blocks) against
the JAX package, on the CPU: `models.layers` (cross_attention,
cross_attention_cached, project_cross_kv, unmasked self-attention),
`models.transformer` (forward_train, loss_fn and its gradients, prefill
and its caches, decode_step), and of the port alone
`launch.serve.greedy_generate` against step-wise decoding and
`launch.train.add_modality_stubs`.

The reduced llama-3.2-vision-11b (d_model 256, 4 heads and 2 key/value
heads of 64, d_ff 512, vocab 512) is taken here at 6 layers with
cross_every 3 (two groups of two self layers, so the self-cache row
order g * 2 + j is held), 16 patches of d_vision 192 (`reduced()` sets
d_vision = d_model, which would hide a transposed `wk`/`wv`).  The
reduced whisper-tiny has 2 decoder and 2 encoder layers, 24 frames,
LayerNorm and the tanh GELU.  JAX's `init_params(PRNGKey(0))` crosses by
`interop.lm_params`, and every cross block's `gate` (0 at init, which
would zero the cross path) is set to 0.5 + U(0, 1) in both packages.
The port's prefill takes kernel 8's wrapper on its causal decoder
self-attention, which computes the plain version on CPU tensors.

Bounds, those of `tests/test_torch_lm_serve.py` and
`tests/test_torch_train.py`:
  * logits and caches: rtol 1e-4 and atol 1e-4 * max(1, max|ref|);
  * the loss rtol 1e-6; every gradient leaf rtol 1e-4 / atol 1e-6 *
    max(1, max|ref|) of the reference's gradient in float64, as the
    reference's float32 one;
  * tokens: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import VLMSpec as JVLMSpec
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop, tree
from repro_torch.configs import VLMSpec, get_config
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
VLM_LAYERS, CROSS_EVERY, N_PATCHES, D_VISION = 6, 3, 16, 192
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


def _close_trees(got, want):
    got = dict(tree.flatten_with_path(got))
    want = dict(tree.flatten_with_path(jax.tree.map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k])


def _configs(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    if arch == VLM:
        jcfg = dataclasses.replace(jcfg, n_layers=VLM_LAYERS, vlm=JVLMSpec(
            cross_every=CROSS_EVERY, n_patches=N_PATCHES, d_vision=D_VISION))
        cfg = dataclasses.replace(cfg, n_layers=VLM_LAYERS, vlm=VLMSpec(
            cross_every=CROSS_EVERY, n_patches=N_PATCHES, d_vision=D_VISION))
    return jcfg, cfg


def _stubs(cfg, B, seed):
    """0.1 * N(0, 1) patches or frames from NumPy, as float32."""
    rng = np.random.default_rng(seed)
    if cfg.vlm:
        return {"patches": (0.1 * rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.d_vision))).astype(np.float32)}
    return {"frames": (0.1 * rng.standard_normal(
        (B, cfg.encdec.n_frames, cfg.d_model))).astype(np.float32)}


def _batches(cfg, tokens, seed):
    """The same batch for both packages: int32 / float32 arrays for JAX,
    int64 / float32 tensors for the port."""
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in tokens.items()}
    b = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in tokens.items()}
    for k, v in _stubs(cfg, next(iter(tokens.values())).shape[0],
                       seed).items():
        jb[k], b[k] = jnp.asarray(v), torch.from_numpy(v)
    return jb, b


@pytest.fixture(scope="module", params=[VLM, AUDIO])
def model(request):
    """(JAX config, JAX params, port config, port params), every gate set
    to 0.5 + U(0, 1) in both."""
    jcfg, cfg = _configs(request.param)
    jparams = jax.tree.map(np.asarray,
                           JT.init_params(jcfg, jax.random.PRNGKey(0)))
    gate = jparams["cross_blocks"]["gate"]
    jparams["cross_blocks"]["gate"] = (0.5 + np.random.default_rng(7).random(
        gate.shape)).astype(np.float32)
    params = interop.lm_params(jparams, CPU)
    return jcfg, jax.tree.map(jnp.asarray, jparams), cfg, params


def _prompt(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_cross_and_unmasked_attention_match_jax():
    """`cross_attention`, `project_cross_kv` + `cross_attention_cached`
    over a memory of width 96 != d_model 128 (4 heads, 2 key/value heads
    of 32), and `self_attention(causal=False)` (roped, unmasked), against
    the reference's layers on the same weights and inputs."""
    d, dv, hq, hkv, hd = 128, 96, 4, 2, 32
    heads = {"n_heads": hq, "n_kv_heads": hkv, "head_dim": hd}
    rng = np.random.default_rng(5)

    def weights(kv_in):  # N(0, 1) / sqrt(fan_in), the reference's shapes
        shapes = {"wq": (d, hq * hd), "wk": (kv_in, hkv * hd),
                  "wv": (kv_in, hkv * hd), "wo": (hq * hd, d)}
        return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(
            np.float32) for k, s in shapes.items()}

    jp, js = weights(dv), weights(d)
    p, ps = (interop.lm_params(t, CPU) for t in (jp, js))
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    mem = rng.standard_normal((2, 11, dv)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7)).copy()

    @jax.jit
    def reference(x, mem, pos):
        k, v = JL.project_cross_kv(jp, mem, n_kv_heads=hkv, head_dim=hd)
        return (JL.cross_attention(jp, x, mem, **heads), k, v,
                JL.cross_attention_cached(jp, x[:, :1], k, v, **heads),
                JL.self_attention(js, x, pos, theta=1e4, causal=False,
                                  **heads))

    want = reference(x, mem, pos)
    x, mem, pos = (torch.from_numpy(a) for a in (x, mem, pos))
    k, v = L.project_cross_kv(p, mem, n_kv_heads=hkv, head_dim=hd)
    got = L.self_attention(ps, x, pos, theta=1e4, causal=False, **heads)
    for a, b in zip((L.cross_attention(p, x, mem, **heads), k, v,
                     L.cross_attention_cached(p, x[:, :1], k, v, **heads),
                     got), want):
        _close(a, b)
    # the encoder's self-attention is roped at positions 0..S-1, unmasked
    causal = L.self_attention(ps, x, pos, theta=1e4, **heads)
    assert not torch.allclose(causal[:, :-1], got[:, :-1])
    torch.testing.assert_close(causal[:, -1], got[:, -1], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def test_tree_and_cache_layout(model):
    """The reduced trees' stacks and the caches of `init_cache`: the vlm's
    self cache one row per self layer of its groups and its cross cache
    one row per group over the patches; the audio's one row per decoder
    layer, the cross cache over the frames."""
    _, _, cfg, params = model
    cache = T.init_cache(cfg, 3, 20, device="cpu")
    if cfg.vlm:
        assert params["blocks"]["attn"]["wq"].shape[0] == 4
        assert tuple(params["cross_blocks"]["attn"]["wk"].shape) == (
            2, D_VISION, 128)
        assert cache["attn"]["k"].shape == (4, 3, 20, 2, 64)
        assert cache["cross"]["v"].shape == (2, 3, N_PATCHES, 2, 64)
    else:
        assert params["enc_blocks"]["attn"]["wq"].shape[0] == 2
        assert "bias" in params["enc_norm"]
        assert cache["attn"]["k"].shape == (2, 3, 20, 2, 64)
        assert cache["cross"]["k"].shape == (2, 3, 24, 2, 64)
    assert not any(bool(t.any()) for t in tree.leaves(cache))


def _grad_share(got, want) -> float:
    """The largest |got - want| over rtol 1e-4 |want| + 1e-6 max(1,
    max|want|)."""
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, dtype=np.float64))
    want = np.asarray(want, dtype=np.float64)
    bound = 1e-4 * np.abs(want) + 1e-6 * max(1.0, float(np.abs(want).max()))
    return float((np.abs(got - want) / bound).max())


def test_forward_loss_and_gradients_match_jax(model):
    """`forward_train`'s logits, `loss_fn`, and the gradient of every leaf
    (the gates and the cross blocks' K/V projections among them) against
    the reference's gradient computed in float64 (`jax.enable_x64`, the
    parameters, stubs and compute dtype float64) within the stated bound,
    which the reference's own float32 gradient meets as well.  Against
    that float32 gradient the vlm's embedding gradient sits past the
    bound (one element, ROADMAP.md §3), as the hybrid family's did: the
    two packages' float32 rounding of the backward pass adds there.
    `pytest -s` prints the shares."""
    jcfg, jparams, cfg, params = model
    toks = _prompt(0, (2, 13), cfg.vocab)
    jb, b = _batches(cfg, {"tokens": toks[:, :-1], "targets": toks[:, 1:]},
                     1)
    logits, aux = T.forward_train(cfg, params, b)
    assert aux == {}
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        lambda q, bb: (JT.loss_fn(jcfg, q, bb)[0],
                       JT.forward_train(jcfg, q, bb)[0]),
        has_aux=True))(jparams, jb)
    _close(logits, jlogits)
    loss, _, grads = steps.value_and_grad(
        lambda q: T.loss_fn(cfg, q, b), params)
    _close(loss, jloss, rtol=1e-6, atol_scale=0.0)
    with jax.enable_x64(True):
        to64 = lambda a: (jnp.asarray(np.asarray(a), jnp.float64)  # noqa
                          if np.asarray(a).dtype == np.float32 else a)
        g64 = jax.jit(jax.grad(lambda q, bb: JT.loss_fn(
            jcfg, q, bb, compute_dtype=jnp.float64)[0]))(
                jax.tree.map(to64, jparams), jax.tree.map(to64, jb))
        g64 = dict(tree.flatten_with_path(jax.tree.map(np.asarray, g64)))
    j32 = dict(tree.flatten_with_path(jax.tree.map(np.asarray, jgrads)))
    flat = dict(tree.flatten_with_path(grads))
    assert sorted(flat) == sorted(g64) == sorted(j32)
    assert all(v.dtype == np.float64 for v in g64.values())
    assert float(flat["cross_blocks/gate"].abs().min()) > 0.0
    shares = {name: max(_grad_share(got[k], g64[k]) for k in flat)
              for name, got in (("port", flat), ("reference float32", j32))}
    shares["port vs reference float32"] = max(
        _grad_share(flat[k], j32[k]) for k in flat)
    print(f"{cfg.name} gradient leaves, worst share of rtol 1e-4 / atol "
          "1e-6 * max(1, max|ref|): " + ", ".join(
              f"{k} {v:.3f}" for k, v in shares.items()))
    for k, g in flat.items():
        _close(g, g64[k], rtol=1e-4, atol_scale=1e-6)
        _close(j32[k], g64[k], rtol=1e-4, atol_scale=1e-6)


def test_prefill_and_decode_match_jax(model):
    """Prefill 9 tokens with `cache_len` 12: logits and every cache leaf
    (self and cross), then 3 decode steps fed JAX's greedy tokens: logits
    and every cache leaf after each."""
    jcfg, jparams, cfg, params = model
    jb, b = _batches(cfg, {"tokens": _prompt(1, (2, 9), cfg.vocab)}, 2)
    logits, cache = T.prefill(cfg, params, b, cache_len=12)
    j_logits, j_cache = JT.prefill(jcfg, jparams, jb,
                                   compute_dtype=jnp.float32, cache_len=12)
    _close(logits, j_logits)
    _close_trees(cache, j_cache)
    j_decode = jax.jit(lambda p, bb, c: JT.decode_step(
        jcfg, p, bb, c, compute_dtype=jnp.float32))
    tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1)[:, None]
    for i in range(3):
        logits, cache = T.decode_step(
            cfg, params, {"token": torch.as_tensor(tok), "pos": 9 + i}, cache)
        j_logits, j_cache = j_decode(
            jparams, {"token": jnp.asarray(tok, jnp.int32),
                      "pos": jnp.asarray(9 + i, jnp.int32)}, j_cache)
        _close(logits, j_logits)
        _close_trees(cache, j_cache)
        tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1)[:, None]


def test_greedy_generate_equals_stepwise_decode(model):
    """`greedy_generate` with stubs gives the tokens of a prefill of the
    first prompt token followed by one decode step per further prompt
    token and per new token (its logits held to JAX's step by step in
    `test_prefill_and_decode_match_jax`)."""
    _, _, cfg, params = model
    _, b = _batches(cfg, {"tokens": _prompt(2, (2, 7), cfg.vocab)}, 3)
    extra = {k: v for k, v in b.items() if k != "tokens"}
    out, _, steps_ = serve.greedy_generate(cfg, params, b["tokens"], 5,
                                           extra, device="cpu")
    assert tuple(out.shape) == (2, 12) and len(steps_) == 5
    logits, cache = T.prefill(cfg, params, {**extra,
                                            "tokens": b["tokens"][:, :1]},
                              cache_len=12)
    toks = b["tokens"][:, :1]
    for pos in range(1, 12):
        nxt = (b["tokens"][:, pos:pos + 1] if pos < 7
               else torch.argmax(logits[:, -1], dim=-1)[:, None])
        toks = torch.cat([toks, nxt], dim=1)
        logits, cache = T.decode_step(cfg, params,
                                      {"token": nxt, "pos": pos}, cache)
    assert toks.tolist() == out.tolist()


def _stub_library(monkeypatch):
    """A stub kernel-8 library for CPU tensors (the kernel route forced)."""
    from unittest import mock

    lib = mock.MagicMock()
    lib.flash_attn_launch.return_value = 0
    monkeypatch.setattr(fa_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(fa_ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))
    return lib


def test_prefill_launches_kernel_8_on_decoder_self_attention(model,
                                                             monkeypatch):
    """With kernel 8's route forced (a stub library for CPU tensors), one
    prefill launches it once per causal decoder self-attention (the vlm's
    4 self layers, the audio decoder's 2 layers), never in the audio
    encoder or a cross block, never reaching the plain version; decode
    launches nothing."""
    _, _, cfg, params = model

    def plain(*args):
        raise AssertionError("a plain version ran on the kernel route")

    lib = _stub_library(monkeypatch)
    monkeypatch.setattr(fa_ops.ref, "causal_attention", plain)
    _, b = _batches(cfg, {"tokens": _prompt(3, (1, 10), cfg.vocab)}, 4)
    before = fa_ops.FLASH_COUNTER.launches
    _, cache = T.prefill(cfg, params, b, cache_len=11)
    n_self = T._n_attn(cfg)
    assert n_self == (4 if cfg.vlm else 2)
    assert fa_ops.FLASH_COUNTER.launches - before == n_self
    assert lib.flash_attn_launch.call_count == n_self
    assert {c.args[4:9] for c in lib.flash_attn_launch.call_args_list} \
        == {(1, 4, 2, 10, 64)}
    T.decode_step(cfg, params, {"token": b["tokens"][:, :1], "pos": 10},
                  cache)
    assert fa_ops.FLASH_COUNTER.launches - before == n_self


def test_add_modality_stubs_shapes():
    """`launch.train.add_modality_stubs` draws 0.1 * N(0, 1) patches
    (B, n_patches, d_vision) or frames (B, n_frames, d_model) from the
    generator on the tokens' device, fresh each call; other configs'
    batches pass through."""
    gen = torch.Generator().manual_seed(0)
    _, vcfg = _configs(VLM)
    _, acfg = _configs(AUDIO)
    tok = {"tokens": torch.zeros((3, 8), dtype=torch.int64)}
    a = train.add_modality_stubs(dict(tok), vcfg, gen)["patches"]
    b = train.add_modality_stubs(dict(tok), vcfg, gen)["patches"]
    assert a.shape == (3, N_PATCHES, D_VISION) and a.dtype == torch.float32
    assert not torch.equal(a, b)
    assert 0.08 < float(a.std()) < 0.12
    frames = train.add_modality_stubs(dict(tok), acfg, gen)["frames"]
    assert frames.shape == (3, 24, 256)
    dense = get_config("granite-8b").reduced()
    assert train.add_modality_stubs(dict(tok), dense, gen).keys() == {
        "tokens"}
