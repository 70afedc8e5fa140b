"""The port's serving paths against the JAX package, on the CPU:
`models.transformer` (prefill, decode_step, init_params),
`launch.serve.greedy_generate`, `serving.ServeEngine`, on the reduced
mamba2-1.3b (2 layers, d_model 256, 16 heads of 32, d_state 16, chunk
16, vocab 512) and the reduced granite-8b (2 layers, d_model 256, 4
heads and 2 key/value heads of 64, d_ff 512, vocab 512; and its
sliding-window variant, window 64) and the reduced codeqwen1.5-7b (as
granite, with q/k/v biases and 4 key/value heads, one per query head)
with JAX's `init_params(PRNGKey(0))` carried across by
`interop.lm_params`.  The config, full-width tree and seeding tests run
over every served config of the zoo (the hybrid, moe, vlm and audio
families' models are held in `tests/test_torch_hybrid.py`,
`tests/test_torch_moe.py` and `tests/test_torch_vlm_audio.py`).

The port's prefill takes its kernel wrappers by default, which compute
the plain versions on CPU tensors; the JAX prefill runs its jnp path
(the reference engine's default).  The JAX engine vmaps a one-slot
decode over the slots; the port's runs one batched decode with one
position per slot.

Bounds:
  * logits and caches: rtol 1e-4 and atol 1e-4 * max(1, max|ref|) —
    float32 products over 256- to 1056-wide rows taken in another order,
    through two layers (seen: ~4e-6 on logits of magnitude ~3);
  * the dense prefill through the kernel wrapper against the grouped
    expression (`use_kernel=False`): rtol 1e-5 and atol 1e-5 *
    max(1, max|ref|) (the plain version scales the scores, the model
    scales q; seen: ~1e-6);
  * tokens (greedy_generate, the engine): equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as j_serve
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import interop
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine

ARCH = "mamba2-1.3b"
DENSE = "granite-8b"
CODEQWEN = "codeqwen1.5-7b"
ARCHS = [ARCH, DENSE, CODEQWEN]
# every config of the zoo that the port serves (lm-100m trains)
ZOO = [ARCH, DENSE, CODEQWEN, "minitron-4b", "mistral-large-123b",
       "zamba2-1.2b", "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
       "llama-3.2-vision-11b", "whisper-tiny"]
CPU = torch.device("cpu")


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=rtol * max(1.0, float(np.abs(want).max())))


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
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


def _build(arch, window=False):
    """(JAX config, JAX params, port config, port params).  The reduced
    codeqwen keeps one query head per key/value head (its `reduced()`
    gives 4 heads and 2 key/value heads): 4 and 4, with its q/k/v
    biases."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    if window:
        jcfg, cfg = jcfg.with_sliding_window(), cfg.with_sliding_window()
    jcfg, cfg = jcfg.reduced(), cfg.reduced()
    if arch == CODEQWEN:
        jcfg = dataclasses.replace(jcfg, n_kv_heads=jcfg.n_heads)
        cfg = dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = interop.lm_params(jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, jparams, cfg, tparams


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def windowed():
    """The reduced granite-8b's sliding-window variant (window 64)."""
    return _build(DENSE, window=True)


def _prompt(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("arch", ZOO)
def test_configs_match_the_reference(arch):
    assert list_archs() == sorted([*ZOO, "lm-100m"])  # lm-100m trains
    for reduced in (False, True):
        for window in (False, True):
            jc, tc = j_get_config(arch), get_config(arch)
            if window:
                jc, tc = jc.with_sliding_window(), tc.with_sliding_window()
            if reduced:
                jc, tc = jc.reduced(), tc.reduced()
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert get_config(arch).supports_shape("long_500k") == (
        get_config(arch).arch_type in ("ssm", "hybrid"))


FULL_WIDTH = {
    ARCH: (1_446_714_368, "['blocks']['mixer']['w_in']", (48, 2048, 8512)),
    DENSE: (8_254_689_280, "['blocks']['mlp']['w_gate']", (36, 4096, 14336)),
    CODEQWEN: (8_190_038_016, "['blocks']['attn']['bq']", (32, 4096)),
    "minitron-4b": (5_096_279_040, "['lm_head']", (3072, 256000)),
    "mistral-large-123b": (122_610_069_504, "['blocks']['attn']['wq']",
                           (88, 12288, 12288)),
    "zamba2-1.2b": (1_170_473_856, "['shared_attn']['mlp']['w_gate']",
                    (2048, 8192)),
    "phi3.5-moe-42b-a6.6b": (41_872_527_360,
                             "['moe_blocks']['moe']['w_down']",
                             (32, 16, 6400, 4096)),
    "llama4-maverick-400b-a17b": (394_672_051_200,
                                  "['moe_blocks']['moe']['router']",
                                  (24, 5120, 128)),
    "llama-3.2-vision-11b": (9_775_157_256,
                             "['cross_blocks']['attn']['wk']",
                             (8, 4096, 1024)),
    "whisper-tiny": (61_085_956, "['enc_blocks']['mlp']['w_up']",
                     (4, 384, 1536)),
}


@pytest.mark.parametrize("arch", ZOO)
def test_init_params_tree_matches_jax_at_full_width(arch):
    """Key for key and shape for shape, on the meta device, at the
    parameter totals of FULL_WIDTH: mamba2-1.3b (48 layers, d_model 2048,
    vocab 50280), granite-8b (36 layers, d_model 4096, d_ff 14336, vocab
    49152), codeqwen1.5-7b (its q/k/v biases), minitron-4b (vocab
    256000), mistral-large-123b (88 layers, d_model 12288), zamba2-1.2b
    (38 Mamba2 layers and one shared block), phi3.5-moe (32 MoE layers
    of 16 experts), llama4-maverick (24 dense and 24 MoE layers of 128
    experts), llama-3.2-vision-11b (8 groups of 4 self blocks and one
    cross block over d_vision 4096) and whisper-tiny (4 encoder and 4
    decoder layers, LayerNorm)."""
    want = jax.eval_shape(lambda: JT.init_params(j_get_config(arch),
                                                 jax.random.PRNGKey(0)))
    got = T.init_params(get_config(arch), None, device="meta")
    flat_want = {jax.tree_util.keystr(k): v.shape for k, v in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_flatten_with_path(got)[0]}
    n_params, key, shape = FULL_WIDTH[arch]
    assert flat_got == flat_want
    assert sum(int(np.prod(s)) for s in flat_got.values()) == n_params
    assert flat_got[key] == shape


# the leaf whose draws each seeding test reads: N(0, 1) / sqrt(d_model)
SEEDED = {"ssm": ("blocks", "mixer.w_in"), "hybrid": ("blocks", "mixer.w_in"),
          "dense": ("blocks", "attn.wq"), "moe": ("moe_blocks", "moe.w_gate"),
          "vlm": ("cross_blocks", "attn.wq"), "audio": ("enc_blocks",
                                                        "attn.wq")}


@pytest.mark.parametrize("arch", ZOO)
def test_init_params_is_seeded(arch):
    cfg = get_config(arch).reduced()
    a, b, c = (T.init_params(cfg, torch.Generator().manual_seed(s),
                             device=CPU) for s in (3, 3, 4))
    stack, w = SEEDED[cfg.arch_type]
    wa, wb = _leaves(a[stack])[w], _leaves(b[stack])[w]
    assert torch.equal(wa, wb)
    assert not torch.equal(a["embed"], c["embed"])
    assert float(wa.std()) == pytest.approx(1 / np.sqrt(cfg.d_model),
                                            rel=0.05)


def test_lm_params_carries_the_dense_tree_key_for_key(models):
    """`interop.lm_params` on the reduced trees: the same keys, shapes and
    float32 values as JAX's `init_params(PRNGKey(0))`."""
    _, jparams, cfg, params = models
    want = _leaves(jax.tree.map(np.asarray, jparams))
    got = _leaves(params)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.device == CPU
        assert np.array_equal(v.numpy(), want[k])
    if cfg.arch_type == "dense":
        assert got["blocks.attn.wk"].shape == (2, 256,
                                               64 * cfg.n_kv_heads)
        assert ("blocks.attn.bq" in got) == cfg.attn_bias


@pytest.mark.parametrize("S", [1, 5, 16, 37])
def test_prefill_matches_jax(models, S):
    """Logits and the cache, with `cache_len` = S + 4 (the dense KV cache
    zero-padded beyond the prompt; the ssm family ignores it).  The ssm
    conv cache of a 1-token prompt is R4's (ROADMAP.md) and is held by
    `test_short_prompts_prefill_then_decode` instead."""
    jcfg, jparams, cfg, params = models
    toks = _prompt(S, (2, S), cfg.vocab)
    logits, cache = T.prefill(cfg, params, {"tokens": torch.as_tensor(toks)},
                              cache_len=S + 4)
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(toks, jnp.int32)},
                                   compute_dtype=jnp.float32,
                                   cache_len=S + 4)
    _close(logits, j_logits)
    r4 = ("mamba.conv",) if cfg.arch_type == "ssm" and S < 3 else ()
    _close_caches(cache, j_cache, skip=r4)


def test_prefill_wrapper_equals_plain_on_cpu(models):
    """On CPU tensors the kernel wrappers compute the plain versions: for
    the ssm family `use_kernel` True and False give bit-equal logits and
    caches; for the dense family the caches are bit-equal and the logits
    agree within rtol 1e-5 (kernel 8's plain version scales the scores,
    the grouped expression scales q)."""
    _, _, cfg, params = models
    toks = {"tokens": torch.as_tensor(_prompt(0, (1, 40), cfg.vocab))}
    a = T.prefill(cfg, params, toks)
    b = T.prefill(cfg, params, toks, use_kernel=False)
    if cfg.arch_type == "ssm":
        assert torch.equal(a[0], b[0])
    else:
        _close(a[0], b[0].numpy(), rtol=1e-5)
    la, lb = _leaves(a[1]), _leaves(b[1])
    assert sorted(la) == sorted(lb)
    # the first layer's cache precedes any attention output
    for k in la:
        if cfg.arch_type == "ssm":
            assert torch.equal(la[k], lb[k])
        else:
            assert torch.equal(la[k][0], lb[k][0])
            _close(la[k], lb[k].numpy(), rtol=1e-5)


def test_decode_steps_match_jax(models):
    """Prefill 21 tokens, then six decode steps fed JAX's greedy tokens:
    logits and both caches after every step."""
    jcfg, jparams, cfg, params = models
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


def test_greedy_generate_matches_jax(models):
    jcfg, jparams, cfg, params = models
    prompt = _prompt(2, (2, 12), cfg.vocab)
    out, t_prefill, steps = serve.greedy_generate(
        cfg, params, torch.as_tensor(prompt), 8, {}, device="cpu")
    j_out, _, _ = j_serve.greedy_generate(
        jcfg, jparams, jnp.asarray(prompt, jnp.int32), 8, {})
    assert out.tolist() == np.asarray(j_out).tolist()
    assert t_prefill > 0 and len(steps) == 8


def _requests(cls, vocab):
    """Five admissible requests of different lengths and budgets, and one
    whose prompt can never fit a 32-position cache (uid 9)."""
    rng = np.random.default_rng(5)
    reqs = [cls(uid=i, prompt=rng.integers(0, vocab, 6 + 3 * i)
                .astype(np.int32), max_new_tokens=3 + i) for i in range(5)]
    big = cls(uid=9, prompt=rng.integers(0, vocab, 40).astype(np.int32),
              max_new_tokens=4)
    return [reqs[0], big] + reqs[1:]


def test_serve_engine_matches_jax(models):
    """More requests than slots and an oversized request at the head of
    the queue: the same requests finish with the same tokens, and the
    oversized one is rejected by both."""
    jcfg, jparams, cfg, params = models
    eng = ServeEngine(cfg, params, n_slots=2, max_seq=32, device="cpu")
    reqs = _requests(Request, cfg.vocab)
    done = eng.run(reqs, max_steps=200)
    j_done = JServeEngine(jcfg, jparams, n_slots=2, max_seq=32).run(
        _requests(JRequest, cfg.vocab), max_steps=200)
    got = {r.uid: r.out_tokens for r in done}
    want = {r.uid: r.out_tokens for r in j_done}
    assert sorted(got) == [0, 1, 2, 3, 4]
    assert got == want
    big = reqs[1]
    assert not eng.fits(big) and big.out_tokens == [] and big.slot is None
    assert not eng.active


def test_serve_engine_tokens_equal_greedy_generate(models):
    """The reference's `test_ssm_engine` contract, inside the port: each
    request's tokens equal `greedy_generate` on its prompt alone, with
    slots reused across requests."""
    _, _, cfg, params = models
    eng = ServeEngine(cfg, params, n_slots=2, max_seq=32, device="cpu")
    reqs = [r for r in _requests(Request, cfg.vocab) if r.uid != 9]
    done = eng.run(reqs)
    assert len(done) == 5
    for r in done:
        out, _, _ = serve.greedy_generate(
            cfg, params, torch.as_tensor(r.prompt, dtype=torch.int64)[None],
            r.max_new_tokens, {}, device="cpu")
        assert r.out_tokens == out[0, len(r.prompt):].tolist()


@pytest.mark.parametrize("S", [1, 2, 3])
def test_short_prompts_prefill_then_decode(models, S):
    """Prefill-then-decode gives the tokens (and the cache) of decoding
    each prompt token from an empty cache.  For the ssm family this is R4
    corrected: a prompt shorter than d_conv - 1 keeps a zero-padded conv
    history of d_conv - 1 rows."""
    _, _, cfg, params = models
    prompt = torch.as_tensor(_prompt(10 + S, (2, S), cfg.vocab))
    out, _, _ = serve.greedy_generate(cfg, params, prompt, 5, {},
                                      device="cpu")
    _, cache = T.prefill(cfg, params, {"tokens": prompt}, cache_len=8)
    if cfg.arch_type == "ssm":
        assert tuple(cache["mamba"]["conv"].shape) == (
            cfg.n_layers, 2, cfg.ssm.d_conv - 1, 544)
    step = T.init_cache(cfg, 2, 8, device="cpu")
    for i in range(S):
        logits, step = T.decode_step(cfg, params,
                                     {"token": prompt[:, i:i + 1], "pos": i},
                                     step)
    got, want = _leaves(step), _leaves(cache)
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k].numpy())
    toks = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(5):
        toks.append(tok)
        logits, step = T.decode_step(cfg, params,
                                     {"token": tok, "pos": S + i}, step)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    assert torch.cat(toks, dim=1).tolist() == out[:, S:].tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_the_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "9", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced batch=2 prompt=9 new=3" in out
    assert "output token range OK" in out


def _stub_library(monkeypatch, ops, entry):
    """A stub kernel library for CPU tensors (the kernel route forced),
    and a plain version that fails if it runs."""
    from unittest import mock

    lib = mock.MagicMock()
    getattr(lib, entry).return_value = 0
    monkeypatch.setattr(ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))
    return lib


def test_prefill_launches_the_kernel_once_per_layer(models, monkeypatch):
    """With the kernel route forced (a stub library for CPU tensors) the
    prefill launches its family's kernel once per layer (kernel 7 for
    the ssm family, kernel 8 for the dense one) and never reaches the
    plain version; decode launches nothing."""
    _, _, cfg, params = models

    def plain(*args):
        raise AssertionError("the plain version ran on the kernel route")

    toks = torch.as_tensor(_prompt(3, (1, 20), cfg.vocab))
    if cfg.arch_type == "ssm":
        lib = _stub_library(monkeypatch, ssd_ops, "ssd_chunk_launch")
        monkeypatch.setattr(ssd_ops.ref, "ssd_chunk_reference", plain)
        counter, launch = ssd_ops.SSD_COUNTER, lib.ssd_chunk_launch
        # (B, nc, Q, H, P, G, N) of each launch: 20 tokens in 2 chunks
        args, want = slice(7, 14), (1, 2, 16, 16, 32, 1, 16)
    else:
        lib = _stub_library(monkeypatch, fa_ops, "flash_attn_launch")
        monkeypatch.setattr(fa_ops.ref, "causal_attention", plain)
        counter, launch = fa_ops.FLASH_COUNTER, lib.flash_attn_launch
        # (B, Hq, Hkv, S, D) and the (b, h, s) strides of q, k, v, o: the
        # (B, S, H, D) projections read in place, the output alike
        args = slice(4, 21)
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        q_strides = (20 * hq * 64, 64, hq * 64)
        kv_strides = (20 * hkv * 64, 64, hkv * 64)
        want = (1, hq, hkv, 20, 64, *q_strides, *kv_strides, *kv_strides,
                *q_strides)
    before = counter.launches
    _, cache = T.prefill(cfg, params, {"tokens": toks}, cache_len=21)
    assert counter.launches == before + cfg.n_layers
    assert launch.call_count == cfg.n_layers
    assert {c.args[args] for c in launch.call_args_list} == {want}
    T.decode_step(cfg, params, {"token": toks[:, :1], "pos": 20}, cache)
    assert counter.launches == before + cfg.n_layers


@pytest.mark.parametrize("S,steps", [(80, 6), (60, 8)])
def test_sliding_window_matches_jax(windowed, S, steps):
    """The reduced sliding window (64): a prompt longer than the window
    (its rolling cache) and one that decodes past it, logits and caches
    after the prefill and after every decode step; the prefill takes the
    grouped expression (a window never goes to kernel 8)."""
    jcfg, jparams, cfg, params = windowed
    assert cfg.sliding_window == 64
    toks = _prompt(S, (2, S), cfg.vocab)
    logits, cache = T.prefill(cfg, params, {"tokens": torch.as_tensor(toks)},
                              cache_len=S + steps)
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(toks, jnp.int32)},
                                   compute_dtype=jnp.float32,
                                   cache_len=S + steps)
    _close(logits, j_logits)
    _close_caches(cache, j_cache)
    assert cache["attn"]["k"].shape[2] == 64
    j_decode = jax.jit(lambda p, b, c: JT.decode_step(
        jcfg, p, b, c, compute_dtype=jnp.float32))
    tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1)[:, None]
    for i in range(steps):
        logits, cache = T.decode_step(
            cfg, params, {"token": torch.as_tensor(tok), "pos": S + i}, cache)
        j_logits, j_cache = j_decode(
            jparams, {"token": jnp.asarray(tok, jnp.int32),
                      "pos": jnp.asarray(S + i, jnp.int32)}, j_cache)
        _close(logits, j_logits)
        _close_caches(cache, j_cache)
        tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1)[:, None]


def test_sliding_window_engine_matches_jax(windowed):
    """The engine on the windowed model, slots at different offsets past
    the window: the same tokens as the JAX engine."""
    jcfg, jparams, cfg, params = windowed
    def reqs(cls):
        return [cls(uid=i, prompt=np.random.default_rng(20 + i)
                    .integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=m)
                for i, (n, m) in enumerate(((70, 5), (30, 40), (62, 9)))]

    done = ServeEngine(cfg, params, n_slots=2, max_seq=96,
                       device="cpu").run(reqs(Request), max_steps=200)
    j_done = JServeEngine(jcfg, jparams, n_slots=2, max_seq=96).run(
        reqs(JRequest), max_steps=200)
    got = {r.uid: r.out_tokens for r in done}
    assert sorted(got) == [0, 1, 2]
    assert got == {r.uid: r.out_tokens for r in j_done}


def test_rounding_of_the_ssd_step_moves_deep_logits_inside_the_bound(
        monkeypatch):
    """How far a rounding-level change of the intra-chunk step moves the
    logits of a deep prefill: the scale that `chip_smoke.py`'s bound on
    the kernel prefill against the plain one (LOGIT_RTOL, 1e-3 of
    max(1, max|logit|)) has to allow for.

    A 48-layer mamba2 at d_model 512 (16 heads of 64, d_state 128, chunk
    256, vocab 1024; weights from seed 0) prefills one 512-token prompt
    with the plain float32 intra-chunk step, then with that step computed
    in float64 and rounded to float32.  `pytest -s` prints the reading.
    """
    from repro_torch.kernels.ssd import ref
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_config(ARCH), d_model=512, vocab=1024)
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, device="cpu")
    toks = {"tokens": torch.randint(0, cfg.vocab, (1, 512), generator=gen)}
    plain, _ = T.prefill(cfg, params, toks, use_kernel=False)

    def rounded_float64(xc, dtc, da, bc, cc):
        y, states, _, _ = ref.float64_reference_and_bound(xc, dtc, da, bc,
                                                          cc)
        return y.float(), states.float()

    monkeypatch.setattr(ssm, "ssd_chunk_reference", rounded_float64)
    other, _ = T.prefill(cfg, params, toks, use_kernel=False)
    diff = float((plain - other).abs().max())
    top = float(plain.abs().max())
    print(f"max|logit| {top!r}, max |logit difference| {diff!r} "
          f"({diff / top!r} of max)")
    assert 0.0 < diff <= 1e-3 * max(1.0, top)
    assert int(plain.argmax()) == int(other.argmax())


def test_rounding_of_the_attention_core_moves_deep_logits_inside_the_bound(
        monkeypatch):
    """How far a rounding-level change of the attention core moves the
    logits of a deep dense prefill: the scale that `chip_smoke.py`'s
    bound on the kernel-8 prefill against the plain one (DENSE_LOGIT_RTOL,
    1e-3 of max(1, max|logit|)) has to allow for.

    A 36-layer granite at d_model 512 (8 heads and 2 key/value heads of
    64, d_ff 1024, vocab 1024; weights from seed 0) prefills one
    512-token prompt with the plain float32 attention core, then with
    that core computed in float64 and rounded to float32.  `pytest -s`
    prints the reading.
    """
    cfg = dataclasses.replace(get_config(DENSE), d_model=512, n_heads=8,
                              n_kv_heads=2, d_ff=1024, vocab=1024)
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, device="cpu")
    toks = {"tokens": torch.randint(0, cfg.vocab, (1, 512), generator=gen)}
    plain, _ = T.prefill(cfg, params, toks)

    def rounded_float64(q, k, v):
        o64, _ = fa_ops.ref.float64_reference_and_bound(q, k, v)
        return o64.float()

    monkeypatch.setattr(fa_ops.ref, "causal_attention", rounded_float64)
    other, _ = T.prefill(cfg, params, toks)
    diff = float((plain - other).abs().max())
    top = float(plain.abs().max())
    print(f"max|logit| {top!r}, max |logit difference| {diff!r} "
          f"({diff / top!r} of max)")
    assert 0.0 < diff <= 1e-3 * max(1.0, top)
    assert int(plain.argmax()) == int(other.argmax())


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_vlm_and_audio_serve_on_meta_at_the_reference_shapes(arch):
    """The vlm and audio families at full width on the meta device: a
    prefill of 8 tokens (the plain attention: kernel 8 has no meta
    route) with their stub patches or frames gives the logits and the
    self and cross caches of JAX's `eval_shape` of its prefill, and a
    decode step runs on that cache."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    B, S = 2, 8
    stub = (("patches", (B, cfg.vlm.n_patches, cfg.vlm.d_vision)) if cfg.vlm
            else ("frames", (B, cfg.encdec.n_frames, cfg.d_model)))
    params = T.init_params(cfg, None, device="meta")
    toks = torch.zeros((B, S), dtype=torch.int64, device="meta")
    logits, cache = T.prefill(
        cfg, params, {"tokens": toks, stub[0]: torch.empty(stub[1],
                                                           device="meta")},
        cache_len=S + 4, use_kernel=False)
    j_logits, j_cache = jax.eval_shape(
        lambda: JT.prefill(jcfg, JT.init_params(jcfg, jax.random.PRNGKey(0)),
                           {"tokens": jnp.zeros((B, S), jnp.int32),
                            stub[0]: jnp.zeros(stub[1])},
                           compute_dtype=jnp.float32, cache_len=S + 4))
    assert tuple(logits.shape) == j_logits.shape == (B, 1, cfg.vocab)
    got = {k: tuple(v.shape) for k, v in _leaves(cache).items()}
    assert got == {k: v.shape for k, v in _leaves(j_cache).items()}
    assert got["cross.k"][2] == stub[1][1]
    step, _ = T.decode_step(cfg, params, {"token": toks[:, :1], "pos": S},
                            cache)
    assert tuple(step.shape) == (B, 1, cfg.vocab)


@pytest.mark.parametrize("knob", [{"attn_impl": "repeat"},
                                  {"softmax_dtype": "bf16"},
                                  {"fused_proj": True},
                                  {"attn_seq_shard": True}])
def test_unported_attention_knobs_raise(knob):
    """The dry run's attention settings, once refused, now build: the
    port's tree on the meta device has the reference's leaves and shapes
    (`fused_proj` packs `wkv` and `w_gu`; the others change no leaf).
    The name is the one the test had while these knobs raised."""
    cfg = dataclasses.replace(get_config(DENSE).reduced(), **knob)
    jcfg = dataclasses.replace(j_get_config(DENSE).reduced(), **knob)
    got = {k: tuple(v.shape)
           for k, v in _leaves(T.init_params(cfg, None, device="meta")).items()}
    want = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    assert got == {k: v.shape for k, v in _leaves(want).items()}
    assert ("blocks.attn.wkv" in got) == ("blocks.mlp.w_gu" in got) \
        == bool(cfg.fused_proj)
