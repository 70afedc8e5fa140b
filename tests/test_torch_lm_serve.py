"""The port's ssm serving path against the JAX package, on the CPU:
`models.transformer` (prefill, decode_step, init_params),
`launch.serve.greedy_generate`, `serving.ServeEngine`, on the reduced
mamba2-1.3b (2 layers, d_model 256, 16 heads of 32, d_state 16, chunk
16, vocab 512) with JAX's `init_params(PRNGKey(0))` carried across by
`interop.lm_params`.

The port's prefill takes its kernel wrapper by default, which computes
the plain version on CPU tensors; the JAX prefill runs its jnp path (the
reference engine's default).

Bounds:
  * logits and caches: rtol 1e-4 and atol 1e-4 * max(1, max|ref|) —
    float32 products over 256- to 1056-wide rows taken in another order,
    through two layers (seen: ~4e-6 on logits of magnitude ~3);
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
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine

ARCH = "mamba2-1.3b"
CPU = torch.device("cpu")


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params)."""
    jcfg = j_get_config(ARCH).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = interop.lm_params(jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, jparams, get_config(ARCH).reduced(), tparams


def _prompt(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_configs_match_the_reference():
    assert list_archs() == [ARCH]
    for reduced in (False, True):
        jc, tc = j_get_config(ARCH), get_config(ARCH)
        if reduced:
            jc, tc = jc.reduced(), tc.reduced()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert get_config(ARCH).supports_shape("long_500k")


def test_init_params_tree_matches_jax_at_full_width():
    """Key for key and shape for shape, on the meta device: 48 layers,
    d_model 2048, vocab 50280, 1,446,714,368 parameters."""
    want = jax.eval_shape(lambda: JT.init_params(j_get_config(ARCH),
                                                 jax.random.PRNGKey(0)))
    got = T.init_params(get_config(ARCH), None, device="meta")
    flat_want = {jax.tree_util.keystr(k): v.shape for k, v in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_got == flat_want
    assert sum(int(np.prod(s)) for s in flat_got.values()) == 1_446_714_368
    assert flat_got["['blocks']['mixer']['w_in']"] == (48, 2048, 8512)


def test_init_params_is_seeded():
    cfg = get_config(ARCH).reduced()
    a, b, c = (T.init_params(cfg, torch.Generator().manual_seed(s),
                             device=CPU) for s in (3, 3, 4))
    assert torch.equal(a["blocks"]["mixer"]["w_in"],
                       b["blocks"]["mixer"]["w_in"])
    assert not torch.equal(a["embed"], c["embed"])
    assert float(a["blocks"]["mixer"]["w_in"].std()) == pytest.approx(
        1 / np.sqrt(cfg.d_model), rel=0.05)


@pytest.mark.parametrize("S", [5, 16, 37])
def test_prefill_matches_jax(models, S):
    jcfg, jparams, cfg, params = models
    toks = _prompt(S, (2, S), cfg.vocab)
    logits, cache = T.prefill(cfg, params, {"tokens": torch.as_tensor(toks)})
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(toks, jnp.int32)},
                                   compute_dtype=jnp.float32)
    _close(logits, j_logits)
    for k in ("conv", "ssm"):
        _close(cache["mamba"][k], j_cache["mamba"][k])


def test_prefill_wrapper_equals_plain_on_cpu(models):
    """On CPU tensors the kernel wrapper computes the plain expression:
    `use_kernel` True and False give bit-equal logits and caches."""
    _, _, cfg, params = models
    toks = {"tokens": torch.as_tensor(_prompt(0, (1, 40), cfg.vocab))}
    a = T.prefill(cfg, params, toks)
    b = T.prefill(cfg, params, toks, use_kernel=False)
    assert torch.equal(a[0], b[0])
    for k in ("conv", "ssm"):
        assert torch.equal(a[1]["mamba"][k], b[1]["mamba"][k])


def test_decode_steps_match_jax(models):
    """Prefill 21 tokens, then six decode steps fed JAX's greedy tokens:
    logits and both caches after every step."""
    jcfg, jparams, cfg, params = models
    toks = _prompt(1, (2, 21), cfg.vocab)
    _, cache = T.prefill(cfg, params, {"tokens": torch.as_tensor(toks)})
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(toks, jnp.int32)},
                                   compute_dtype=jnp.float32)
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
        for k in ("conv", "ssm"):
            _close(cache["mamba"][k], j_cache["mamba"][k])
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
    """R4 corrected: a prompt shorter than d_conv - 1 keeps a zero-padded
    conv history of d_conv - 1 rows, so prefill-then-decode gives the
    tokens (and the state) of decoding each prompt token from an empty
    cache."""
    _, _, cfg, params = models
    prompt = torch.as_tensor(_prompt(10 + S, (2, S), cfg.vocab))
    out, _, _ = serve.greedy_generate(cfg, params, prompt, 5, {},
                                      device="cpu")
    _, cache = T.prefill(cfg, params, {"tokens": prompt})
    assert tuple(cache["mamba"]["conv"].shape) == (
        cfg.n_layers, 2, cfg.ssm.d_conv - 1, 544)
    step = T.init_cache(cfg, 2, 8, device="cpu")
    for i in range(S):
        logits, step = T.decode_step(cfg, params,
                                     {"token": prompt[:, i:i + 1], "pos": i},
                                     step)
    for k in ("conv", "ssm"):
        _close(step["mamba"][k], cache["mamba"][k].numpy())
    toks = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(5):
        toks.append(tok)
        logits, step = T.decode_step(cfg, params,
                                     {"token": tok, "pos": S + i}, step)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    assert torch.cat(toks, dim=1).tolist() == out[:, S:].tolist()


def test_serve_main_runs_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "9", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced batch=2 prompt=9 new=3" in out
    assert "output token range OK" in out


def test_prefill_launches_the_kernel_once_per_layer(models, monkeypatch):
    """With the kernel route forced (a stub library for CPU tensors) the
    prefill launches kernel 7 once per layer and never reaches the plain
    version; decode launches nothing."""
    from unittest import mock

    _, _, cfg, params = models
    lib = mock.MagicMock()
    lib.ssd_chunk_launch.return_value = 0
    monkeypatch.setattr(ssd_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(ssd_ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))

    def plain(*args):
        raise AssertionError("the plain version ran on the kernel route")

    monkeypatch.setattr(ssd_ops.ref, "ssd_chunk_reference", plain)
    before = ssd_ops.SSD_COUNTER.launches
    toks = torch.as_tensor(_prompt(3, (1, 20), cfg.vocab))
    _, cache = T.prefill(cfg, params, {"tokens": toks})
    assert ssd_ops.SSD_COUNTER.launches == before + cfg.n_layers
    assert lib.ssd_chunk_launch.call_count == cfg.n_layers
    # (B, nc, Q, H, P, G, N) of each launch: 20 tokens in 2 chunks of 16
    assert {c.args[7:14] for c in lib.ssd_chunk_launch.call_args_list} == \
        {(1, 2, 16, 16, 32, 1, 16)}
    T.decode_step(cfg, params, {"token": toks[:, :1], "pos": 20}, cache)
    assert ssd_ops.SSD_COUNTER.launches == before + cfg.n_layers


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


def test_unported_families_raise(models):
    _, _, cfg, params = models
    dense = dataclasses.replace(cfg, arch_type="dense")
    with pytest.raises(NotImplementedError, match="item 13"):
        T.init_params(dense, None, device="meta")
    with pytest.raises(NotImplementedError, match="item 13"):
        T.prefill(dense, params, {"tokens": torch.zeros((1, 4), dtype=int)})
