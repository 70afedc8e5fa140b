"""The port's launch layer against the JAX package, on the CPU: the
dry run's per-device bytes against XLA's own memory analysis and its
`plan_combinations` and `optimize_config` (one subprocess, since
importing `repro.launch.dryrun` sets XLA_FLAGS for 512 placeholder
devices), the attention and SSD settings `optimize_config` applies
(`attn_impl="repeat"`, a bf16 softmax, `attn_seq_shard`,
`ssm.head_shard`) and the config field `fused_proj` on the reduced
configs, and the multi-process bootstrap (`launch.distributed`,
`launch.train --distributed`) over gloo on 127.0.0.1.  The reference's
dry run and the two gloo ranks run in processes of their own, started
with the module's first test and read by its last ones.

Bounds:
  * `impl="repeat"` at a float32 softmax against the grouped expression
    and against the reference's repeat: rtol 1e-4 and atol 1e-4 *
    max(1, max|ref|) (`tests/test_torch_lm_serve.py`'s); `fused_proj`
    against the reference after `interop.lm_params`: the same;
  * `head_shard` and `attn_seq_shard`: `torch.equal` to the run without
    (mesh hints that change nothing on one card);
  * the bf16 softmax: `layers.softmax_bf16` is bit-equal to the jitted
    `jax.nn.softmax` on the same bf16 scores.  Through a model the
    scores are float32 products in each package's order, and rounding
    them to bf16 turns their last-bit differences into bf16 steps of
    2^-8, so the logits are held within 2^-7 * max(1, max|ref|) of the
    reference's (seen 3.6e-3 of max|logit| on the reduced granite-8b;
    the reference's own bf16 and float32 softmaxes differ by 5.4e-3),
    and the port's bf16-minus-float32 perturbation within a factor 2 of
    the reference's in norm, so a port that ignored the setting cannot
    pass;
  * the dry run's argument bytes equal XLA's `argument_size_in_bytes`
    (whisper-tiny train_4k on 16 x 16); for decode_32k the port counts
    every argument and XLA only those the step reads: XLA with
    `keep_unused=True` equals the port, and the gap is the bytes of the
    leaves a decode step does not read;
  * the distributed runs: losses `torch.equal`.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop, tree
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.launch import distributed as D
from repro_torch.launch import dryrun, mesh as M, sharding as SH, train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DENSE, HYBRID = "granite-8b", "zamba2-1.2b"

# the reference's dry run, in its own process (512 placeholder devices)
_XLA_SCRIPT = r'''
import dataclasses, json
from repro.launch import dryrun
import jax, jax.numpy as jnp
from repro.configs import ASSIGNED, INPUT_SHAPES, get_config, input_specs
from repro.launch.mesh import make_production_mesh
from repro.launch.sharding import (batch_shardings, cache_shardings,
                                   param_shardings)
from repro.launch.steps import make_decode_step
from repro.models import transformer as T

mesh = make_production_mesh()
cfg = get_config("whisper-tiny")
out = {}
for shape in ("train_4k", "decode_32k"):
    st = dryrun.lower_one(cfg, shape, mesh)
    out[shape] = {k: st["memory"][k] for k in ("argument_size", "output_size")}
# decode_32k again, every argument kept
spec = INPUT_SHAPES["decode_32k"]
B, S = spec["global_batch"], spec["seq_len"]
batch = input_specs(cfg, "decode_32k")
params = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0),
                                              dtype=jnp.bfloat16))
cache = jax.eval_shape(lambda: T.init_cache(cfg, B, S, dtype=jnp.bfloat16))
c_sh = cache_shardings(cfg, mesh, cache)
logits = jax.ShapeDtypeStruct((B, 1, cfg.vocab), jnp.float32)
jitted = jax.jit(make_decode_step(cfg),
                 in_shardings=(param_shardings(cfg, mesh, params),
                               batch_shardings(cfg, mesh, batch), c_sh),
                 out_shardings=(batch_shardings(cfg, mesh, logits), c_sh),
                 donate_argnums=(2,), keep_unused=True)
with mesh:
    mem = jitted.lower(params, batch, cache).compile().memory_analysis()
out["decode_keep_unused"] = mem.argument_size_in_bytes
combos, skips = dryrun.plan_combinations(ASSIGNED, list(INPUT_SHAPES))
out["combos"] = [[a, s, c.name] for a, s, c in combos]
out["skips"] = [list(s) for s in skips]
out["optimized"] = {
    f"{a}|{k}": dataclasses.asdict(dryrun.optimize_config(get_config(a), k))
    for a in ASSIGNED for k in ("train", "prefill", "decode")}
print("RESULT " + json.dumps(out))
'''

# one rank of a two-process gloo world on 127.0.0.1 (argv: port, rank)
_GLOO_SCRIPT = r'''
import json, sys
import torch
from repro_torch.launch import distributed as D, mesh as M

port, rank = int(sys.argv[1]), int(sys.argv[2])
multi = D.initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                                 backend="gloo")
mesh = M.make_host_mesh(model_axis=1)
D.sync_hosts()
x = torch.full((), float(rank + 1))
torch.distributed.all_reduce(x)
print("RESULT " + json.dumps({
    "multi": multi, "coordinator": D.is_coordinator(),
    "world": D.world_size(), "mesh": list(mesh.shape), "sum": float(x)}))
torch.distributed.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _python(script: str, tmp: Path, name: str, *args) -> tuple:
    """Start `script` in a Python process of its own, its output into
    files under `tmp`; returns (process, stdout path, stderr path)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    out, err = tmp / f"{name}.out", tmp / f"{name}.err"
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen([sys.executable, "-c", script,
                                 *map(str, args)], env=env, stdout=fo,
                                stderr=fe, text=True)
    return proc, out, err


def _result(started: tuple, timeout: float) -> dict:
    """The RESULT line of a process from `_python`, once it has ended."""
    proc, out, err = started
    proc.wait(timeout=timeout)
    assert proc.returncode == 0, err.read_text()[-4000:]
    line = [x for x in out.read_text().splitlines()
            if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The reference's dry run and the two gloo ranks, started when the
    module's first test sets up so that they run beside the in-process
    tests (the tests that read them come last); killed at teardown where
    no test waited for them."""
    tmp = tmp_path_factory.mktemp("launch")
    port = _free_port()
    started = {"xla": _python(_XLA_SCRIPT, tmp, "xla"),
               "gloo": [_python(_GLOO_SCRIPT, tmp, f"gloo{r}", port, r)
                        for r in range(2)]}
    yield started
    for proc, _, _ in [started["xla"], *started["gloo"]]:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def xla(background):
    return _result(background["xla"], timeout=600)


# ---------------------------------------------------------------------------
# the attention and SSD settings
# ---------------------------------------------------------------------------

def _close(got, want, rtol=1e-4):
    want = np.asarray(want, dtype=np.float64)
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, dtype=np.float64))
    assert got.shape == want.shape
    top = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * top)


def _model(arch, **knobs):
    """(JAX config, JAX params, port config, port params) of the reduced
    `arch` with `knobs`, JAX's init_params(PRNGKey(0)) in both."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **knobs)
    cfg = dataclasses.replace(get_config(arch).reduced(), **knobs)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, interop.lm_params(
        jax.tree.map(np.asarray, jparams), CPU)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_softmax_bf16_is_bit_equal_to_the_jitted_reference():
    rng = np.random.default_rng(0)
    s = (3 * rng.standard_normal((2, 4, 64, 64))).astype(np.float32)
    mask = np.tril(np.ones((64, 64), bool))

    @jax.jit
    def ref(s):
        x = jnp.where(mask, jnp.asarray(s).astype(jnp.bfloat16), L.NEG_INF)
        return jax.nn.softmax(x, axis=-1)

    x = torch.where(torch.from_numpy(mask),
                    torch.from_numpy(s).to(torch.bfloat16), L.NEG_INF)
    got = L.softmax_bf16(x)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.asarray(ref(s).astype(jnp.float32)))
    assert torch.equal(got.float(), want)
    # torch's own bf16 softmax rounds once from float32: not the same
    assert not torch.equal(torch.softmax(x, dim=-1).float(), want)


def test_repeat_attention_matches_grouped_and_jax():
    """`gqa_scores_apply(impl="repeat")` at a float32 softmax against the
    grouped expression and the reference's repeat, with a causal (S, T)
    mask and a decode-style 5-D mask; an unknown impl raises."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 9, 6, 32)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    masks = [(L.causal_mask(9, 9), JL.causal_mask(9, 9)),
             ((torch.arange(9) <= 5)[None, None, None, None, :],
              (jnp.arange(9) <= 5)[None, None, None, None, :])]
    for tm, jm in masks:
        rep = L.gqa_scores_apply(tq, tk, tv, tm, impl="repeat")
        _close(rep, L.gqa_scores_apply(tq, tk, tv, tm))
        _close(rep, JL.gqa_scores_apply(q, k, v, jm, impl="repeat"))
    with pytest.raises(ValueError, match="impl"):
        L.gqa_scores_apply(tq, tk, tv, None, impl="flash")


def test_repeat_routes_to_kernel_8_and_bf16_softmax_does_not(monkeypatch):
    """Causal attention with no window: `impl="repeat"` at a float32
    softmax reaches the kernel-8 wrapper (once a layer, as the grouped
    one), a bf16 softmax takes the plain expression and never reaches it;
    the prefill takes the float32 softmax whatever the config, as the
    reference's."""
    calls = []
    real = fa_ops.causal_attention

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(fa_ops, "causal_attention", counting)
    base = get_config(DENSE).reduced()
    params = T.init_params(base, torch.Generator().manual_seed(0),
                           device="cpu")
    b = {"tokens": torch.as_tensor(_tokens(0, (1, 12)))}
    seen = {}
    for name, knobs in (("grouped", {}), ("repeat", {"attn_impl": "repeat"}),
                        ("bf16", {"attn_impl": "repeat",
                                  "softmax_dtype": "bf16"})):
        cfg = dataclasses.replace(base, **knobs)
        calls.clear()
        logits, _ = T.forward_train(cfg, params, b, use_kernel=True)
        seen[name] = (len(calls), logits)
        calls.clear()
        T.prefill(cfg, params, b)
        assert len(calls) == base.n_layers
    assert seen["grouped"][0] == seen["repeat"][0] == base.n_layers
    assert seen["bf16"][0] == 0
    _close(seen["repeat"][1], seen["grouped"][1])


@pytest.mark.parametrize("arch", [DENSE, "whisper-tiny"])
def test_repeat_and_bf16_softmax_models_match_jax(arch):
    """The reduced model under `optimize_config(cfg, "train")` (repeat,
    bf16 softmax): `forward_train` logits within 2^-7 * max(1, max|ref|)
    of the reference's, its bf16-minus-float32 perturbation within a
    factor 2 of the reference's in norm; the prefill (float32 softmax in
    both packages' causal self-attention) and a decode step within rtol
    1e-4 (whisper-tiny's, whose encoder takes the bf16 softmax in the
    prefill as well, within 2^-7)."""
    jcfg, jparams, cfg, params = _model(arch)
    cfg = dryrun.optimize_config(cfg, "train")
    jcfg = dataclasses.replace(jcfg, attn_impl=cfg.attn_impl,
                               softmax_dtype=cfg.softmax_dtype)
    assert (cfg.attn_impl, cfg.softmax_dtype) == ("repeat", "bf16")
    toks = _tokens(1, (2, 24))
    jb, b = {"tokens": jnp.asarray(toks, jnp.int32)}, {
        "tokens": torch.as_tensor(toks)}
    if cfg.encdec:
        frames = (0.1 * np.random.default_rng(2).standard_normal(
            (2, cfg.encdec.n_frames, cfg.d_model))).astype(np.float32)
        jb["frames"], b["frames"] = jnp.asarray(frames), torch.from_numpy(
            frames)
    fwd = jax.jit(lambda c, p, bb: JT.forward_train(c, p, bb)[0],
                  static_argnums=0)
    want = np.asarray(fwd(jcfg, jparams, jb))
    want32 = np.asarray(fwd(dataclasses.replace(jcfg, softmax_dtype="f32"),
                            jparams, jb))
    got = T.forward_train(cfg, params, b)[0].numpy()
    got32 = T.forward_train(dataclasses.replace(cfg, softmax_dtype="f32"),
                            params, b)[0].numpy()
    top = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    ratio = np.linalg.norm(got - got32) / np.linalg.norm(want - want32)
    print(f"{cfg.name}: bf16-softmax logits {err / top:.3e} of max|ref| "
          f"(bound 2^-7); the reference's bf16 vs float32 "
          f"{float(np.abs(want - want32).max()) / top:.3e}, the port's "
          f"{float(np.abs(got - got32).max()) / top:.3e}; perturbation "
          f"ratio {ratio:.3f}")
    assert err <= 2.0 ** -7 * top
    assert 0.5 <= ratio <= 2.0
    # whisper's encoder takes the bf16 softmax in the prefill too (the
    # reference's prefill runs it through `_self_block`), so its cross
    # cache, and what reads it, is held at the bf16 bound
    _prefill_and_decode_match(jcfg, jparams, cfg, params, jb, b, 24,
                              rtol=2.0 ** -7 if cfg.encdec else 1e-4)


@pytest.mark.parametrize("arch", [DENSE, "phi3.5-moe-42b-a6.6b",
                                  "llama-3.2-vision-11b"])
def test_fused_proj_matches_jax(arch):
    """`fused_proj`: the packed `wkv` / `w_gu` leaves cross by
    `interop.lm_params`; the forward, the prefill and a decode step match
    the reference's (the cross blocks stay unpacked, as the
    reference's)."""
    jcfg, jparams, cfg, params = _model(arch, fused_proj=True)
    assert "wkv" in params["moe_blocks" if cfg.moe else "blocks"]["attn"]
    if cfg.vlm:
        assert "wk" in params["cross_blocks"]["attn"]
    toks = _tokens(4, (2, 17))
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
    b = {"tokens": torch.as_tensor(toks[:, :-1]),
         "targets": torch.as_tensor(toks[:, 1:])}
    if cfg.vlm:
        patches = (0.1 * np.random.default_rng(5).standard_normal(
            (2, cfg.vlm.n_patches, cfg.vlm.d_vision))).astype(np.float32)
        jb["patches"], b["patches"] = jnp.asarray(patches), \
            torch.from_numpy(patches)
    jlogits = jax.jit(lambda p, bb: JT.forward_train(jcfg, p, bb)[0])(
        jparams, jb)
    _close(T.forward_train(cfg, params, b)[0], jlogits)
    pre = {k: v for k, v in b.items() if k != "targets"}
    jpre = {k: v for k, v in jb.items() if k != "targets"}
    _prefill_and_decode_match(jcfg, jparams, cfg, params, jpre, pre, 16)


def _prefill_and_decode_match(jcfg, jparams, cfg, params, jb, b, S,
                              rtol=1e-4):
    """The prefill of S tokens (4 slots to spare) and one decode step,
    logits and every cache leaf, against the reference's (jitted)."""
    logits, cache = T.prefill(cfg, params, b, cache_len=S + 4)
    j_logits, j_cache = jax.jit(lambda p, bb: JT.prefill(
        jcfg, p, bb, compute_dtype=jnp.float32, cache_len=S + 4))(jparams, jb)
    _close(logits, j_logits, rtol)
    tok = np.argmax(np.asarray(j_logits)[:, -1], axis=-1)[:, None]
    logits, cache = T.decode_step(
        cfg, params, {"token": torch.as_tensor(tok), "pos": S}, cache)
    j_logits, j_cache = jax.jit(lambda p, bb, c: JT.decode_step(
        jcfg, p, bb, c, compute_dtype=jnp.float32))(
            jparams, {"token": jnp.asarray(tok, jnp.int32),
                      "pos": jnp.asarray(S, jnp.int32)}, j_cache)
    _close(logits, j_logits, rtol)
    want = dict(tree.flatten_with_path(jax.tree.map(np.asarray, j_cache)))
    got = dict(tree.flatten_with_path(cache))
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k], rtol)


def test_mesh_hints_change_nothing():
    """`attn_seq_shard` (both of its forms) and `ssm.head_shard`:
    `torch.equal` to the runs without, in the forward and the prefill."""
    gen = torch.Generator().manual_seed(0)
    toks = torch.as_tensor(_tokens(7, (1, 20)))
    for arch, knobs in ((DENSE, [{"attn_seq_shard": True},
                                 {"attn_seq_shard": "head"}]),
                        (HYBRID, [{"ssm": "head_shard"}])):
        base = get_config(arch).reduced()
        params = T.init_params(base, gen, device="cpu")
        plain = (T.forward_train(base, params, {"tokens": toks})[0],
                 T.prefill(base, params, {"tokens": toks})[0])
        for knob in knobs:
            if knob == {"ssm": "head_shard"}:
                knob = {"ssm": dataclasses.replace(base.ssm,
                                                   head_shard=True)}
            cfg = dataclasses.replace(base, **knob)
            hinted = (T.forward_train(cfg, params, {"tokens": toks})[0],
                      T.prefill(cfg, params, {"tokens": toks})[0])
            assert all(torch.equal(u, v) for u, v in zip(hinted, plain))


# ---------------------------------------------------------------------------
# the multi-process bootstrap
# ---------------------------------------------------------------------------

def test_distributed_is_a_noop_without_a_cluster(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert D.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert D.is_coordinator() and D.world_size() == 1
    D.sync_hosts()  # a world of one: nothing to wait for
    with pytest.raises(RuntimeError, match="256"):
        D.validate_mesh_capacity()
    with pytest.raises(RuntimeError, match="512"):
        D.validate_mesh_capacity(multi_pod=True)
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        D.initialize_distributed(coordinator="127.0.0.1:1")
    with pytest.raises(RuntimeError, match="256 ranks"):
        M.make_production_mesh()


def test_train_distributed_matches_the_plain_run(capsys, monkeypatch):
    """`launch.train --distributed` in a world of one over gloo (the
    reference's environment variables) trains as the run without it and
    destroys its group at the end."""
    argv = ["--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
            "--log-every", "1"]
    plain = train.run(argv, device="cpu")
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    capsys.readouterr()
    dist = train.run(argv + ["--distributed"], device="cpu")
    assert "distributed: 1 processes (single-host)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    assert dist["losses"] == plain["losses"]
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(dist["params"]), tree.leaves(plain["params"])))


# ---------------------------------------------------------------------------
# what ran beside the tests above: two gloo ranks, the reference's dry run
# ---------------------------------------------------------------------------

def test_two_gloo_processes_bootstrap(background):
    got = [_result(p, timeout=120) for p in background["gloo"]]
    assert [g["coordinator"] for g in got] == [True, False]
    assert all(g["multi"] and g["world"] == 2 and g["mesh"] == [2, 1]
               and g["sum"] == 3.0 for g in got)


def test_argument_bytes_equal_xlas(xla):
    cfg = get_config("whisper-tiny")
    with M.production_world() as mesh:
        train_ = dryrun.lower_one(cfg, "train_4k", mesh)["memory"]
        decode = dryrun.lower_one(cfg, "decode_32k", mesh)["memory"]
    assert train_["argument_size"] == xla["train_4k"]["argument_size"] \
        == 430_750_252
    sizes = dict(zip(M.SINGLE_POD_AXES, M.SINGLE_POD_SHAPE))
    assert decode["argument_size"] == xla["decode_keep_unused"] \
        == 196_846_124
    # what a decode step leaves unread: the encoder, the cross blocks'
    # K/V projections (the cross K/V come from the cache) and the frames
    params = T.init_params(cfg, None, dtype=torch.bfloat16, device="meta")
    p_specs = SH.flatten_specs(SH.param_shardings(cfg, sizes, params))
    unread = sum(
        SH.shard_bytes(p_specs[k], v, sizes)
        for k, v in tree.flatten_with_path(params)
        if k.startswith(("enc_blocks/", "enc_norm/"))
        or k in ("cross_blocks/attn/wk", "cross_blocks/attn/wv"))
    frames = dryrun.input_specs(cfg, "decode_32k")["frames"]
    unread += SH.shard_bytes(("data", None, None), frames, sizes)
    assert decode["argument_size"] - xla["decode_32k"]["argument_size"] \
        == unread == 10_262_016
    # XLA's output size also counts the result tuple's table of 8-byte
    # pointers, one a leaf: params, step, mu, nu and the loss for train;
    # the logits and the four cache leaves for decode
    n = len(tree.leaves(params))
    assert xla["train_4k"]["output_size"] - train_["output_size"] \
        == 8 * (3 * n + 2)
    assert xla["decode_32k"]["output_size"] - decode["output_size"] \
        == 8 * (1 + len(tree.leaves(T.cache_specs(cfg, 128, 32768))))


def test_plan_combinations_and_optimize_config_equal_the_references(xla):
    combos, skips = dryrun.plan_combinations(ASSIGNED,
                                             list(dryrun.INPUT_SHAPES))
    assert [[a, s, c.name] for a, s, c in combos] == xla["combos"]
    assert len(combos) == 39
    assert [list(s) for s in skips] == xla["skips"] == [
        ["whisper-tiny", "long_500k", "no sub-quadratic attention variant"]]
    got = {f"{a}|{k}": json.loads(json.dumps(dataclasses.asdict(
        dryrun.optimize_config(get_config(a), k))))
        for a in ASSIGNED for k in ("train", "prefill", "decode")}
    assert got == xla["optimized"]
