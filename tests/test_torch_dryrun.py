"""The port's dry-run contract against the JAX package's, on the CPU:
`configs.input_specs`, `models.transformer.cache_specs`,
`launch.sharding` (`param_spec` for every leaf, `batch_shardings`,
`cache_shardings`, `opt_state_shardings` with and without ZeRO-1) and
`launch.dryrun.lower_one`'s `n_params` and per-device bytes, for every
assigned config at full width, every input shape it lays out, on both
production meshes.

The reference side runs without devices: its trees come from
`jax.eval_shape`, its rules take a `jax.sharding.AbstractMesh`, and its
per-device bytes are the sums of `NamedSharding.shard_shape` x itemsize
over the step's arguments (params in bf16, AdamW state, batch, and for
decode the cache).  The port's side is its meta-device trees, its
specs, and `lower_one`, all on the production meshes of the fake world
(`launch.mesh.production_world`), as the CLI runs them.  `repro.launch.dryrun` is not
imported here: importing it sets XLA_FLAGS (`tests/test_torch_launch.py`
runs it in a subprocess).  Everything is compared for equality.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.launch import sharding as JSH
from repro.models import transformer as JT
from repro.optim.optimizers import make_optimizer as j_make_optimizer
from repro_torch import tree
from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config, input_specs
from repro_torch.launch import dryrun, mesh as M, sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import make_optimizer

MESHES = {"16x16": dict(zip(M.SINGLE_POD_AXES, M.SINGLE_POD_SHAPE)),
          "2x16x16": dict(zip(M.MULTI_POD_AXES, M.MULTI_POD_SHAPE))}


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jflat(tree_):
    """{path: leaf} of a JAX tree, paths as the reference's `_path_str`."""
    return {JSH._path_str(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree_)[0]}


def _shapes(flat):
    """{path: (shape, dtype name)}, torch's and JAX's dtypes alike."""
    return {k: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for k, x in flat.items()}


def _jbytes(shardings, values) -> int:
    """Sum of shard_shape x itemsize over a tree of NamedShardings and
    its ShapeDtypeStructs."""
    sh = jax.tree.leaves(shardings,
                         is_leaf=lambda x: isinstance(x, NamedSharding))
    vals = jax.tree.leaves(values)
    assert len(sh) == len(vals)
    return sum(int(np.prod(s.shard_shape(v.shape))) * v.dtype.itemsize
               for s, v in zip(sh, vals))


def _jspecs(shardings):
    return {k: tuple(v.spec) for k, v in _jflat(shardings).items()}


@pytest.fixture(scope="module")
def j_params():
    """The reference's full-width bf16 trees, by arch (eval_shape)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = j_get_config(arch)
            cache[arch] = jax.eval_shape(lambda: JT.init_params(
                jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
        return cache[arch]
    return get


def test_assigned_and_shapes_are_the_references():
    assert ASSIGNED == J_ASSIGNED
    assert INPUT_SHAPES == J_INPUT_SHAPES


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_shardings_and_bytes_match_jax(arch, j_params):
    """For each shape the arch lays out (long_500k through the sliding-
    window variant where the reference takes one) and each mesh: the
    input, cache and parameter trees' shapes and dtypes, every leaf's
    spec, and `lower_one`'s n_params and per-device bytes, the port's
    rules and `lower_one` on the fake world's production mesh as the
    CLI runs them."""
    combos, _ = dryrun.plan_combinations([arch], list(INPUT_SHAPES))
    jparams = j_params(arch)
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    cases = []
    for _, shape, cfg in combos:
        jcfg = j_get_config(arch)
        if cfg.name != arch:
            jcfg = jcfg.with_sliding_window(cfg.sliding_window)
        params = T.init_params(cfg, None, dtype=torch.bfloat16,
                               device="meta")
        assert _shapes(dict(tree.flatten_with_path(params))) == \
            _shapes(_jflat(jparams))
        spec = INPUT_SHAPES[shape]
        B, S, kind = spec["global_batch"], spec["seq_len"], spec["kind"]
        batch, jbatch = input_specs(cfg, shape), j_input_specs(jcfg, shape)
        assert _shapes(dict(tree.flatten_with_path(batch))) == \
            _shapes(_jflat(jbatch))
        cache = jcache = None
        if kind != "train":
            cache = T.cache_specs(cfg, B, S)
            jcache = JT.cache_specs(jcfg, B, S)
            assert _shapes(dict(tree.flatten_with_path(cache))) == \
                _shapes(_jflat(jcache))
            assert all(t.device.type == "meta" for t in tree.leaves(cache))
        cases.append((shape, kind, cfg, jcfg, params, batch, jbatch, cache,
                      jcache))
    for name, sizes in MESHES.items():
        amesh = _abstract(sizes)
        with M.production_world(multi_pod=name == "2x16x16") as mesh:
            for (shape, kind, cfg, jcfg, params, batch, jbatch, cache,
                 jcache) in cases:
                p_sh = SH.param_shardings(cfg, mesh, params)
                jp_sh = JSH.param_shardings(jcfg, amesh, jparams)
                assert SH.flatten_specs(p_sh) == _jspecs(jp_sh), (shape,
                                                                   name)
                b_sh = SH.batch_shardings(cfg, mesh, batch)
                jb_sh = JSH.batch_shardings(jcfg, amesh, jbatch)
                assert SH.flatten_specs(b_sh) == _jspecs(jb_sh)
                want = {"params": _jbytes(jp_sh, jparams),
                        "batch": _jbytes(jb_sh, jbatch)}
                if kind == "train":
                    fsdp = SH.base_arch_name(cfg.name) in SH.FSDP_ARCHS
                    sd = torch.bfloat16 if fsdp else torch.float32
                    opt = make_optimizer("adamw", 1e-4,
                                         state_dtype=sd).init(params)
                    jopt = jax.eval_shape(j_make_optimizer(
                        "adamw", 1e-4, state_dtype=jnp.bfloat16 if fsdp
                        else jnp.float32).init, jparams)
                    for zero1 in (False, True):
                        o_sh = SH.opt_state_shardings(mesh, p_sh, opt,
                                                      zero1)
                        jo_sh = JSH.opt_state_shardings(amesh, jp_sh, jopt,
                                                        zero1)
                        assert SH.flatten_specs(o_sh) == _jspecs(
                            jo_sh._asdict()), (shape, name, zero1)
                        want["opt"] = _jbytes(jo_sh, jopt)
                        want["argument_size"] = (want["params"]
                                                 + want["opt"]
                                                 + want["batch"])
                        got = dryrun.lower_one(cfg, shape, mesh,
                                               zero1=zero1)
                        assert {k: got["memory"][k] for k in want} == want
                else:
                    c_sh = SH.cache_shardings(cfg, mesh, cache)
                    jc_sh = JSH.cache_shardings(jcfg, amesh, jcache)
                    assert SH.flatten_specs(c_sh) == _jspecs(jc_sh)
                    want["cache"] = _jbytes(jc_sh, jcache)
                    want["argument_size"] = (
                        want["params"] + want["batch"]
                        + (want["cache"] if kind == "decode" else 0))
                    got = dryrun.lower_one(cfg, shape, mesh)
                    assert {k: got["memory"][k] for k in want} == want
                assert got["n_params"] == n_params
                assert got["mesh"] == name
                assert got["n_devices"] == int(np.prod(list(
                    sizes.values())))
        assert not torch.distributed.is_initialized()


def test_lower_one_on_the_fake_world_places_every_leaf():
    """`lower_one` places every leaf as a meta DTensor whose placements
    give back the leaf's shape (a spec that does not divide raises), the
    fake world leaves no process group behind, and beside a live group
    it refuses to start."""
    cfg = get_config("granite-8b")
    with M.production_world() as mesh:
        st = dryrun.lower_one(cfg, "decode_32k", mesh)
        assert st["memory"]["argument_size"] > 0
        with pytest.raises(ValueError, match="divide"):
            dryrun._placed_bytes({"x": ("model",)},
                                 {"x": torch.empty(24, device="meta")}, mesh)
    assert not torch.distributed.is_initialized()
    M.make_host_mesh()
    try:
        with pytest.raises(RuntimeError, match="live"):
            with M.production_world():
                pass
    finally:
        torch.distributed.destroy_process_group()


def test_placements_and_shard_shape_agree_with_distribute_tensor():
    """The spec helpers against DTensor's own split of a meta tensor, on
    the multi-pod mesh: a dim over ("pod", "data"), one over "model",
    replication; an axis that does not divide its dim raises."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with M.production_world(multi_pod=True) as mesh:
        for spec, shape in ((((("pod", "data"), None, "model")), (64, 3, 32)),
                            (("model", None), (4096, 8)),
                            ((None, None), (5, 7)), ((), ())):
            t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
            want = distribute_tensor(t, mesh, SH.placements(spec, mesh),
                                     src_data_rank=None)
            assert SH.shard_shape(spec, shape, mesh) == \
                tuple(want.to_local().shape)
            assert tuple(SH.shard_meta(spec, t, mesh).shape) == shape
        assert SH.placements((("pod", "data"), None, "model"), mesh) == [
            Shard(0), Shard(0), Shard(2)]
        assert SH.placements((None,), mesh) == [Replicate()] * 3
        with pytest.raises(ValueError, match="divide"):
            SH.shard_shape(("model",), (24,), mesh)


def test_dryrun_main_accumulates_the_references_layout(tmp_path, capsys):
    """`main` prints a skipped combination, writes the reference's JSON
    layout (runs keyed arch|shape|mesh; as in the reference the file is
    written after each run, so a call that only skips writes none), the
    XLA-only figures None, and reads cached runs back."""
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "long_500k",
                        "--both-meshes", "--out", str(out)]) == 0
    assert "SKIP whisper-tiny x long_500k: no sub-quadratic attention " \
        "variant" in capsys.readouterr().out
    assert not out.exists()
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "train_4k",
                        "--both-meshes", "--optimized", "--out",
                        str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["skips"] == {}
    assert sorted(res["runs"]) == ["mamba2-1.3b|train_4k|16x16",
                                   "mamba2-1.3b|train_4k|2x16x16"]
    run = res["runs"]["mamba2-1.3b|train_4k|16x16"]
    assert run["ok"] and run["zero1"] and run["remat"] == "save_ar"
    assert all(run[k] is None for k in ("flops", "hlo_bytes",
                                        "collective_bytes", "compile_s"))
    assert run["memory"]["temp_size"] is None
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "train_4k",
                        "--out", str(out)]) == 0
    assert "CACHED mamba2-1.3b|train_4k|16x16" in capsys.readouterr().out


def test_optimize_config_settings_run():
    """Each config under `optimize_config` for its kinds builds on the
    meta device, and its reduced form runs a prefill and a forward on the
    CPU (the repeat/bf16 attention, the SSD head hint, the moe capacity)."""
    for arch in ASSIGNED:
        for kind in ("train", "prefill", "decode"):
            cfg = dryrun.optimize_config(get_config(arch), kind)
            T.init_params(cfg, None, device="meta")
    for arch in ("granite-8b", "zamba2-1.2b", "phi3.5-moe-42b-a6.6b",
                 "whisper-tiny"):
        cfg = dryrun.optimize_config(
            dataclasses.replace(get_config(arch).reduced(), n_layers=2),
            "train")
        gen = torch.Generator().manual_seed(0)
        params = T.init_params(cfg, gen, device="cpu")
        b = {"tokens": torch.randint(0, cfg.vocab, (1, 8), generator=gen)}
        if cfg.encdec:
            b["frames"] = torch.randn((1, cfg.encdec.n_frames, cfg.d_model),
                                      generator=gen)
        logits, _ = T.forward_train(cfg, params, b)
        last, _ = T.prefill(cfg, params, b)
        assert torch.isfinite(logits).all() and torch.isfinite(last).all()
