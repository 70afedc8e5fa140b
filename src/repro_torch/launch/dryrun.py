"""The dry run on the production meshes (counterpart of
`repro/launch/dryrun.py`): every (architecture x input shape) laid out
on the 16 x 16 and 2 x 16 x 16 meshes with no card and no allocation.

    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes [--optimized] \\
        [--out results.json]

For each combination `lower_one` builds the parameters (bf16), the AdamW
state (bf16 moments for the `FSDP_ARCHS`, else float32), the batch
(`configs.input_specs`) and, for prefill and decode, the cache
(`transformer.cache_specs`, bf16), all on the meta device; gives each
leaf its spec by the rules of `launch.sharding`; and places every
argument and output leaf as a meta-device DTensor on the mesh of a fake
world of 256 or 512 ranks (`launch.mesh.production_world`), whose
placements must give back the leaf's shape.  It records:

  * n_params;
  * memory.argument_size and output_size: one device's bytes, summed
    over the local shard shapes of the step's arguments (params, opt
    and batch for train; params and batch for prefill; params, batch
    and cache for decode) and of its outputs (params, opt and the
    replicated loss; or the batch-sharded (B, 1, V) float32 logits and
    the cache), with the split into params, opt, batch, cache and the
    rest of the outputs;
  * model_flops, `repro_torch.roofline.analysis.model_flops`.

The reference's `argument_size_in_bytes` counts only the arguments its
jitted step reads (`jax.jit` drops unused ones), so where a step leaves
an input unread (whisper-tiny's decode reads neither its encoder nor
its frames) the port's sum is the larger.

What does not carry over, and stays None in the results: XLA's
compile time, `temp_size` and `generated_code_size`; the per-device
`cost_analysis` FLOPs and bytes; the trip-count-corrected HLO counts
(`roofline.hlo_graph`); and the collective bytes (`launch.hlo_stats`).
All of them are read off XLA's compiled module; eager PyTorch compiles
none.  Results accumulate into the JSON file in the reference's layout,
so a sweep can run incrementally.
"""
from __future__ import annotations

import argparse
import dataclasses as _dc
import json
import math
import sys
import time
import traceback
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import tree
from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config, input_specs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_sizes, production_world
from repro_torch.launch.sharding import (FSDP_ARCHS, base_arch_name,
                                         batch_shardings, cache_shardings,
                                         flatten_specs, opt_state_shardings,
                                         param_shardings, replicated,
                                         shard_bytes, shard_meta)
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.roofline.analysis import model_flops


def optimize_config(cfg: ArchConfig, kind: str = "train") -> ArchConfig:
    """The reference's winning recipes per family.  kind: train | prefill
    | decode.  The repeat-KV attention recipe only pays off for
    full-sequence passes; at decode it would materialize the R-fold
    repeated KV cache, so decode keeps the grouped path."""
    repl: dict = {}
    if kind in ("train", "prefill") and cfg.n_heads \
            and cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        repl["attn_impl"] = "repeat"
        repl["softmax_dtype"] = "bf16"
        if cfg.n_heads % 16 != 0 and cfg.n_heads > 16:
            # heads don't divide the model axis: pad-shard the score
            # head dim
            repl["attn_seq_shard"] = "head"
    if cfg.ssm is not None:
        repl["ssm"] = _dc.replace(cfg.ssm, head_shard=True)
    if cfg.moe is not None:
        repl["moe"] = _dc.replace(cfg.moe, capacity_factor=1.25)
    return _dc.replace(cfg, **repl) if repl else cfg


def _maybe_sliding_window(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """long_500k on a full-attention arch runs the sliding-window variant."""
    if shape_name == "long_500k" and not cfg.supports_shape("long_500k"):
        if cfg.arch_type in ("dense", "moe", "vlm"):
            return cfg.with_sliding_window(8192)
    return cfg


def plan_combinations(archs, shapes):
    """All (arch, shape, effective_cfg) combos that lay out; skips
    recorded."""
    combos, skips = [], []
    for a in archs:
        base = get_config(a)
        for s in shapes:
            cfg = _maybe_sliding_window(base, s)
            if cfg.supports_shape(s):
                combos.append((a, s, cfg))
            else:
                skips.append((a, s, "no sub-quadratic attention variant"))
    return combos, skips


def _placed_bytes(specs, values, mesh: DeviceMesh) -> int:
    """One device's bytes of a tree of meta leaves under a spec tree,
    each leaf placed as a DTensor on `mesh`."""
    specs = flatten_specs(specs)
    total = 0
    for path, leaf in tree.flatten_with_path(values):
        shard_meta(specs[path], leaf, mesh)
        total += shard_bytes(specs[path], leaf, mesh)
    return total


def lower_one(cfg: ArchConfig, shape_name: str, mesh: DeviceMesh,
              opt_name: str = "adamw", remat="full",
              zero1: bool = False) -> dict:
    """Lay out one (arch, shape) on `mesh`, a production mesh
    (`launch.mesh.production_world`).  `remat` is recorded only: it
    changes no argument."""
    t0 = time.perf_counter()
    spec = INPUT_SHAPES[shape_name]
    kind, B, S = spec["kind"], spec["global_batch"], spec["seq_len"]
    batch = input_specs(cfg, shape_name)
    params = T.init_params(cfg, None, dtype=torch.bfloat16, device="meta")
    p_sh = param_shardings(cfg, mesh, params)
    parts = {"params": _placed_bytes(p_sh, params, mesh),
             "batch": _placed_bytes(batch_shardings(cfg, mesh, batch), batch,
                                    mesh)}
    if kind == "train":
        state_dtype = (torch.bfloat16 if base_arch_name(cfg.name)
                       in FSDP_ARCHS else torch.float32)
        opt = make_optimizer(opt_name, 1e-4, state_dtype=state_dtype)
        opt_state = opt.init(params)
        parts["opt"] = _placed_bytes(
            opt_state_shardings(mesh, p_sh, opt_state, zero1=zero1),
            opt_state, mesh)
        loss = {"loss": torch.empty((), device="meta")}
        if cfg.moe:
            loss["moe_aux_loss"] = torch.empty((), device="meta")
        parts["loss"] = _placed_bytes(replicated(mesh, loss), loss, mesh)
        args = ("params", "opt", "batch")
        outs = ("params", "opt", "loss")
    else:
        cache = T.cache_specs(cfg, B, S, dtype=torch.bfloat16)
        parts["cache"] = _placed_bytes(cache_shardings(cfg, mesh, cache),
                                       cache, mesh)
        logits = {"logits": torch.empty((B, 1, cfg.vocab), device="meta")}
        parts["logits"] = _placed_bytes(
            batch_shardings(cfg, mesh, logits), logits, mesh)
        args = ("params", "batch") + (("cache",) if kind == "decode" else ())
        outs = ("logits", "cache")
    sizes = axis_sizes(mesh)
    return {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in sizes.values()),
        "n_devices": math.prod(sizes.values()),
        "n_params": int(sum(x.numel() for x in tree.leaves(params))),
        "seconds": time.perf_counter() - t0,
        "remat": remat,
        "zero1": zero1,
        "model_flops": model_flops(cfg, shape_name),
        # read off XLA's compiled module in the reference; none here
        "compile_s": None,
        "flops": None,
        "hlo_bytes": None,
        "collective_bytes": None,
        "corrected_flops": None,
        "corrected_bytes": None,
        "corrected_collectives": None,
        "memory": {
            "argument_size": sum(parts[k] for k in args),
            "output_size": sum(parts[k] for k in outs),
            **parts,
            "temp_size": None,
            "generated_code_size": None,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=[None] + list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the winning recipes (separate table)")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    try:
        with open(args.out) as f:
            results = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        results = {"runs": {}, "skips": {}}

    combos, skips = plan_combinations(archs, shapes)
    for a, s, why in skips:
        results["skips"][f"{a}|{s}"] = why
        print(f"SKIP {a} x {s}: {why}")

    n_fail = 0
    for multi_pod in meshes:
        with production_world(multi_pod) as mesh:
            mesh_name = "x".join(str(x) for x in mesh.shape)
            for a, s, cfg in combos:
                key = f"{a}|{s}|{mesh_name}"
                if key in results["runs"] and results["runs"][key].get("ok"):
                    print(f"CACHED {key}")
                    continue
                print(f"RUN {key} ...", flush=True)
                try:
                    kind = INPUT_SHAPES[s]["kind"]
                    run_cfg = optimize_config(cfg, kind) if args.optimized \
                        else cfg
                    stats = lower_one(run_cfg, s, mesh,
                                      remat="save_ar" if args.optimized
                                      else "full", zero1=args.optimized)
                    stats["ok"] = True
                    results["runs"][key] = stats
                    gib = stats["memory"]["argument_size"] / 2**30
                    print(f"  ok: {stats['seconds']:.3f}s, "
                          f"{stats['n_params']:.4e} params, "
                          f"{stats['model_flops']:.3e} model flops, "
                          f"args {gib:.3f} GiB/dev")
                except Exception as e:  # noqa: BLE001 — record and continue
                    n_fail += 1
                    results["runs"][key] = {"ok": False,
                                            "error": str(e)[:2000]}
                    print(f"  FAIL: {e}")
                    traceback.print_exc()
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
