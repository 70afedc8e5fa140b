"""The training command line (counterpart of `repro/launch/train.py`).

Trains a model of the zoo on the card (or on `--device cpu`): plain
training with AdamW or SGD, an optional cosine schedule and global-norm
clipping, or the federated straggler-aware mode (deadline-masked,
1/p-weighted aggregation over the Eq. 14-16 load allocation), on the
seeded token stream of `data.synthetic.token_batches`, from a seeded
random init, with optional checkpoints.  The flags and defaults are the
reference's.

  python -m repro_torch.launch.train --arch lm-100m --steps 300 --batch 8 --seq 256
  python -m repro_torch.launch.train --arch granite-8b --reduced --federated

Both modes compute in float32 without remat, as the reference's do.
The vlm and audio families train on stub patches or frames drawn per
step from the run's generator (`add_modality_stubs`).
`--distributed` starts `torch.distributed` from the cluster's
environment (`launch.distributed.initialize_distributed`: NCCL for a run
on the card, gloo for one on the CPU), prints the reference's
`distributed:` line and trains as without it (the reference's step
reads no collective either); the group is destroyed at the end of the
run.  On the card the run ends with the peak of allocated device
memory.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_fed_train_step, make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import make_optimizer


def add_modality_stubs(batch: dict, cfg,
                       gen: torch.Generator | None = None) -> dict:
    """Add the stub inputs of the vlm and audio families, as the
    reference: 0.1 * N(0, 1) vision patches (B, n_patches, d_vision) or
    audio frames (B, n_frames, d_model), float32, drawn from `gen` on the
    tokens' device (fresh each call).  Other configs' batches pass
    through."""
    if cfg.vlm or cfg.encdec:
        tokens = batch["tokens"]
        shape = ((cfg.vlm.n_patches, cfg.vlm.d_vision) if cfg.vlm
                 else (cfg.encdec.n_frames, cfg.d_model))
        stub = torch.randn((tokens.shape[0], *shape), generator=gen,
                           device=tokens.device).mul_(0.1)
        batch["patches" if cfg.vlm else "frames"] = stub
    return batch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-100m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="train the family-preserving smoke variant")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--warmup", type=int, default=0,
                    help="cosine schedule warmup steps (0 = constant lr)")
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="global-norm gradient clipping (0 = off)")
    ap.add_argument("--distributed", action="store_true",
                    help="initialize torch.distributed from the cluster env")
    ap.add_argument("--federated", action="store_true",
                    help="straggler-aware deadline-masked aggregation")
    ap.add_argument("--n-clients", type=int, default=8)
    ap.add_argument("--nu", type=float, default=0.2,
                    help="federated heterogeneity factor")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None, device: str | torch.device | None = None) -> dict:
    """Parse `argv`, train, print the reference's lines; returns {"cfg",
    "params", "opt_state", "losses", "step_seconds" (host seconds of each
    step, ending in the loss's read-back), "metrics" (the last step's
    metrics as floats: a moe model's plain steps carry "moe_aux_loss"),
    "fed" (the FedState or None), "n_params", "peak_bytes" (card only,
    else None), "args"}.  `device` overrides `--device`."""
    args = parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    if not args.distributed:
        return _train(args, dev)
    from repro_torch.launch.distributed import (initialize_distributed,
                                                world_size)
    multi = initialize_distributed(
        backend="nccl" if dev.type == "cuda" else "gloo")
    try:
        print(f"distributed: {world_size()} processes "
              f"({'multi' if multi else 'single'}-host)")
        return _train(args, dev)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args: argparse.Namespace, dev: torch.device) -> dict:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=dev)
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={dev}")

    opt = make_optimizer(args.optimizer, args.lr)
    opt_state = opt.init(params)
    it = token_batches(args.seed, batch=args.batch, seq_len=args.seq,
                       vocab=cfg.vocab, device=dev)

    fstate = None
    if args.federated:
        from repro_torch.fed import FedConfig, fed_setup
        from repro_torch.fed.trainer import round_weights
        from repro_torch.sim.network import paper_fleet
        n_clients = min(args.n_clients, args.batch)
        if n_clients != args.n_clients:
            print(f"note: clamping n_clients to batch size ({n_clients})")
        args.n_clients = n_clients
        per_client = args.batch // args.n_clients
        fleet = paper_fleet(args.nu, args.nu, seed=args.seed,
                            n=args.n_clients, d=cfg.d_model)
        fstate = fed_setup(fleet.edge, FedConfig(
            n_clients=args.n_clients, sequences_per_client=per_client,
            target_sequences=args.batch))
        print(f"federated: t*={fstate.plan.t_star:.2f}s "
              f"loads={fstate.plan.loads.tolist()}")
        step = make_fed_train_step(cfg, opt)
        batch_clients = np.repeat(np.arange(args.n_clients), per_client)
        rng = np.random.default_rng(args.seed)
    else:
        schedule = None
        if args.warmup > 0:
            from repro_torch.optim.schedules import cosine_with_warmup
            schedule = cosine_with_warmup(1.0, args.warmup, args.steps)
        step = make_train_step(cfg, opt, compute_dtype=torch.float32,
                               remat=False, clip_norm=args.clip_norm,
                               lr_schedule=schedule)

    wall = 0.0
    losses, step_seconds = [], []
    _sync(dev)
    t_start = time.perf_counter()
    for s in range(1, args.steps + 1):
        t0 = time.perf_counter()
        batch = add_modality_stubs(next(it), cfg, gen)
        if args.federated:
            w, dt = round_weights(fstate, rng, batch_clients)
            params, opt_state, metrics = step(
                params, opt_state, batch,
                torch.as_tensor(w, dtype=torch.float32).to(dev))
            wall += dt
        else:
            params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        step_seconds.append(time.perf_counter() - t0)
        if s % args.log_every == 0:
            msg = (f"step {s:5d} loss {losses[-1]:.4f} "
                   f"({(time.perf_counter()-t_start)/s:.2f}s/step)")
            if args.federated:
                msg += f" sim_wall {wall:.0f}s"
            print(msg, flush=True)
        if args.ckpt_dir and s % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, s,
                            {"params": params, "opt": opt_state})
    print(f"final loss {np.mean(losses[-10:]):.4f} "
          f"(first 10: {np.mean(losses[:10]):.4f})")
    peak = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"peak memory {peak / 2**30:.2f} GiB allocated on "
              f"{torch.cuda.get_device_name(dev)}")
    return {"cfg": cfg, "params": params, "opt_state": opt_state,
            "losses": losses, "step_seconds": step_seconds,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "fed": fstate,
            "n_params": n_params, "peak_bytes": peak, "args": args}


def main(argv=None, device: str | torch.device | None = None) -> int:
    run(argv, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
