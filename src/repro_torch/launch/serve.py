"""Serving command line: prefill + greedy autoregressive decode with the KV
or SSM cache (counterpart of `repro/launch/serve.py`).

  python -m repro_torch.launch.serve --arch granite-8b [--full] \\
      [--batch 4 --prompt-len 64 --new-tokens 32] [--device cpu]

Runs on the card unless `--device cpu` is given; weights are random,
drawn from a `torch.Generator` seeded with `--seed`, and so are the
stub inputs of the vlm and audio families, as the reference's: 0.1 *
N(0, 1) vision patches (batch, n_patches, d_vision) or audio frames
(batch, n_frames, d_model).  `--full` takes the config at full width and
depth, float32: on one 80 GB card that is granite-8b, codeqwen1.5-7b,
minitron-4b, mamba2-1.3b, zamba2-1.2b, llama-3.2-vision-11b (36.4 GiB),
whisper-tiny (whose decoder holds 448 positions: prompt plus new tokens)
and lm-100m; mistral-large-123b, phi3.5-moe and llama4-maverick hold
more weights than the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.launch.train import add_modality_stubs
from repro_torch.models import transformer as T


def check_on_device(params: dict, device: torch.device) -> None:
    """Raise unless the parameter tree lives on `device`."""
    if params["embed"].device != device:
        raise ValueError(f"parameters are on {params['embed'].device}, the "
                         f"run is on {device}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(cfg, params, prompt: torch.Tensor, new_tokens: int,
                    extra: dict, device: str | torch.device | None = None):
    """Greedy decode; returns (tokens (B, S+new), prefill seconds,
    per-step seconds).  `prompt` (B, S) int64 and `params` on `device`
    (the card by default); each time ends in a sync."""
    dev = resolve_device(device)
    check_on_device(params, dev)
    S = prompt.shape[1]
    prefill_step = make_prefill_step(cfg, cache_len=S + new_tokens)
    decode = make_decode_step(cfg)

    batch = {"tokens": prompt, **extra}
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = [prompt]
    step_times = []
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    for i in range(new_tokens):
        toks.append(tok)
        t0 = time.perf_counter()
        logits, cache = decode(params, {"token": tok, "pos": S + i}, cache)
        _sync(dev)
        step_times.append(time.perf_counter() - t0)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    return torch.cat(toks, dim=1), t_prefill, step_times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    extra = add_modality_stubs({"tokens": prompt}, cfg, gen)
    del extra["tokens"]

    out, t_prefill, steps = greedy_generate(cfg, params, prompt,
                                            args.new_tokens, extra,
                                            device=dev)
    per_tok = float(np.median(steps))
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens}")
    print(f"prefill {t_prefill*1e3:.1f} ms; decode median "
          f"{per_tok*1e3:.2f} ms/token "
          f"({args.batch/per_tok:.1f} tok/s aggregate)")
    if tuple(out.shape) != (args.batch, args.prompt_len + args.new_tokens):
        raise RuntimeError(f"generated tokens have shape {tuple(out.shape)}")
    if not bool(torch.all((out >= 0) & (out < cfg.vocab))):
        raise RuntimeError("generated a token outside the vocabulary")
    print("output token range OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
