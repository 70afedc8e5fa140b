"""CLI: tune the port's kernel tiles on the card and persist them.

    python -m repro_torch.tune                   # tune the CI shape set
    python -m repro_torch.tune --family round_grad --shape 5632x500
    python -m repro_torch.tune --ci-defaults     # regenerate the committed
                                                 # tune/defaults.json

Winners land in the user cache (`$REPRO_TORCH_TUNE_CACHE_DIR/tiles.json`,
default `~/.cache/repro-torch-tune/tiles.json`); `--ci-defaults` writes
the committed fallback instead (commit the result).  `block="auto"`
reads both; this CLI is the only thing that tunes.  It runs on `cuda`
(`--device`, which must exist); `--device cpu` tunes the CPU backend,
whose only candidate is each kernel's default.
"""
from __future__ import annotations

import argparse
import sys

from .cache import TileCache, defaults_path
from .families import CI_SHAPES, FAMILIES
from .tuner import DEFAULT_SLACK, tune_shapes


def _parse_shape(text: str) -> tuple:
    return tuple(int(v) for v in text.replace(",", "x").split("x"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--family", choices=sorted(FAMILIES), default=None,
                    help="tune one family (default: all)")
    ap.add_argument("--shape", default=None,
                    help="one shape, e.g. 2016x300x501 (requires --family)")
    ap.add_argument("--slack", type=float, default=DEFAULT_SLACK,
                    help="roofline pruning slack factor")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls per run of a surviving candidate")
    ap.add_argument("--ci-defaults", action="store_true",
                    help="tune the CI shape set into the committed "
                         "src/repro_torch/tune/defaults.json")
    ap.add_argument("--device", default="cuda",
                    help="where the candidates run (default: cuda)")
    args = ap.parse_args(argv)

    if args.shape and not args.family:
        ap.error("--shape requires --family")
    if args.shape:
        shapes = {args.family: [_parse_shape(args.shape)]}
    elif args.family:
        shapes = {args.family: CI_SHAPES[args.family]}
    else:
        shapes = None  # the full CI set

    cache = TileCache(defaults_path()) if args.ci_defaults else None
    results = tune_shapes(shapes, cache=cache, slack=args.slack,
                          iters=args.iters, device=args.device,
                          verbose=True)
    target = cache.path if cache else "user cache"
    print(f"{len(results)} entries written to {target}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
