"""Roofline-pruned tile search: enumerate, prune, measure, persist.

The counterpart of `repro/tune/tuner.py`.  For one `(family, shape)` the
tuner:

  1. enumerates the family's candidate tiles for the backend (on the
     card, the tiles its CUDA kernel launches with);
  2. bounds each candidate with the port's roofline,
     `roofline.kernel_terms(family, shape, block)`: the least time the
     card could take for the work that tile grid issues (padded tensor-
     core tiles, a row tile's float64 partials).  A candidate whose bound
     exceeds `slack x` the best bound cannot win unless the model is off
     by more than `slack`, so it is pruned without running;
  3. times the survivors (`measure`: CUDA events around `iters` calls
     queued behind a sleep kernel on the card, the median of 5 runs;
     `perf_counter` on the CPU) and picks the winner deterministically:
     ties go to the earlier candidate;
  4. persists the winner in the tile cache keyed by `(family, shape
     bucket, backend)`, from which `block="auto"` serves it.

Tuning is always explicit (this module or `python -m repro_torch.tune`);
`block="auto"` only reads the cache.  `terms_fn` / `measure_fn` are
injectable (the tests prune and pick winners without a card).
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import subprocess
import time
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import common
from repro_torch.roofline.analysis import kernel_terms

from .cache import TileCache, bucket_shape, user_cache_path
from .families import FAMILIES

# How far a candidate's roofline lower bound may sit above the best
# candidate's before it is pruned unmeasured.  The slack absorbs the
# model's attainment gap (a kept candidate may run `slack x` above its
# bound and still beat a pruned one at its bound).
DEFAULT_SLACK = float(os.environ.get("REPRO_TORCH_TUNE_PRUNE_SLACK", "8.0"))


def device_name(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (the device's
    `torch.cuda.get_device_name` where nvidia-smi cannot be run), or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(index)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    family: str
    shape: tuple
    bucket: tuple
    backend: str
    block: tuple            # the winner
    us: float               # its measured time
    bound_us: float         # its roofline lower bound
    candidates: tuple       # full enumeration order
    bounds_us: tuple        # lower bound per candidate (same order)
    pruned: tuple           # candidates skipped by the roofline model
    measured: tuple         # (block, us) per survivor
    device: str = "cpu"     # where it was measured

    def meta(self, extra: Optional[dict] = None) -> dict:
        m = {"us": round(self.us, 3), "bound_us": round(self.bound_us, 3),
             "n_candidates": len(self.candidates),
             "n_pruned": len(self.pruned),
             "measured_us": [[list(b), round(us, 3)]
                             for b, us in self.measured],
             "shape": list(self.shape), "torch": torch.__version__,
             "device": self.device, "source": "measured"}
        m.update(extra or {})
        return m


def roofline_bound(terms: dict) -> float:
    """Achievable-time lower limit: the binding compute/memory term."""
    return max(terms["t_compute"], terms["t_memory"])


def candidate_terms(family, shape, block) -> dict:
    """The roofline terms of one candidate: `roofline.kernel_terms` of
    the family's kernel at `shape` with that tile."""
    return kernel_terms(family.kernel, shape, block)


# the stream is held by a sleep kernel of this many cycles (~4 ms at
# 1.98 GHz) while a timed run is enqueued, doubled while too short
SLEEP_CYCLES = 2**23
REPEATS = 5  # timed runs per candidate on the card; the median is kept


def measure(fn, args, iters: int = 20) -> float:
    """Time (us) of one call, after one warm-up call.

    Where an operand is on the card: the median over `REPEATS` runs of
    CUDA events around `iters` back-to-back calls queued behind a sleep
    kernel, so that the host's enqueue stays outside the span (a run
    whose sleep ended before the enqueue did is taken again with a
    longer sleep).  Elsewhere: `perf_counter` around `iters` calls."""
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    fn(*args)
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e6
    cycles, samples = SLEEP_CYCLES, []
    while len(samples) < REPEATS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        drained = start.query()  # the card reached the run already
        end.synchronize()
        if drained:
            if cycles >= 2**30:
                raise RuntimeError("the host cannot enqueue a timed run "
                                   "within a 0.5 s hold of the stream")
            cycles *= 2
            continue
        samples.append(start.elapsed_time(end) / iters * 1e3)
    return statistics.median(samples)


def prune(candidates: list, bounds_us: list,
          slack: float = DEFAULT_SLACK) -> tuple[list, list]:
    """(survivors, pruned): keep candidates within `slack x` of the best
    roofline bound.  Every pruned candidate is dominated under the
    model: its lower bound alone exceeds what the best candidate could
    take even running `slack x` above its own bound."""
    best = min(bounds_us)
    if best <= 0:
        # a zero bound would collapse the slack band and prune every
        # positive-bound candidate: the model ranks nothing, measure all
        return list(candidates), []
    survivors = [c for c, b in zip(candidates, bounds_us)
                 if b <= slack * best]
    pruned = [c for c, b in zip(candidates, bounds_us)
              if b > slack * best]
    return survivors, pruned


def autotune(family_name: str, shape: tuple, *,
             slack: float = DEFAULT_SLACK, iters: int = 20,
             backend: Optional[str] = None, device=None,
             cache: Optional[TileCache] = None, store: bool = True,
             terms_fn: Optional[Callable] = None,
             measure_fn: Optional[Callable] = None,
             verbose: bool = False) -> TuneResult:
    """Tune one `(family, shape)` and (by default) persist the winner.

    device: where the candidates run (None: `cuda`, which must exist);
    backend: the cache key's backend (None: `kernels.common.backend` of
    `device`)."""
    dev = resolve_device(device)
    family = FAMILIES[family_name]
    shape = tuple(int(s) for s in shape)
    backend = backend or common.backend(dev)
    candidates = family.candidate_blocks(shape, backend)
    if terms_fn is None:
        def terms_fn(block):
            return candidate_terms(family, shape, block)
    bounds = [roofline_bound(terms_fn(b)) * 1e6 for b in candidates]
    survivors, pruned = prune(candidates, bounds, slack=slack)

    if measure_fn is None:
        args = family.make_args(shape, device=dev)

        def measure_fn(block):
            return measure(family.bind(shape, block), args, iters=iters)
    timed = [(measure_fn(b), i, b) for i, b in enumerate(survivors)]
    best_us, _, winner = min(timed)  # ties -> earliest candidate

    result = TuneResult(
        family=family_name, shape=shape, bucket=bucket_shape(shape),
        backend=backend, block=tuple(winner), us=float(best_us),
        bound_us=float(bounds[candidates.index(winner)]),
        candidates=tuple(candidates), bounds_us=tuple(bounds),
        pruned=tuple(pruned),
        measured=tuple((tuple(b), float(us)) for us, _, b in timed),
        device=device_name(dev))
    if verbose:
        print(f"tune {family_name} {shape} [{backend}, {result.device}]: "
              f"{len(candidates)} candidates, {len(pruned)} pruned, "
              f"winner {winner} at {best_us:.3f} us (bound "
              f"{result.bound_us:.3f} us); measured "
              + ", ".join(f"{b} {us:.3f}" for b, us in result.measured),
              flush=True)
    if store:
        cache = cache or TileCache(user_cache_path())
        cache.store(family_name, shape, backend, winner, result.meta())
    return result


def tune_shapes(shapes: Optional[dict] = None, *,
                cache: Optional[TileCache] = None,
                slack: float = DEFAULT_SLACK, iters: int = 20, device=None,
                verbose: bool = True) -> list[TuneResult]:
    """Tune a `{family: [shape, ...]}` map (defaults to the CI set).

    A family's shapes that share a bucket share one cache entry.  Each
    is tuned, and the entry takes the candidate whose times, summed over
    those shapes, are least (ties to the earlier candidate), so that no
    shape of the bucket is tuned for another's sake (the reference's
    last shape overwrites the others).  The entry's `us` and `bound_us`
    are the last shape's; `bucket_us` lists each shape's time."""
    from .families import CI_SHAPES

    shapes = shapes if shapes is not None else CI_SHAPES
    cache = cache or TileCache(user_cache_path())
    results = []
    for family_name, shape_list in shapes.items():
        groups: dict[tuple, list[tuple]] = {}
        for shape in shape_list:
            shape = tuple(int(v) for v in shape)
            groups.setdefault(bucket_shape(shape), []).append(shape)
        for group in groups.values():
            tuned = [autotune(family_name, shape, slack=slack, iters=iters,
                              device=device, store=False, verbose=verbose)
                     for shape in group]
            results.extend(tuned)
            times = [dict(r.measured) for r in tuned]
            last = tuned[-1]
            common = [b for b in last.candidates
                      if all(b in t for t in times)] or [last.block]
            block = min(common, key=lambda b: (
                sum(t.get(b, 0.0) for t in times), common.index(b)))
            meta = last.meta({
                "us": round(times[-1][block], 3),
                "bound_us": round(
                    last.bounds_us[last.candidates.index(block)], 3),
                "bucket_us": [[list(r.shape), round(t[block], 3)]
                              for r, t in zip(tuned, times)]})
            if verbose and len(group) > 1:
                print(f"tune {family_name} bucket {last.bucket}: {block} "
                      f"for {group}", flush=True)
            cache.store(family_name, last.shape, last.backend, block, meta)
    return results
