"""Runners: how one kind of traffic drives the port.  A traffic file's
`kind` names its runner module here; each module's `Runner(ctx)` has

  setup()                 build the port's objects, warm every shape
  window(seconds, trace)  the measured window; with `trace` (a factory of
                          `trace.Profile`) a steady part of it is traced
  end_to_end()            {metric: value} of the window
  layer_record()          what the per-layer readers read
  peak_bytes()            the device memory peak of the run so far
  release()               free the port's state
  checks()                {number: value} compared against the limits
  attempted, failed       units of work sent and failed
"""
from __future__ import annotations

import dataclasses

import torch

from cfl_bench.trace import Spans


@dataclasses.dataclass
class Context:
    workload: str
    config_name: str
    family: str
    model: dict                 # the configuration as it is run
    traffic: dict
    seed: int
    device: torch.device
    program_config: object     # the port's ArchConfig
    spans: Spans
    limits: dict


class Runner:
    """What every runner shares: its context, its counts of units sent
    and failed, its trace, and the weights it draws from the seed."""

    def __init__(self, ctx: Context) -> None:
        self.ctx = ctx
        self.attempted = self.failed = 0
        self.trace: Tracer | None = None

    def _params(self) -> dict:
        from cfl_bench import weights

        c = self.ctx
        return weights.make_params(c.family, c.model, c.seed, c.device)

    def peak_bytes(self) -> int:
        return max(self.setup_peak, self.window_peak)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def release(dev: torch.device) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class full_precision:
    """The float32 products of the reference: TF32 off in cuBLAS and
    cuDNN (or on, for the lower-precision control), restored after."""

    def __init__(self, tf32: bool = False) -> None:
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


class Tracer:
    """The traced units of a window: `units` units from unit `first` on
    with the device's activity alone (`device`: busy share, kernel
    times), then `host_units` with the host's operations too (`host`:
    what the host did while the device sat idle).  `factory(host)` makes
    a `trace.Profile`; a None factory traces nothing."""

    def __init__(self, factory, first: int, units: int,
                 host_units: int) -> None:
        self.factory = factory
        self.bounds = (first, first + units, first + units + host_units)
        self.device = self.host = None
        self._open = None

    def active(self) -> bool:
        return self._open is not None

    def done(self) -> bool:
        """Whether every traced unit has run (always, without a trace)."""
        return self.factory is None or (
            self._open is None and (self.host is not None
                                    or self.bounds[2] == self.bounds[1]))

    def tracing_host(self) -> bool:
        return self._open is not None and self._open.host

    def before(self, i: int) -> None:
        if self.factory is None or self._open is not None:
            return
        first, mid, end = self.bounds
        if i == first and mid > first:
            self._open = self.factory(False).__enter__()
        elif i == mid and end > mid:
            self._open = self.factory(True).__enter__()

    def after(self, i: int) -> None:
        if self._open is not None and i + 1 in self.bounds[1:]:
            self.close()

    def close(self) -> None:
        if self._open is None:
            return
        p, self._open = self._open, None
        p.__exit__(None, None, None)
        if p.host:
            self.host = p.record
        else:
            self.device = p.record
