"""Spans around the calls into the port's layers, and the device trace
of a traced run.

`Spans` times each named call on the host clock (the caller ends a span
with a read-back or a sync where the time is to include the device's
work) and, while a profile is recording, marks it in the trace.
`Profile` runs `torch.profiler` over a steady part of the window and
keeps only what the metrics read: every device operation's name, start
and end, and the host's operations, to name what the host did while the
device sat idle.  Nothing is written to disk.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch


class Spans:
    def __init__(self) -> None:
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self.marking = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = (torch.profiler.record_function(f"bench.{name}")
                if self.marking else contextlib.nullcontext())
        t0 = time.perf_counter()
        with mark:
            yield
        self.seconds[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return float(sum(self.seconds.get(name, ())))

    def count(self, name: str) -> int:
        return len(self.seconds.get(name, ()))


@dataclasses.dataclass
class TraceRecord:
    """A traced span of the window, times in seconds from its start."""

    window_s: float
    device: list            # [(name, start, end)] device operations
    host: list              # [(name, start, end)] host operations

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return float(sum(e - s for s, e in self._union()))

    def _union(self) -> list[tuple[float, float]]:
        spans = sorted((max(s, 0.0), min(e, self.window_s))
                       for _, s, e in self.device)
        out: list[list[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_within(self, spans: list[tuple[float, float]]) -> float:
        """Seconds in which some operation ran on the device inside the
        disjoint intervals `spans`."""
        return float(sum(max(0.0, min(e, b) - max(s, a))
                         for s, e in self._union() for a, b in spans))

    def gaps(self) -> list[tuple[float, float]]:
        """The device's idle intervals inside the window."""
        out, t = [], 0.0
        for s, e in self._union():
            if s > t:
                out.append((t, s))
            t = e
        if t < self.window_s:
            out.append((t, self.window_s))
        return out

    def kernel_seconds(self, *patterns: str) -> tuple[float, int]:
        """(device seconds, launches) of the operations whose name holds
        one of `patterns`."""
        hits = [e - s for name, s, e in self.device
                if any(p in name for p in patterns)]
        return float(sum(hits)), len(hits)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation running at their start."""
        by_op: dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            by_op[name] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:400]
        starts = np.array([s for _, s, _ in self.host])
        ends = np.array([e for _, _, e in self.host])
        by_host: dict[str, float] = defaultdict(float)
        for s, e in gaps:
            inside = np.flatnonzero((starts <= s) & (ends >= s))
            name = ("(no host operation)" if inside.size == 0 else
                    self.host[inside[np.argmax(starts[inside])]][0])
            by_host[name] += e - s
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(n), v] for n, v in ops],
                "idle_gaps": [[_short(n), v] for n, v in idle]}


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


class Profile:
    """`torch.profiler` over the units run inside `with Profile(spans,
    device, host) as p:`; `p.record` is the TraceRecord after the block.

    Without `host` only the device's activity is recorded, which costs
    the host next to nothing, so the device's busy share is that of an
    untraced run; the window is the host's seconds from a sync before the
    first unit to a sync after the last, and the device's idle time
    before its first operation and after its last is counted as one gap
    at the end.  With `host` the host's operations are recorded too (the
    names of what it did while the device sat idle), at a cost that
    stretches a host-paced unit."""

    def __init__(self, spans: Spans, device: torch.device,
                 host: bool = False) -> None:
        self.spans = spans
        self.device = device
        self.host = host
        self.record: TraceRecord | None = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CUDA] \
            if self.device.type == "cuda" else []
        if self.host or not acts:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        _sync(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.spans.marking = self.host
        self._mark = torch.profiler.record_function("bench.window")
        self._mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        seconds = time.perf_counter() - self.t0
        self._mark.__exit__(*exc)
        self.spans.marking = False
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.record = _record(self.prof, self.host, seconds)
        return False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _record(prof, host: bool, seconds: float) -> TraceRecord:
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events()
              if not (e.device_type == cuda and e.name.startswith("bench."))]
    window = [e for e in events if e.name == "bench.window"]
    kernels = [e for e in events if e.device_type == cuda]
    if host and window:
        t0 = window[0].time_range.start
        seconds = (window[0].time_range.end - t0) * 1e-6
    else:
        t0 = min((e.time_range.start for e in kernels), default=0.0)
    device, hosts = [], []
    for e in events:
        span = (e.name, (e.time_range.start - t0) * 1e-6,
                (e.time_range.end - t0) * 1e-6)
        if e.device_type == cuda:
            device.append(span)
        elif host and e.name != "bench.window":
            hosts.append(span)
    return TraceRecord(window_s=seconds, device=device, host=hosts)
