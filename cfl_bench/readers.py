"""Shared arithmetic of the per-layer readers in `metrics/`.  A reader
that finds nothing to read returns None, and the harness leaves its
metric out of the result."""
from __future__ import annotations

from cfl_bench import counts


def idle_share(rec) -> float | None:
    """Percent of the traced span in which no operation ran on the
    device."""
    t = rec.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def idle_share_within(rec, spans) -> float | None:
    """Percent of the host's intervals `spans` (seconds from the traced
    span's first device operation) in which no operation ran on the
    device."""
    t = rec.trace
    length = sum(e - s for s, e in spans or ())
    if t is None or not t.device or length <= 0:
        return None
    return 100.0 * (1.0 - t.busy_within(spans) / length)


def roofline_share(rec, patterns: tuple, least_s: float) -> float | None:
    """Percent of the device time of the kernels named by `patterns` that
    their least time `least_s` (over the same launches) makes up."""
    if rec.trace is None:
        return None
    seconds, launches = rec.trace.kernel_seconds(*patterns)
    if not launches or seconds <= 0:
        return None
    return 100.0 * least_s / seconds


def share_of_fp32_peak(ops: float, seconds: float) -> float | None:
    if seconds <= 0:
        return None
    return 100.0 * ops / (seconds * counts.FP32_FLOPS_PER_S)
