"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (built for
an H100, sm_90a).  Phases, each printed as it finishes:

  1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
  2. build both kernels from `src/repro_torch/kernels/csrc/` (one `nvcc`
     per source, started together);
  3. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes: the round gradient at (5632, 500) with random
     weights and at (7200, 500) with w = None (rtol 1e-3 / atol 1e-6, and
     two launches bit-identical), the encode at (2016, 300, 501)
     (2e-4 * max|ref|);
  4. the main path: `repro_torch.quickstart.run` — the §IV plan, the
     encode through the kernel, 600 uncoded and 600 coded epochs — with
     the launch counters set to 0 just before it and read just after;
  5. the same coded run on the reference gradient path (no kernel),
     whose NMSE trace must agree within rtol 1e-4;
  6. time each kernel, its plain version and the one PyTorch call that
     computes the same product: CUDA events around a run of back-to-back
     calls that rotate over copies of the operands larger than the L2
     together (so each call finds its operands cold), enqueued while a
     sleep kernel holds the stream (so the host's enqueue cost stays
     outside the timed span), the median over repeats of the mean per
     call; and each kernel again on one copy, warm in L2, as the epoch
     loop finds its operands.

Any failed check raises, so the exit code is non-zero.  The line before
the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside the
# tensor cores (the encode must stay full float32, not TF32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SEC4_T_STAR = 11.9641
# The reference's main path (its batched grid solver) stops at
# t* = 11.96324 s and loads these; see tests/test_torch_plan.py.
SEC4_LOADS = [300, 300, 186, 123, 300, 300, 127, 300, 0, 0, 0, 300, 300,
              300, 300, 288, 300, 300, 300, 0, 300, 300, 300, 300]
MIN_GAIN = 3.0
L2_BYTES = 50 * 2**20
TIMING_REPEATS = 15   # timed runs per call; the median is kept
TIMING_CALLS = 40     # back-to-back calls per timed run
SLEEP_CYCLES = 2**23  # the first hold of the stream (~4 ms at 1.98 GHz)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, copies: list[tuple]) -> float:
    """Device time of one `fn(*operands)` call in ms.

    Call i takes `copies[i % len(copies)]`: one copy stays warm in L2,
    copies larger than the L2 together leave each call's operands cold.
    Each timed run enqueues `TIMING_CALLS` calls behind a sleep kernel and
    brackets them with CUDA events; if the sleep ended before the host
    finished enqueuing, the device may have waited on the host, so the run
    is repeated with a longer sleep.  Returns the median over
    `TIMING_REPEATS` runs of the run's time over its calls."""
    for i in range(2 * len(copies)):  # warm-up
        fn(*copies[i % len(copies)])
    cycles, samples = SLEEP_CYCLES, []
    while len(samples) < TIMING_REPEATS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(TIMING_CALLS):
            fn(*copies[i % len(copies)])
        end.record()
        drained = start.query()  # the device reached the run already
        end.synchronize()
        if drained:
            cycles *= 2
            check(cycles <= 2**30, "the host cannot enqueue the timed run "
                  "within a 0.5 s hold of the stream")
            continue
        samples.append(start.elapsed_time(end) / TIMING_CALLS)
    return statistics.median(samples)


def cold_copies(operands: tuple) -> list[tuple]:
    """Clones of `operands` (None stays None) whose bytes together exceed
    twice the L2, so rotating over them finds each call's operands cold."""
    size = sum(t.numel() * t.element_size() for t in operands
               if t is not None)
    n = -(-2 * L2_BYTES // size) + 1
    return [tuple(None if t is None else t.clone() for t in operands)
            for _ in range(n)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch import quickstart
    from repro_torch.api import CodedFL, Session, coding_gain
    from repro_torch.core.redundancy import _fleet_with_server
    from repro_torch.core.returns import optimal_loads
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import ref as enc_ref
    from repro_torch.kernels.round_grad import ops as rg_ops
    from repro_torch.kernels.round_grad import ref as rg_ref

    t_start = time.perf_counter()
    dev = resolve_device("cuda")  # also pins float32 products to full fp32
    card = card_line()
    phase(card)
    phase(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build(build.SOURCES)
    phase(f"build: {time.perf_counter() - t0:.2f} s wall for "
          + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items()))
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                phase(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    rg_cases = {"coded": (5632, 500, True), "uncoded": (7200, 500, False)}
    rg_inputs = {}
    for label, (m, d, weighted) in rg_cases.items():
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((m,), generator=gen, device=dev)
        w = torch.rand((m,), generator=gen, device=dev) if weighted else None
        if w is not None:
            w[::7] = 0.0  # zero-weight rows, as packing padding and misses
        beta = torch.randn((d,), generator=gen, device=dev)
        rg_inputs[label] = (x, y, w, beta)
        got = rg_ops.masked_round_gradient(x, y, w, beta)
        again = rg_ops.masked_round_gradient(x, y, w, beta)
        want = rg_ref.masked_round_gradient(x, y, w, beta)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=1e-3, atol=1e-6)
        worst = float(((got - want).abs()
                       / (1e-6 + 1e-3 * want.abs())).max())
        wdesc = "rand" if weighted else "None"
        phase(f"check round_grad {label} ({m}, {d}) w={wdesc}: max_abs_err "
              f"{err:.3e} (|ref| max {float(want.abs().max()):.3e}) "
              f"allclose(rtol 1e-3, atol 1e-6) {ok}, worst element at "
              f"{worst:.3f} of its bound; "
              f"bit-identical relaunch {torch.equal(got, again)}")
        check(ok, f"round_grad {label} disagrees with its plain version")
        check(torch.equal(got, again), f"round_grad {label} not deterministic")
        errs[f"round_grad_{label}"] = err
    c, ell, d1 = 2016, 300, 501
    g = torch.randn((c, ell), generator=gen, device=dev)
    w_enc = torch.rand((ell,), generator=gen, device=dev)
    x_enc = torch.randn((ell, d1), generator=gen, device=dev)
    got = enc_ops.encode_parity(g, w_enc, x_enc)
    want = enc_ref.encode_parity(g, w_enc, x_enc)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bound = 2e-4 * float(want.abs().max())
    ok = torch.allclose(got, want, rtol=2e-4, atol=bound)
    phase(f"check encode ({c}, {ell}, {d1}): max_abs_err {err:.3e} "
          f"bound 2e-4*max|ref| = {bound:.3e}, allclose {ok}")
    check(ok, "encode disagrees with its plain version")
    errs["encode"] = err

    # -- 4. the main path ------------------------------------------------
    rg_ops.COUNTER.reset()
    enc_ops.COUNTER.reset()
    t0 = time.perf_counter()
    out = quickstart.run(epochs=600, device=dev)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"round_grad": rg_ops.COUNTER.launches,
                "encode": enc_ops.COUNTER.launches}
    plan, res_u, res_c = out["plan"], out["uncoded"], out["coded"]
    gain = coding_gain(res_u, res_c, quickstart.TARGET)
    phase(f"main path: {main_s:.2f} s wall; plan c={plan.c} "
          f"t*={plan.t_star!r} loads={plan.loads.tolist()}")
    phase(f"main path: uncoded final NMSE {res_u.final_nmse():.3e} at "
          f"{res_u.times[-1]:.1f} s simulated; coded final NMSE "
          f"{res_c.final_nmse():.3e} at {res_c.times[-1]:.1f} s simulated; "
          f"coding gain to NMSE<={quickstart.TARGET}: {gain:.3f}x")
    phase(f"main path launches: {launches}")
    phase("main path phases (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in out["seconds"].items()))
    check(plan.c == 2016, "plan c != 2016")
    check(abs(plan.t_star - SEC4_T_STAR) <= 1e-3 * SEC4_T_STAR,
          "plan t* off by more than rtol 1e-3")
    check(plan.loads.tolist() == SEC4_LOADS, "plan loads differ")
    fleet = out["fleet"]
    host_loads, _ = optimal_loads(
        _fleet_with_server(fleet.edge, fleet.server),
        np.concatenate([np.full(24, 300), [2016]]), plan.t_star)
    check(host_loads[:-1].tolist() == plan.loads.tolist(),
          "device loads differ from the float64 host argmax at t*")
    for rep in (res_u, res_c):
        check(rep.nmse.shape == (601,) and bool(np.all(np.isfinite(rep.nmse))),
              f"{rep.label}: NMSE trace not finite or wrong shape")
    check(gain >= MIN_GAIN, f"coding gain {gain:.3f} below {MIN_GAIN}")
    check(launches == {"round_grad": 1200, "encode": 24},
          f"unexpected launch counts {launches}")

    # -- 5. the same coded run on the reference gradient path ------------
    strategy = CodedFL(key=1, fixed_c=plan.c, include_upload_delay=False,
                       redundancy_plan=plan, grad_path="reference")
    before = rg_ops.COUNTER.launches
    res_r = Session(strategy, fleet, quickstart.LR, 600, device=dev).run(
        out["data"], rng=np.random.default_rng(0), state=out["state"])
    check(rg_ops.COUNTER.launches == before,
          "the reference path launched the round-gradient kernel")
    rel = float(np.max(np.abs(res_r.nmse - res_c.nmse) / np.abs(res_r.nmse)))
    phase(f"fused vs reference coded trace: max rel NMSE diff {rel:.3e} "
          f"(bound 1e-4); times identical "
          f"{bool(np.array_equal(res_r.times, res_c.times))}")
    check(np.allclose(res_c.nmse, res_r.nmse, rtol=1e-4, atol=0.0),
          "fused and reference coded traces disagree")
    check(np.array_equal(res_r.times, res_c.times), "clocks differ")

    # -- 6. timing -------------------------------------------------------
    records = []
    for label in ("coded", "uncoded"):
        x, y, w, beta = rg_inputs[label]
        m, d = x.shape
        cold = cold_copies((x, y, w, beta))
        coef = ((x @ beta - y) * (1.0 if w is None else w)).contiguous()
        ms = time_ms(rg_ops.masked_round_gradient, cold)
        warm = time_ms(rg_ops.masked_round_gradient, [(x, y, w, beta)])
        plain = time_ms(rg_ref.masked_round_gradient, cold)
        lib = time_ms(torch.matmul, cold_copies((coef, x)))
        del cold
        n_bytes = 4 * (m * d + m * (2 if w is not None else 1) + 2 * d)
        flops = 4 * m * d + 3 * m
        bound_ms = 1e3 * max(n_bytes / HBM_BYTES_PER_S,
                             flops / FP32_FLOPS_PER_S)
        phase(f"time round_grad {label} ({m}, {d}): kernel {ms!r} ms "
              f"(L2 warm {warm!r} ms), plain {plain!r} ms, library "
              f"(r*w) @ X {lib!r} ms, bound {bound_ms!r} ms "
              f"(bytes {n_bytes})")
        records.append((label, m, d, ms, warm, plain, lib, bound_ms))
    cold = cold_copies((g, w_enc, x_enc))
    enc_ms = time_ms(enc_ops.encode_parity, cold)
    enc_warm = time_ms(enc_ops.encode_parity, [(g, w_enc, x_enc)])
    enc_plain = time_ms(enc_ref.encode_parity, cold)
    wx = (w_enc[:, None] * x_enc).contiguous()
    enc_lib = time_ms(torch.matmul, cold_copies((g, wx)))
    del cold
    enc_flops = 2 * c * ell * d1 + ell * d1
    enc_bytes = 4 * (c * ell + ell + ell * d1 + c * d1)
    enc_bound = 1e3 * max(enc_bytes / HBM_BYTES_PER_S,
                          enc_flops / FP32_FLOPS_PER_S)
    phase(f"time encode ({c}, {ell}, {d1}): kernel {enc_ms!r} ms (L2 "
          f"warm {enc_warm!r} ms), plain {enc_plain!r} ms, library "
          f"G @ (w X) {enc_lib!r} ms, bound {enc_bound!r} ms "
          f"(flops {enc_flops})")

    label, m, d, ms, warm, plain, lib, bound_ms = records[0]
    kernels = [
        {"name": "masked_round_gradient", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/round_grad.cu",
         "replaces": "src/repro/kernels/round_grad/round_grad.py:81",
         "launches": launches["round_grad"],
         "max_abs_err": errs["round_grad_coded"], "ms": ms,
         "plain_ms": plain, "bound_ms": bound_ms, "bound_by": "bytes",
         "library_ms": lib, "ms_l2_warm": warm, "shape": [m, d]},
        {"name": "encode_parity", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/encode.cu",
         "replaces": "src/repro/kernels/encode/encode.py:61",
         "launches": launches["encode"], "max_abs_err": errs["encode"],
         "ms": enc_ms, "plain_ms": enc_plain, "bound_ms": enc_bound,
         "bound_by": "operations", "library_ms": enc_lib,
         "ms_l2_warm": enc_warm, "shape": [c, ell, d1]},
    ]
    phase(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
