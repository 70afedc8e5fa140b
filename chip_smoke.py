"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (built for
an H100, sm_90a).  Phases, each printed as it finishes:

  1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
  2. build every kernel source in `src/repro_torch/kernels/csrc/` (one
     `nvcc` per source, started together);
  3. hold each kernel against its plain PyTorch version on the card at
     the main paths' shapes: the flat round gradient at (5632, 500) with
     random weights and at (7200, 500) with w = None (rtol 1e-3 / atol
     1e-6, and two launches bit-identical), the encode at (2016, 300, 501)
     (2e-4 * max|ref|); the coded round gradient at 7200 + 2016 rows of
     500 with zero-weight rows, per-row (of order 1) and scalar parity
     weights, the parity stream alone (systematic weights 0), and an
     empty parity block (which runs the flat kernel), and the tier-masked
     one at (5632, 500) for T = 3 and T = 8 — each held, with the plain
     version, against the float64 expression within rtol 1e-3 plus
     1e-6 x the magnitude of the summed terms (the bound
     `tests/test_torch_cuda.py` holds the flat kernel to), relaunches
     bit-identical, and the tier kernel at T = 1 with an all-ones mask
     `torch.equal` to the flat kernel; the in-kernel-generator encode at
     X = I, w = 1 (c = 2016, ell = 300, a key of `split_keys`), which
     returns G itself: Rademacher `torch.equal` to the plain
     `prng.generator_values`, normal within rtol 1e-6 / atol 1e-7; at
     (2016, 300, 501) and at an odd c * ell, both kinds, within 2e-4 *
     max|ref|, relaunches bit-identical; the least-squares gradient at
     (2016, 500) within the float64 bound, relaunches bit-identical and
     `torch.equal` to the flat kernel at w = None;
  4. the main path: `repro_torch.quickstart.run` — the §IV plan, the
     encode through the kernel, 600 uncoded and 600 coded epochs — with
     the launch counters set to 0 just before it and read just after;
  5. the same coded run on the reference gradient path (no kernel),
     whose NMSE trace must agree within rtol 1e-4;
  6. the StochasticCodedFL path: noise multiplier 0.5, parity sampling
     rho = 0.8, fixed_c = 2016, planned by the port's planner at
     srv_weight 0.64, encoded through the encode kernel, 600 epochs on
     the coded kernel (the counters set to 0 just before, read just
     after: 600 coded launches, 0 flat, 24 encode); the same run on the
     reference gradient path within rtol 1e-4, clocks identical;
  7. the HierarchicalCFL path over the §IV CodedFL state at T = 3: 600
     epochs on the tier-masked kernel (600 launches, 0 flat), the
     reference gradient path within rtol 1e-4; then T = 1, whose NMSE
     trace must be bit-equal to phase 4's coded trace;
  8. the fleet path at the §IV width: `fleet.encode_fleet_tiered` over
     the quickstart's data and Eq.-17 weights (24 x 300 x 500, c = 2016)
     at phase 7's T = 3 (the counters set to 0 just before, read just
     after: exactly 24 in-kernel-generator encode launches, no other
     kernel), held against the plain composite; one tier `torch.equal`
     to the flat `encode_fleet_prng`, T = 3 within rtol 1e-5 / atol
     1e-6 of it;
  9. the fleet path at fleet scale, as `benchmarks/perf_fleet.py` runs
     it: `solve_fleet` on `mega_fleet(100_000, d=32)` with shards of 4-16
     points, c_up 4096, eps_rel 1e-2 (loads within caps, the return
     target met); the tiered encode of 256 clients x 8 x 32 at c = 128,
     T = 4, against the flat one (256 launches each); `sample_tier_rounds`
     at n = 10 000 and 100 000 under a 512-client round budget, 16 tiers,
     48 epochs, its wall-time ratio at most 3.0;
 10. the legacy path: 600 epochs of `core.cfl.epoch_gradient(...,
     use_kernel=True)` -> `gd_update` -> `nmse` over phase 4's CodedFL
     state and its schedule's arrival masks (exactly 600 least-squares
     gradient launches, no other kernel), the same loop without the
     kernel within rtol 1e-4;
 11. time each kernel, its plain version and the one PyTorch call that
     computes the same product: CUDA events around a run of back-to-back
     calls that rotate over copies of the operands larger than the L2
     together (so each call finds its operands cold), enqueued while a
     sleep kernel holds the stream (so the host's enqueue cost stays
     outside the timed span), the median over repeats of the mean per
     call; and each kernel again on one copy, warm in L2, as the epoch
     loop finds its operands.  No PyTorch call generates threefry, so
     the in-kernel-generator encode's library time is `G @ (w X)` on a
     materialized G: it excludes the generation.

Any failed check raises, so the exit code is non-zero.  The line before
the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
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
# The StochasticCodedFL configuration driven in phase 6 (the strategy of
# benchmarks/fig_schemes.py's scfl_session on the quickstart's fleet) and
# its plan's loads at the planner's default eps_rel = 1e-3
# (t* = 17.01867 s; tests/test_torch_schemes.py).
SCFL_SIGMA, SCFL_RHO, SCFL_SRV_WEIGHT = 0.5, 0.8, 0.64
SEC4_SCFL_LOADS = [300, 300, 268, 300, 300, 300, 193, 300, 0, 300, 0, 300,
                   300, 300, 300, 300, 300, 300, 300, 0, 300, 300, 300, 300]
HIER_TIERS = 3
# the fleet layer: the fleet key of phases 3 and 8, and the scales of
# benchmarks/perf_fleet.py (phase 9)
FLEET_KEY_SEED = 1
FLEET_N, FLEET_D, POINTS_LO, POINTS_HI = 100_000, 32, 4, 16
FLEET_C_UP, FLEET_EPS_REL = 4096, 1e-2
ENC_CLIENTS, ENC_TIERS, ENC_ELL, ENC_C = 256, 4, 8, 128
SAMPLE_BUDGET, SAMPLE_TIERS, SAMPLE_EPOCHS, GROWTH_CEIL = 512, 16, 48, 3.0
# INT32 rate of the H100 SXM: 64 integer lanes per SM, 132 SMs, 1.98 GHz
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations of one threefry2x32 hash with its counter pairing
# (20 rounds of add, funnel shift and xor, five key injections)
HASH_INT_OPS = 80
PRNG_COLS_PER_CTA = 512  # csrc/encode.cu kBD: each CTA's output columns
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


def held_to_float64(name: str, got, plain, x, y, w, beta,
                    masks=None) -> float:
    """Hold the kernel's result `got` and the plain version's `plain`
    against the float64 expression within rtol 1e-3 + 1e-6 * S, S the
    magnitude of the summed terms, (|w| |mask| (|X||beta| + |y|)) @ |X|
    (masks=None: one flat gradient, else (T, M) tier masks).  Prints both
    and returns max |got - plain|."""
    x64, y64, b64 = x.double(), y.double(), beta.double()
    w64 = torch.ones_like(y64) if w is None else w.double()
    ms = torch.ones((1, x.shape[0]), dtype=torch.float64, device=x.device) \
        if masks is None else masks.double()
    exact = ((x64 @ b64 - y64) * w64 * ms) @ x64
    scale = ((w64.abs() * ms.abs()) * (x64.abs() @ b64.abs() + y64.abs())) \
        @ x64.abs()
    bound = 1e-3 * exact.abs() + 1e-6 * scale
    worst = {}
    for label, g in (("kernel", got), ("plain", plain)):
        worst[label] = float(((g.double().reshape(exact.shape) - exact).abs()
                              / bound).max())
    err = float((got - plain).abs().max())
    elementwise = torch.allclose(got, plain, rtol=1e-3, atol=1e-6)
    phase(f"check {name}: max_abs_err vs plain {err:.3e} (|ref| max "
          f"{float(exact.abs().max()):.3e}); worst element at "
          f"{worst['kernel']:.3f} (kernel) and {worst['plain']:.3f} "
          f"(plain) of the float64 bound; element-wise allclose to plain "
          f"(rtol 1e-3, atol 1e-6) {elementwise}")
    check(worst["kernel"] <= 1.0 and worst["plain"] <= 1.0,
          f"{name} outside its float64 bound")
    return err


def time_ms(fn, copies: list[tuple], calls: int = TIMING_CALLS) -> float:
    """Device time of one `fn(*operands)` call in ms.

    Call i (counted across runs) takes `copies[i % len(copies)]`: one
    copy stays warm in L2, copies larger than the L2 together leave each
    call's operands cold.
    Each timed run enqueues `calls` calls behind a sleep kernel and
    brackets them with CUDA events; if the sleep ended before the host
    finished enqueuing, the device may have waited on the host, so the run
    is repeated with a longer sleep.  Returns the median over
    `TIMING_REPEATS` runs of the run's time over its calls.  A function
    that enqueues hundreds of launches per call takes fewer calls per
    run, so that the hold covers the host's enqueue."""
    for i in range(2 * len(copies)):  # warm-up
        fn(*copies[i % len(copies)])
    cycles, samples, k = SLEEP_CYCLES, [], 0
    while len(samples) < TIMING_REPEATS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):  # the rotation goes on across runs
            fn(*copies[k % len(copies)])
            k += 1
        enqueue_s = time.perf_counter() - t0
        end.record()
        drained = start.query()  # the device reached the run already
        end.synchronize()
        if drained:
            cycles *= 2
            check(cycles <= 2**30, "the host cannot enqueue the timed run "
                  f"within a 0.5 s hold of the stream (last enqueue of "
                  f"{calls} calls took {enqueue_s:.3f} s)")
            continue
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def cold_copies(operands: tuple) -> list[tuple]:
    """Clones of `operands` (None stays None) whose bytes together exceed
    twice the L2, so rotating over them finds each call's operands cold."""
    size = sum(t.numel() * t.element_size() for t in operands
               if t is not None)
    n = -(-2 * L2_BYTES // size) + 1
    return [tuple(None if t is None else t.clone() for t in operands)
            for _ in range(n)]

def allclose_report(got, want, rtol: float, atol: float) -> tuple:
    """(max |got - want|, allclose(got, want, rtol, atol))."""
    return (float((got - want).abs().max()),
            bool(torch.allclose(got, want, rtol=rtol, atol=atol)))


def check_prng_kernel(dev, gen, errs: dict) -> tuple:
    """Phase 3's checks of the in-kernel-generator encode (kernel 3);
    returns (key, w, x) at (2016, 300, 501) for the timing phase."""
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng
    from repro_torch.kernels.encode import ref as enc_ref

    c, ell, d1 = 2016, 300, 501
    key = prng.split_keys(prng.prng_key(FLEET_KEY_SEED), 24)[0]
    ones, eye = torch.ones(ell, device=dev), torch.eye(ell, device=dev)
    for kind in prng.KINDS:  # X = I, w = 1: the kernel returns G
        got = enc_ops.encode_parity_prng(key, ones, eye, c, kind)
        want = prng.generator_values(key, c, ell, kind, device=dev)
        torch.cuda.synchronize()
        err, close = allclose_report(got, want, 1e-6, 1e-7)
        equal = torch.equal(got, want)
        share = float((got == want).float().mean())
        phase(f"check encode_prng G ({c}, {ell}) {kind} via X = I: "
              f"max_abs_err {err:.3e}, bit-equal share {share:.6f}, "
              f"torch.equal {equal}, within rtol 1e-6 / atol 1e-7 {close}")
        check(equal if kind == "bernoulli" else close,
              f"encode_prng {kind} generator differs from the plain one")
    w = torch.rand((ell,), generator=gen, device=dev)
    x = torch.randn((ell, d1), generator=gen, device=dev)
    odd = (torch.rand((299,), generator=gen, device=dev),
           torch.randn((299, 33), generator=gen, device=dev))
    for (cc, ww, xx) in ((c, w, x), (2017, *odd)):  # 2017 * 299 is odd
        for kind in prng.KINDS:
            got = enc_ops.encode_parity_prng(key, ww, xx, cc, kind)
            again = enc_ops.encode_parity_prng(key, ww, xx, cc, kind)
            want = enc_ref.encode_parity_prng(key, ww, xx, cc, kind)
            torch.cuda.synchronize()
            bound = 2e-4 * float(want.abs().max())
            err, ok = allclose_report(got, want, 2e-4, bound)
            phase(f"check encode_prng ({cc}, {xx.shape[0]}, {xx.shape[1]}) "
                  f"{kind}: max_abs_err {err:.3e} bound 2e-4*max|ref| = "
                  f"{bound:.3e}, allclose {ok}; bit-identical relaunch "
                  f"{torch.equal(got, again)}")
            check(ok, f"encode_prng {kind} disagrees with its plain version")
            check(torch.equal(got, again), "encode_prng not deterministic")
            if cc == c:
                errs[f"encode_prng_{kind}"] = err
    return key, w, x


def check_lsq_kernel(dev, gen, errs: dict) -> tuple:
    """Phase 3's checks of the least-squares gradient (kernel 6) at the
    §IV parity block; returns (a, y, beta) for the timing phase."""
    from repro_torch.kernels.coded_grad import ops as cg_ops
    from repro_torch.kernels.coded_grad import ref as cg_ref
    from repro_torch.kernels.round_grad import ops as rg_ops

    m, d = 2016, 500
    a = torch.randn((m, d), generator=gen, device=dev)
    y = torch.randn((m,), generator=gen, device=dev)
    beta = torch.randn((d,), generator=gen, device=dev)
    got = cg_ops.lsq_gradient(a, y, beta)
    again = cg_ops.lsq_gradient(a, y, beta)
    plain = cg_ref.lsq_gradient(a, y, beta)
    flat = rg_ops.masked_round_gradient(a, y, None, beta)
    torch.cuda.synchronize()
    errs["lsq_gradient"] = held_to_float64(f"lsq_gradient ({m}, {d})", got,
                                           plain, a, y, None, beta)
    phase(f"  bit-identical relaunch {torch.equal(got, again)}; "
          f"torch.equal to the flat kernel at w = None "
          f"{torch.equal(got, flat)}")
    check(torch.equal(got, again), "lsq_gradient not deterministic")
    check(torch.equal(got, flat), "lsq_gradient differs from the flat kernel")
    return a, y, beta


def plain_composite(key, xs, ys, weights, c: int) -> tuple:
    """The fleet composite [X~ | y~] (c, d+1) of the plain in-kernel-
    generator encode, client by client in order, and S, the element-wise
    sum over clients of |G_i diag(w_i) [X_i | y_i]|: the magnitude of the
    summed terms, which scales the rounding of any reassociated sum."""
    from repro_torch.kernels.encode import prng
    from repro_torch.kernels.encode import ref as enc_ref

    keys = prng.split_keys(key, xs.shape[0])
    xa = torch.cat([xs, ys[..., None]], dim=-1)
    acc = torch.zeros((c, xa.shape[2]), device=xs.device)
    scale = torch.zeros_like(acc)
    for i in range(xs.shape[0]):
        p = enc_ref.encode_parity_prng(keys[i], weights[i], xa[i], c)
        acc, scale = acc + p, scale + p.abs()
    return acc, scale


def check_tiered_against_flat(label: str, tiered, flat, scale) -> None:
    """A T-tier composite against the flat one: within rtol 1e-5 plus an
    atol of 1e-6 * S.  The two sum the same client parities in another
    order, so they differ by float32 rounding that scales with S, the
    magnitude of the summed terms (24 terms in order: at most about
    1.4e-6 * S); at the §IV width (|entries| ~ 1e3) an element-wise atol
    of 1e-6 alone fails at cancelled entries.  Prints both."""
    err, elementwise = allclose_report(tiered, flat, 1e-5, 1e-6)
    worst = float(((tiered - flat).abs()
                   / (1e-5 * flat.abs() + 1e-6 * scale)).max())
    phase(f"{label}: tiered vs flat max_abs_err {err:.3e}, worst element at "
          f"{worst:.3f} of rtol 1e-5 + 1e-6 * S; element-wise rtol 1e-5 / "
          f"atol 1e-6 {elementwise}")
    check(worst <= 1.0, f"{label}: tiered encode outside its bound")


def fleet_width_phase(out, reset_counters, read_counters) -> dict:
    """Phase 8: the tiered in-kernel-generator encode of the quickstart's
    data at T = 3, the flat encode and T = 1."""
    from repro_torch.fleet import FleetTopology, encode_fleet_tiered
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng

    data, state = out["data"], out["state"]
    xs, ys, weights, c = data.xs, data.ys, state.weights, state.c
    key = prng.prng_key(FLEET_KEY_SEED)
    reset_counters()
    t0 = time.perf_counter()
    x_t, y_t = encode_fleet_tiered(key, xs, ys, weights, c,
                                   FleetTopology.uniform(data.n, HIER_TIERS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counters()
    check(counts == {**dict.fromkeys(counts, 0), "encode_prng": data.n},
          f"unexpected fleet-path launch counts {counts}")
    x_f, y_f = enc_ops.encode_fleet_prng(key, xs, ys, weights, c)
    x_1, y_1 = encode_fleet_tiered(key, xs, ys, weights, c,
                                   FleetTopology.uniform(data.n, 1))
    acc, scale = plain_composite(key, xs, ys, weights, c)
    torch.cuda.synchronize()
    flat = torch.cat([x_f, y_f[:, None]], dim=1)
    bound = 2e-4 * float(acc.abs().max())
    err, ok = allclose_report(flat, acc, 2e-4, bound)
    one_equal = torch.equal(x_1, x_f) and torch.equal(y_1, y_f)
    phase(f"fleet path (§IV width, {data.n} x {data.ell} x {data.d}, c={c}, "
          f"T={HIER_TIERS}): {seconds:.4f} s wall; launches {counts}")
    phase(f"fleet path: flat encode vs plain composite max_abs_err {err:.3e} "
          f"bound 2e-4*max|ref| = {bound:.3e}, allclose {ok}; T=1 torch.equal "
          f"to the flat encode {one_equal}")
    check(tuple(x_t.shape) == (c, data.d) and tuple(y_t.shape) == (c,)
          and bool(torch.isfinite(x_t).all() & torch.isfinite(y_t).all()),
          "tiered parity not finite or of the wrong shape")
    check(ok, "the flat in-kernel-generator encode disagrees with plain")
    check(one_equal, "T = 1 tiered encode differs from the flat one")
    check_tiered_against_flat(f"fleet path T={HIER_TIERS}",
                              torch.cat([x_t, y_t[:, None]], dim=1), flat,
                              scale)
    return {"launches": counts["encode_prng"], "seconds": seconds,
            "err": err}


def fleet_scale_phase(dev, reset_counters, read_counters) -> dict:
    """Phase 9: `solve_fleet`, the tiered encode and round scheduling at
    the scales of benchmarks/perf_fleet.py."""
    from repro_torch.fleet import (FleetTopology, encode_fleet_tiered,
                                   sample_tier_rounds, solve_fleet)
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng
    from repro_torch.plan import PlanRequest
    from repro_torch.sim.network import mega_fleet

    fleet = mega_fleet(FLEET_N, d=FLEET_D, seed=0)
    sizes = np.random.default_rng(1).integers(POINTS_LO, POINTS_HI + 1,
                                              size=FLEET_N)
    req = PlanRequest(edge=fleet.edge, server=fleet.server,
                      data_sizes=sizes, c_up=FLEET_C_UP)
    reset_counters()
    t0 = time.perf_counter()
    plan = solve_fleet(req, eps_rel=FLEET_EPS_REL, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    check(set(read_counters().values()) == {0},
          "the fleet planner launched a hand-written kernel")
    phase(f"solve_fleet n={FLEET_N}: {plan_s:.4f} s wall; t*={plan.t_star!r} "
          f"c={plan.c} expected_agg={plan.expected_agg!r} (target {req.m}); "
          f"loads {np.bincount(plan.loads).tolist()} (count per load)")
    check(plan.loads.shape == (FLEET_N,) and bool(np.all(plan.loads >= 0))
          and bool(np.all(plan.loads <= sizes)), "plan exceeds device caps")
    check(plan.expected_agg >= req.m * (1.0 - 1e-6),
          "plan misses the return target")
    check(np.isfinite(plan.t_star) and 0 <= plan.c <= FLEET_C_UP,
          "fleet plan t* or c out of range")

    gen = torch.Generator(device=dev).manual_seed(3)
    xs = torch.randn((ENC_CLIENTS, ENC_ELL, FLEET_D), generator=gen,
                     device=dev)
    ys = torch.randn((ENC_CLIENTS, ENC_ELL), generator=gen, device=dev)
    w = torch.rand((ENC_CLIENTS, ENC_ELL), generator=gen, device=dev) + 0.5
    key = prng.prng_key(3)
    topo = FleetTopology.uniform(ENC_CLIENTS, ENC_TIERS)
    encodes = {}
    for label, fn in (("tiered", lambda: encode_fleet_tiered(
            key, xs, ys, w, ENC_C, topo)),
            ("flat", lambda: enc_ops.encode_fleet_prng(key, xs, ys, w,
                                                       ENC_C))):
        reset_counters()
        t0 = time.perf_counter()
        encodes[label] = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counters()
        phase(f"fleet-scale {label} encode ({ENC_CLIENTS} x {ENC_ELL} x "
              f"{FLEET_D}, c={ENC_C}): {secs:.4f} s wall; launches {counts}")
        check(counts == {**dict.fromkeys(counts, 0),
                         "encode_prng": ENC_CLIENTS},
              f"unexpected fleet-scale encode launch counts {counts}")
        encodes[label + "_s"] = secs
    acc, scale = plain_composite(key, xs, ys, w, ENC_C)
    flat = torch.cat([encodes["flat"][0], encodes["flat"][1][:, None]], 1)
    bound = 2e-4 * float(acc.abs().max())
    err, ok = allclose_report(flat, acc, 2e-4, bound)
    phase(f"fleet-scale flat encode vs plain composite max_abs_err "
          f"{err:.3e} bound 2e-4*max|ref| = {bound:.3e}, allclose {ok}")
    check(ok, "the fleet-scale flat encode disagrees with plain")
    check_tiered_against_flat(
        f"fleet-scale T={ENC_TIERS}",
        torch.cat([encodes["tiered"][0], encodes["tiered"][1][:, None]], 1),
        flat, scale)

    def schedule(n: int) -> float:
        fl = mega_fleet(n, d=FLEET_D, seed=0)
        rng = np.random.default_rng(2)
        loads = rng.integers(POINTS_LO, POINTS_HI + 1, size=n)
        tp = FleetTopology.uniform(n, SAMPLE_TIERS) \
            .with_round_budget(SAMPLE_BUDGET)
        best = np.inf
        for _ in range(2):  # best of two: the check is a ratio of walls
            t0 = time.perf_counter()
            stats = sample_tier_rounds(tp, fl.edge, loads, SAMPLE_EPOCHS,
                                       rng)
            best = min(best, time.perf_counter() - t0)
        check(stats.total_participants < 4 * SAMPLE_BUDGET * SAMPLE_EPOCHS,
              f"round budget not honoured: {stats.total_participants}")
        check(bool(np.all(np.isfinite(stats.durations))),
              "round durations not finite")
        return best

    small_s, large_s = schedule(FLEET_N // 10), schedule(FLEET_N)
    growth = large_s / max(small_s, 1e-9)
    phase(f"sample_tier_rounds (budget {SAMPLE_BUDGET}, {SAMPLE_TIERS} "
          f"tiers, {SAMPLE_EPOCHS} epochs): n={FLEET_N // 10} {small_s:.6f} "
          f"s, n={FLEET_N} {large_s:.6f} s, wall ratio {growth:.3f} "
          f"(ceiling {GROWTH_CEIL})")
    check(growth <= GROWTH_CEIL, f"round scheduling grew {growth:.2f}x")
    return {"plan_s": plan_s, "tiered_s": encodes["tiered_s"],
            "flat_s": encodes["flat_s"], "small_s": small_s,
            "large_s": large_s, "growth": growth}


def legacy_phase(out, dev, reset_counters, read_counters) -> dict:
    """Phase 10: the legacy per-epoch loop over phase 4's CodedFL state."""
    from repro_torch import quickstart
    from repro_torch.api import CodedFL
    from repro_torch.core import aggregation, cfl

    state, data, plan = out["state"], out["data"], out["plan"]
    sched = CodedFL(key=1, fixed_c=plan.c, include_upload_delay=False,
                    redundancy_plan=plan).sample_epochs(
        state, out["fleet"], 600, np.random.default_rng(0))
    received = torch.as_tensor(sched.arrivals["received"], device=dev)
    parity_ok = torch.as_tensor(sched.arrivals["parity_ok"], device=dev)
    lr = torch.tensor(quickstart.LR, dtype=torch.float32, device=dev)

    def run(use_kernel: bool) -> np.ndarray:
        beta = torch.zeros(data.d, device=dev)
        trace = torch.empty(601, device=dev)
        trace[0] = aggregation.nmse(beta, data.beta_true)
        for e in range(600):
            g = cfl.epoch_gradient(state, data.xs, data.ys, beta,
                                   received[e], parity_ok[e],
                                   use_kernel=use_kernel)
            beta = aggregation.gd_update(beta, g, lr, data.m)
            trace[e + 1] = aggregation.nmse(beta, data.beta_true)
        return trace.cpu().numpy()  # the run's one sync

    reset_counters()
    t0 = time.perf_counter()
    fused = run(True)
    seconds = time.perf_counter() - t0
    counts = read_counters()
    t0 = time.perf_counter()
    plain = run(False)
    plain_s = time.perf_counter() - t0
    check(read_counters() == counts, "the plain legacy loop launched a kernel")
    rel = float(np.max(np.abs(fused - plain) / np.abs(plain)))
    phase(f"legacy path: 600 epochs {seconds:.4f} s wall (plain "
          f"{plain_s:.4f} s); final NMSE {fused[-1]:.3e}; launches {counts}; "
          f"kernel vs plain max rel NMSE diff {rel:.3e} (bound 1e-4)")
    check(counts == {**dict.fromkeys(counts, 0), "lsq_gradient": 600},
          f"unexpected legacy launch counts {counts}")
    check(bool(np.all(np.isfinite(fused))) and fused.shape == (601,),
          "legacy NMSE trace not finite or wrong shape")
    check(fused[600] < fused[300] < fused[0], "legacy trace does not descend")
    check(np.allclose(fused, plain, rtol=1e-4, atol=0.0),
          "legacy kernel and plain traces disagree")
    return {"launches": counts["lsq_gradient"], "seconds": seconds}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch import quickstart
    from repro_torch.api import CodedFL, Session, coding_gain
    from repro_torch.core.redundancy import _fleet_with_server
    from repro_torch.core.returns import optimal_loads
    from repro_torch.device import resolve_device
    from repro_torch.fleet import FleetTopology, HierarchicalCFL, HierState
    from repro_torch.kernels import build
    from repro_torch.kernels.coded_grad import ops as cg_ops
    from repro_torch.kernels.coded_grad import ref as cg_ref
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng
    from repro_torch.kernels.encode import ref as enc_ref
    from repro_torch.kernels.round_grad import ops as rg_ops
    from repro_torch.kernels.round_grad import ref as rg_ref
    from repro_torch.schemes import StochasticCodedFL

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
        entry = "?"
        for line in info["log"].splitlines():
            fn = re.search(r"entry function '.*?\d+([a-z_]+_kernel)"
                           r"(?:ILi(\d+)E)?", line)
            if fn:  # the kernel (and tier-count instance) reported next
                entry = fn[1] + (f"<{fn[2]}>" if fn[2] else "")
            elif "registers" in line or "spill" in line:
                phase(f"  ptxas {name} {entry}: {line.strip()}")

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

    # the coded kernel: 7200 systematic + 2016 parity rows (the SCFL main
    # path's dense layout), per-row and scalar parity weights, the parity
    # stream alone (systematic weights 0), and c = 0.  The per-row parity
    # weights are the Bernoulli mask over rho, of order 1 like the
    # systematic ones, so a dropped or misplaced parity row shows.
    m, c_par, d = 7200, 2016, 500
    x = torch.randn((m, d), generator=gen, device=dev)
    y = torch.randn((m,), generator=gen, device=dev)
    w = (torch.rand((m,), generator=gen, device=dev) < 0.85).float()
    xp = torch.randn((c_par, d), generator=gen, device=dev)
    yp = torch.randn((c_par,), generator=gen, device=dev)
    wp = (torch.rand((c_par,), generator=gen, device=dev) < SCFL_RHO) \
        .float() / SCFL_RHO
    beta = torch.randn((d,), generator=gen, device=dev)
    coded_inputs = (x, y, w, xp, yp, wp, beta)
    for label, w_sys, w_par in (
            ("rows", w, wp),
            ("scalar", w, torch.tensor(0.37, device=dev)),
            ("rows, parity alone", torch.zeros_like(w), wp)):
        before = (rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches)
        got = rg_ops.coded_round_gradient(x, y, w_sys, xp, yp, w_par, beta)
        again = rg_ops.coded_round_gradient(x, y, w_sys, xp, yp, w_par,
                                            beta)
        plain = rg_ref.coded_round_gradient(x, y, w_sys, xp, yp, w_par,
                                            beta)
        torch.cuda.synchronize()
        check((rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches)
              == (before[0], before[1] + 2), "coded kernel launch count")
        err = held_to_float64(
            f"coded_round_grad ({m} + {c_par}, {d}) w_par={label}", got,
            plain, torch.cat([x, xp]), torch.cat([y, yp]),
            torch.cat([w_sys, torch.broadcast_to(w_par, (c_par,))]), beta)
        phase(f"  bit-identical relaunch {torch.equal(got, again)}")
        check(torch.equal(got, again), "coded kernel not deterministic")
        errs.setdefault("coded_round_grad", err)
    empty = torch.zeros((0, d), device=dev)
    before = (rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches)
    got = rg_ops.coded_round_gradient(x, y, w, empty, empty[:, 0], 1.0,
                                      beta)
    flat = rg_ops.masked_round_gradient(x, y, w, beta)
    torch.cuda.synchronize()
    check((rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches)
          == (before[0] + 2, before[1]), "c = 0 must run the flat kernel")
    check(torch.equal(got, flat), "c = 0 differs from the flat kernel")
    phase("check coded_round_grad c = 0: ran the flat kernel, equal to it")

    # the tier kernel at the packed §IV layout, T = 3 and T = 8, and T = 1
    m = 5632
    x, y, w = x[:m].contiguous(), y[:m].contiguous(), w[:m].contiguous()
    tier_inputs = {}
    for nt in (HIER_TIERS, 8):
        tier_of = torch.randint(0, nt, (m,), generator=gen, device=dev)
        masks = (torch.arange(nt, device=dev)[:, None]
                 == tier_of[None, :]).float()
        tier_inputs[nt] = (x, y, w, masks, beta)
        before = rg_ops.TIER_COUNTER.launches
        got = rg_ops.tier_masked_round_gradient(x, y, w, masks, beta)
        again = rg_ops.tier_masked_round_gradient(x, y, w, masks, beta)
        plain = rg_ref.tier_masked_round_gradient(x, y, w, masks, beta)
        torch.cuda.synchronize()
        check(rg_ops.TIER_COUNTER.launches == before + 2,
              "tier kernel launch count")
        err = held_to_float64(f"tier_round_grad ({m}, {d}) T={nt}", got,
                              plain, x, y, w, beta, masks=masks)
        phase(f"  bit-identical relaunch {torch.equal(got, again)}")
        check(torch.equal(got, again), "tier kernel not deterministic")
        if nt == HIER_TIERS:
            errs["tier_round_grad"] = err
    for label, wt in (("w", w), ("w=None", None)):
        one = rg_ops.tier_masked_round_gradient(
            x, y, wt, torch.ones((1, m), device=dev), beta)
        flat = rg_ops.masked_round_gradient(x, y, wt, beta)
        torch.cuda.synchronize()
        phase(f"check tier_round_grad T=1 ({label}) torch.equal to the "
              f"flat kernel: {torch.equal(one[0], flat)}")
        check(torch.equal(one[0], flat), "T = 1 tier kernel != flat kernel")
    # the in-kernel-generator encode and the least-squares gradient
    prng_inputs = check_prng_kernel(dev, gen, errs)
    lsq_inputs = check_lsq_kernel(dev, gen, errs)

    counters = {"round_grad": rg_ops.COUNTER,
                "coded_round_grad": rg_ops.CODED_COUNTER,
                "tier_round_grad": rg_ops.TIER_COUNTER,
                "encode": enc_ops.COUNTER,
                "encode_prng": enc_ops.PRNG_COUNTER,
                "lsq_gradient": cg_ops.COUNTER}

    def reset_counters():
        for counter in counters.values():
            counter.reset()

    def read_counters() -> dict:
        return {k: counter.launches for k, counter in counters.items()}

    def expect(**launched) -> dict:
        return {**dict.fromkeys(counters, 0), **launched}

    # -- 4. the main path ------------------------------------------------
    reset_counters()
    t0 = time.perf_counter()
    out = quickstart.run(epochs=600, device=dev)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = read_counters()
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
    check(launches == expect(round_grad=1200, encode=24),
          f"unexpected launch counts {launches}")

    # -- 5. the same coded run on the reference gradient path ------------
    strategy = CodedFL(key=1, fixed_c=plan.c, include_upload_delay=False,
                       redundancy_plan=plan, grad_path="reference")
    before = read_counters()
    res_r = Session(strategy, fleet, quickstart.LR, 600, device=dev).run(
        out["data"], rng=np.random.default_rng(0), state=out["state"])
    check(read_counters() == before, "the reference path launched a kernel")
    rel = float(np.max(np.abs(res_r.nmse - res_c.nmse) / np.abs(res_r.nmse)))
    phase(f"fused vs reference coded trace: max rel NMSE diff {rel:.3e} "
          f"(bound 1e-4); times identical "
          f"{bool(np.array_equal(res_r.times, res_c.times))}")
    check(np.allclose(res_c.nmse, res_r.nmse, rtol=1e-4, atol=0.0),
          "fused and reference coded traces disagree")
    check(np.array_equal(res_r.times, res_c.times), "clocks differ")

    def check_against_reference(label, fused, ref):
        rel = float(np.max(np.abs(ref.nmse - fused.nmse) / np.abs(ref.nmse)))
        same_clock = bool(np.array_equal(ref.times, fused.times))
        phase(f"{label}: fused vs reference max rel NMSE diff {rel:.3e} "
              f"(bound 1e-4); times identical {same_clock}")
        check(np.allclose(fused.nmse, ref.nmse, rtol=1e-4, atol=0.0),
              f"{label}: fused and reference traces disagree")
        check(same_clock, f"{label}: clocks differ")

    def check_trace(rep):
        check(rep.nmse.shape == (601,)
              and bool(np.all(np.isfinite(rep.nmse))),
              f"{rep.label}: NMSE trace not finite or wrong shape")
        check(rep.nmse[600] < rep.nmse[300] < rep.nmse[0],
              f"{rep.label}: NMSE trace does not descend")

    # -- 6. the StochasticCodedFL path -----------------------------------
    data = out["data"]
    scfl = StochasticCodedFL(key=1, fixed_c=quickstart.FIXED_C,
                             noise_multiplier=SCFL_SIGMA,
                             sample_frac=SCFL_RHO,
                             include_upload_delay=False)
    reset_counters()
    t0 = time.perf_counter()
    scfl_sess = Session(scfl, fleet, quickstart.LR, 600, device=dev)
    scfl_state = scfl_sess.plan(data)
    torch.cuda.synchronize()
    scfl_plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_s = scfl_sess.run(data, rng=np.random.default_rng(0),
                          state=scfl_state)
    torch.cuda.synchronize()
    scfl_run_s = time.perf_counter() - t0
    scfl_launches = read_counters()
    splan = scfl_state.plan
    phase(f"scfl: plan+encode {scfl_plan_s:.4f} s, 600 epochs "
          f"{scfl_run_s:.4f} s wall; plan c={splan.c} t*={splan.t_star!r} "
          f"srv_weight={scfl_state.srv_weight!r} "
          f"loads={splan.loads.tolist()}")
    phase(f"scfl: final NMSE {res_s.final_nmse():.3e} at "
          f"{res_s.times[-1]:.1f} s simulated; NMSE rises in "
          f"{int(np.sum(np.diff(res_s.nmse) > 0))} of 600 epochs")
    phase(f"scfl launches: {scfl_launches}")
    check(splan.c == 2016, "scfl plan c != 2016")
    check(scfl_state.srv_weight == SCFL_SRV_WEIGHT, "scfl srv_weight")
    host_loads, _ = optimal_loads(
        _fleet_with_server(fleet.edge, fleet.server),
        np.concatenate([np.full(24, 300), [2016]]), splan.t_star)
    check(host_loads[:-1].tolist() == splan.loads.tolist(),
          "scfl loads differ from the float64 host argmax at t*")
    check(splan.loads.tolist() == SEC4_SCFL_LOADS, "scfl plan loads differ")
    check("sys_x" not in scfl.device_state(scfl_state, data),
          "the §IV SCFL plan should take the dense fused layout")
    check_trace(res_s)
    check(scfl_launches == expect(coded_round_grad=600, encode=24),
          f"unexpected scfl launch counts {scfl_launches}")
    before = read_counters()
    res_sr = Session(dataclasses.replace(scfl, grad_path="reference"),
                     fleet, quickstart.LR, 600, device=dev).run(
        data, rng=np.random.default_rng(0), state=scfl_state)
    check(read_counters() == before, "the reference path launched a kernel")
    check_against_reference("scfl", res_s, res_sr)

    # -- 7. the HierarchicalCFL path -------------------------------------
    # phase 4's coded strategy (fused), over its plan and encoded state
    coded = CodedFL(key=1, fixed_c=plan.c, include_upload_delay=False,
                    use_kernel=True, redundancy_plan=plan)
    reports = {}
    for nt in (HIER_TIERS, 1):
        topo = FleetTopology.uniform(24, nt)
        hier = HierarchicalCFL(coded, topo)
        reset_counters()
        t0 = time.perf_counter()
        reports[nt] = Session(hier, fleet, quickstart.LR, 600,
                              device=dev).run(
            data, rng=np.random.default_rng(0),
            state=HierState(out["state"], topo))
        torch.cuda.synchronize()
        hier_s = time.perf_counter() - t0
        counts = read_counters()
        phase(f"hierarchical T={nt}: 600 epochs {hier_s:.4f} s wall; final "
              f"NMSE {reports[nt].final_nmse():.3e}; launches {counts}")
        check_trace(reports[nt])
        check(counts == expect(tier_round_grad=600),
              f"unexpected hierarchical launch counts {counts}")
        if nt == HIER_TIERS:
            hier_launches, hier_run_s = counts, hier_s
            before = read_counters()
            res_hr = Session(
                HierarchicalCFL(dataclasses.replace(
                    coded, use_kernel=False, grad_path="reference"),
                    topo), fleet, quickstart.LR, 600, device=dev).run(
                data, rng=np.random.default_rng(0),
                state=HierState(out["state"], topo))
            check(read_counters() == before,
                  "the reference path launched a kernel")
            check_against_reference(f"hierarchical T={nt}", reports[nt],
                                    res_hr)
    single_equal = bool(np.array_equal(reports[1].nmse, res_c.nmse))
    phase(f"hierarchical T=1 NMSE trace bit-equal to the flat coded trace "
          f"of phase 4: {single_equal}")
    check(single_equal, "T = 1 hierarchical trace differs from the flat one")
    check(np.array_equal(reports[1].times, res_c.times), "T = 1 clocks")

    # -- 8. the fleet path at the §IV width ------------------------------
    fleet_width = fleet_width_phase(out, reset_counters, read_counters)

    # -- 9. the fleet path at fleet scale --------------------------------
    fleet_scale = fleet_scale_phase(dev, reset_counters, read_counters)

    # -- 10. the legacy path ----------------------------------------------
    legacy = legacy_phase(out, dev, reset_counters, read_counters)

    # -- 11. timing ------------------------------------------------------
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
    enc_shape = [c, ell, d1]
    phase(f"time encode ({c}, {ell}, {d1}): kernel {enc_ms!r} ms (L2 "
          f"warm {enc_warm!r} ms), plain {enc_plain!r} ms, library "
          f"G @ (w X) {enc_lib!r} ms, bound {enc_bound!r} ms "
          f"(flops {enc_flops})")

    # the coded kernel at the SCFL path's shapes: 7200 + 2016 rows of 500
    x, y, w, xp, yp, wp, beta = coded_inputs
    m, c_par, d = x.shape[0], xp.shape[0], x.shape[1]
    cold = cold_copies(coded_inputs)
    coded_ms = time_ms(rg_ops.coded_round_gradient, cold)
    coded_warm = time_ms(rg_ops.coded_round_gradient, [coded_inputs])
    coded_plain = time_ms(rg_ref.coded_round_gradient, cold)
    del cold
    coef_s = ((x @ beta - y) * w).contiguous()
    coef_p = ((xp @ beta - yp) * wp).contiguous()
    coded_lib = time_ms(lambda cs, xs_, cp, xp_: cs @ xs_ + cp @ xp_,
                        cold_copies((coef_s, x, coef_p, xp)))
    coded_bytes = 4 * ((m + c_par) * d + 2 * (m + c_par) + 2 * d)
    coded_flops = 4 * (m + c_par) * d + 3 * (m + c_par)
    coded_bound = 1e3 * max(coded_bytes / HBM_BYTES_PER_S,
                            coded_flops / FP32_FLOPS_PER_S)
    phase(f"time coded_round_grad ({m} + {c_par}, {d}): kernel "
          f"{coded_ms!r} ms (L2 warm {coded_warm!r} ms), plain "
          f"{coded_plain!r} ms, library coef_s @ X + coef_p @ X_par "
          f"{coded_lib!r} ms, bound {coded_bound!r} ms "
          f"(bytes {coded_bytes})")

    # the tier kernel at the hierarchical path's shapes: (5632, 500), T = 3
    x, y, w, masks, beta = tier_inputs[HIER_TIERS]
    m, d, nt = x.shape[0], x.shape[1], masks.shape[0]
    cold = cold_copies(tier_inputs[HIER_TIERS])
    tier_ms = time_ms(rg_ops.tier_masked_round_gradient, cold)
    tier_warm = time_ms(rg_ops.tier_masked_round_gradient,
                        [tier_inputs[HIER_TIERS]])
    tier_plain = time_ms(rg_ref.tier_masked_round_gradient, cold)
    del cold
    coef_masks = (((x @ beta - y) * w)[None, :] * masks).contiguous()
    tier_lib = time_ms(torch.matmul, cold_copies((coef_masks, x)))
    tier_bytes = 4 * (m * d + 2 * m + nt * m + d + nt * d)
    tier_flops = 2 * m * d + 2 * nt * m * d + 2 * m + nt * m
    tier_bound = 1e3 * max(tier_bytes / HBM_BYTES_PER_S,
                           tier_flops / FP32_FLOPS_PER_S)
    tier_shape = [m, d, nt]
    phase(f"time tier_round_grad ({m}, {d}) T={nt}: kernel {tier_ms!r} ms "
          f"(L2 warm {tier_warm!r} ms), plain {tier_plain!r} ms, library "
          f"(coef * masks) @ X {tier_lib!r} ms, bound {tier_bound!r} ms "
          f"(bytes {tier_bytes})")

    # the in-kernel-generator encode at (2016, 300, 501), both kinds
    key, w_p, x_p = prng_inputs
    c, (ell, d1) = 2016, x_p.shape
    prng_shape = [c, ell, d1]
    prng_rec = {}
    for kind in ("normal", "bernoulli"):
        def prng_kernel(w_, x_, kind=kind):
            return enc_ops.encode_parity_prng(key, w_, x_, c, kind)

        def prng_plain(w_, x_, kind=kind):
            return enc_ref.encode_parity_prng(key, w_, x_, c, kind)

        cold = cold_copies((w_p, x_p))
        p_ms = time_ms(prng_kernel, cold)
        p_warm = time_ms(prng_kernel, [(w_p, x_p)])
        # the plain generator is ~220 launches a call: 4 calls a run
        p_plain = time_ms(prng_plain, cold, calls=4)
        del cold
        g_mat = prng.generator_values(key, c, ell, kind, device=dev)
        p_lib = time_ms(lambda g_, w_, x_: g_ @ (w_[:, None] * x_),
                        cold_copies((g_mat, w_p, x_p)))
        del g_mat
        p_flops = 2 * c * ell * d1 + ell * d1
        p_hash_ops = HASH_INT_OPS * c * ell * -(-d1 // PRNG_COLS_PER_CTA)
        p_bytes = 4 * (ell + ell * d1 + c * d1)
        terms = {"bytes": p_bytes / HBM_BYTES_PER_S,
                 "operations": max(p_flops / FP32_FLOPS_PER_S,
                                   p_hash_ops / INT32_OPS_PER_S)}
        bound_by = max(terms, key=terms.get)
        prng_rec[kind] = {"ms": p_ms, "warm": p_warm, "plain": p_plain,
                          "lib": p_lib, "bound": 1e3 * terms[bound_by],
                          "bound_by": bound_by}
        phase(f"time encode_prng {kind} ({c}, {ell}, {d1}): kernel "
              f"{p_ms!r} ms (L2 warm {p_warm!r} ms), plain {p_plain!r} ms, "
              f"library G @ (w X) on a materialized G (no generation) "
              f"{p_lib!r} ms, bound {1e3 * terms[bound_by]!r} ms "
              f"({bound_by}: flops {p_flops}, hash integer ops "
              f"{p_hash_ops}, bytes {p_bytes})")

    # the least-squares gradient at the §IV parity block (2016, 500)
    a, y, beta = lsq_inputs
    lsq_m, lsq_d = a.shape
    cold = cold_copies(lsq_inputs)
    lsq_ms = time_ms(cg_ops.lsq_gradient, cold)
    lsq_warm = time_ms(cg_ops.lsq_gradient, [lsq_inputs])
    lsq_plain = time_ms(cg_ref.lsq_gradient, cold)
    lsq_lib = time_ms(lambda a_, y_, b_: (a_ @ b_ - y_) @ a_, cold)
    del cold
    lsq_bytes = 4 * (lsq_m * lsq_d + lsq_m + 2 * lsq_d)
    lsq_flops = 4 * lsq_m * lsq_d + lsq_m
    lsq_bound = 1e3 * max(lsq_bytes / HBM_BYTES_PER_S,
                          lsq_flops / FP32_FLOPS_PER_S)
    phase(f"time lsq_gradient ({lsq_m}, {lsq_d}): kernel {lsq_ms!r} ms "
          f"(L2 warm {lsq_warm!r} ms), plain {lsq_plain!r} ms, library "
          f"(A @ beta - y) @ A {lsq_lib!r} ms, bound {lsq_bound!r} ms "
          f"(bytes {lsq_bytes})")
    phase(f"new paths' host seconds: scfl plan+encode {scfl_plan_s:.4f}, "
          f"scfl 600 epochs {scfl_run_s:.4f}, hierarchical T={HIER_TIERS} "
          f"600 epochs {hier_run_s:.4f}")
    phase(f"fleet paths' host seconds: tiered encode at §IV width "
          f"{fleet_width['seconds']:.4f}, solve_fleet n={FLEET_N} "
          f"{fleet_scale['plan_s']:.4f}, fleet-scale tiered encode "
          f"{fleet_scale['tiered_s']:.4f} (flat {fleet_scale['flat_s']:.4f}), "
          f"round scheduling n={FLEET_N // 10} {fleet_scale['small_s']:.6f} / "
          f"n={FLEET_N} {fleet_scale['large_s']:.6f} (ratio "
          f"{fleet_scale['growth']:.3f}), legacy 600 epochs "
          f"{legacy['seconds']:.4f}")

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
         "ms_l2_warm": enc_warm, "shape": enc_shape},
        {"name": "coded_round_gradient", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/round_grad.cu",
         "replaces": "src/repro/kernels/round_grad/round_grad.py:134",
         "launches": scfl_launches["coded_round_grad"],
         "max_abs_err": errs["coded_round_grad"], "ms": coded_ms,
         "plain_ms": coded_plain, "bound_ms": coded_bound,
         "bound_by": "bytes", "library_ms": coded_lib,
         "ms_l2_warm": coded_warm,
         "shape": [coded_inputs[0].shape[0], coded_inputs[3].shape[0],
                   coded_inputs[0].shape[1]]},
        {"name": "tier_masked_round_gradient", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/round_grad.cu",
         "replaces": "src/repro/kernels/round_grad/round_grad.py:190",
         "launches": hier_launches["tier_round_grad"],
         "max_abs_err": errs["tier_round_grad"], "ms": tier_ms,
         "plain_ms": tier_plain, "bound_ms": tier_bound,
         "bound_by": "bytes", "library_ms": tier_lib,
         "ms_l2_warm": tier_warm, "shape": tier_shape},
        {"name": "encode_parity_prng", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/encode.cu",
         "replaces": "src/repro/kernels/encode/encode.py:210",
         "launches": fleet_width["launches"],
         "max_abs_err": max(errs["encode_prng_normal"],
                            errs["encode_prng_bernoulli"]),
         "ms": prng_rec["normal"]["ms"],
         "plain_ms": prng_rec["normal"]["plain"],
         "bound_ms": prng_rec["normal"]["bound"],
         "bound_by": prng_rec["normal"]["bound_by"],
         "library_ms": prng_rec["normal"]["lib"],
         "ms_l2_warm": prng_rec["normal"]["warm"],
         "bernoulli": {k: prng_rec["bernoulli"][k] for k in
                       ("ms", "warm", "plain", "lib", "bound")},
         "shape": prng_shape},
        {"name": "lsq_gradient", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/round_grad.cu",
         "replaces": "src/repro/kernels/coded_grad/coded_grad.py:53",
         "launches": legacy["launches"],
         "max_abs_err": errs["lsq_gradient"], "ms": lsq_ms,
         "plain_ms": lsq_plain, "bound_ms": lsq_bound, "bound_by": "bytes",
         "library_ms": lsq_lib, "ms_l2_warm": lsq_warm,
         "shape": [lsq_m, lsq_d]},
    ]
    phase(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
