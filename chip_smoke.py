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
     `torch.equal` to the flat kernel;
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
  8. time each kernel, its plain version and the one PyTorch call that
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
    from repro_torch.fleet import FleetTopology, HierarchicalCFL, HierState
    from repro_torch.kernels import build
    from repro_torch.kernels.encode import ops as enc_ops
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

    def reset_counters():
        for counter in (rg_ops.COUNTER, rg_ops.CODED_COUNTER,
                        rg_ops.TIER_COUNTER, enc_ops.COUNTER):
            counter.reset()

    def read_counters() -> dict:
        return {"round_grad": rg_ops.COUNTER.launches,
                "coded_round_grad": rg_ops.CODED_COUNTER.launches,
                "tier_round_grad": rg_ops.TIER_COUNTER.launches,
                "encode": enc_ops.COUNTER.launches}

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
    check(scfl_launches == {"round_grad": 0, "coded_round_grad": 600,
                            "tier_round_grad": 0, "encode": 24},
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
        check(counts == {"round_grad": 0, "coded_round_grad": 0,
                         "tier_round_grad": 600, "encode": 0},
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

    # -- 8. timing -------------------------------------------------------
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
    phase(f"new paths' host seconds: scfl plan+encode {scfl_plan_s:.4f}, "
          f"scfl 600 epochs {scfl_run_s:.4f}, hierarchical T={HIER_TIERS} "
          f"600 epochs {hier_run_s:.4f}")

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
    ]
    phase(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
