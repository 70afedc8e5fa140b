"""The port's CUDA kernels and its training path on the card.

Every test here needs a CUDA device: it carries the `cuda` marker and
skips (from a fixture, at run time) where there is none.  On a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bounds:
  * round gradient: the kernel and the plain float32 expression are both
    held against the float64 expression, within rtol 1e-3 plus an atol of
    1e-6 times the magnitude of the summed terms,
    S = (|w| * (|X| |beta| + |y|)) @ |X|.  Float32 sums taken in another
    order differ by rounding that scales with S, not with the result: a
    component that cancels to nearly zero (seen on the card at (9, 3000)
    and (7200, 500)) misses an element-wise rtol 1e-3 / atol 1e-6 against
    the plain version although both lie as close to the float64 value.
    Launches must also be bit-identical: the cross-CTA reduction inside
    the launch has a fixed order, and its ticket counter is back at 0
    after each launch (three calls in a row, and calls on two streams at
    once, each equal to its single-stream result).  D = 3000 takes a
    two-stage ring, D % 4 != 0 and misaligned views the 4-byte cp.async
    instance; the widest D of the row-resident instances runs at four
    tiers, and D past it (3600, 3601, 4096, 4099, 5000, 8192 and one
    column past the limit) takes one launch over thread-block clusters
    along D (the coded kernel past D = 4096 the residual pass and the
    column-chunked launch), whose route the library's `rg_route` and the
    wrapper's `route` must state alike.
    The coded and tier-masked kernels are held the same way, each tier
    partial and the coded sum against their float64 expressions with S
    summed over the rows that enter them.  The tier kernel at T = 1 with
    an all-ones mask must be bit-equal (`torch.equal`) to the flat
    kernel on the same operands.
  * encode: 2e-4 * max|ref|, as in `tests/test_torch_kernels.py`, and,
    kernel and plain version alike, the float64 bound of
    `kernels.encode.ops.float64_reference_and_bound` (1.01 (L + 20) u
    |G| |diag(w) X|, stated before the 3xTF32 kernel first ran);
    relaunches bit-identical; C, L and D ragged against the 128 x 64
    tile, the step of 32 and the m16n8k8 shape; the 16-byte and 4-byte
    copy instances (L or D % 4, misaligned views).
  * in-kernel-generator encode: the generator itself, exposed with
    X = I and w = 1, Rademacher entries `torch.equal` to the plain
    `prng.generator_values` on the card, normal entries within rtol 1e-6
    / atol 1e-7 (both evaluate Giles' float32 erfinv operation by
    operation; `log1pf` may differ from torch's `log1p` by an ulp, and
    the 3xTF32 products return big + small of each entry, within 2^-22
    |g|); the product within 2e-4 * max|ref| and, kernel and plain
    version alike, within the float64 bound of the encode (G the plain
    generator), at the §IV width, ragged C, L and D against the 16 x 512
    CTA, the step of 32 and the m16n8k8 shape, D > 512, an odd C * L and
    the fleet-scale 128 x 8 x 33; relaunches bit-identical; the fleet
    encoders' one-tier tiered run `torch.equal` to the flat one.
  * least-squares gradient: the float64 bound of the round gradient, and
    `torch.equal` to the flat kernel at w = None and the same row tile
    (the same instance).
  * tiles: every candidate tile of every tune family (kernels 1, 4 and 5
    at each "round_grad" row tile, 6 at each "coded_grad" one, 2 at
    each CTA tile, 3 at its one tile) within its kernel's bounds above,
    at the §IV shapes and ragged ones; a cold miss of `block="auto"`
    `torch.equal` to the explicit default tile; a cache hit launching
    the stored tile; the library's partition and tile list equal to the
    Python mirrors the tuner and the roofline read; the keyed
    `encode_fleet` within 2e-4 * max|ref| of the plain streamed encode;
    `python -m repro_torch.tune` writing a `cuda-sm90` entry.
  * SSD intra-chunk step (kernel 7): against its plain version within
    rtol 1e-4 and atol 1e-4 * max(1, max|ref|) (`tests/test_kernels.py`),
    at the synthetic decays (da = -0.1 |N(0, 1)|) and at the model's own
    (dt = softplus(N(0, 1)), a = -linspace(1, 16, H)), where both take
    the prefix sums of da in float64; at the model's own decays both are
    also held against the float64 value within the rounding bound of
    `kernels.ssd.ref.float64_reference_and_bound`.  Relaunches
    bit-identical (three calls in a row, and calls on two streams at
    once, each equal to its single-stream result).  The shapes cover the
    3xTF32 kernel's edges: heads per group 3, 5 and 12 against its block
    of 8 heads, Q = 200 and 97 against its 64-row tiles, P = 80, 130 and
    N = 96, 136 against its 64- and 128-wide tiles, P and N not multiples
    of 4 (the 4-byte cp.async instance), and the serving shape with one
    group and with per-head B and C.  A chunk one row past the kernel's
    256 is refused before a launch.  A reduced mamba2 prefill on the card within
    rtol 1e-4 / atol 1e-4 * max|ref| of the CPU one, one launch per layer.
  * causal attention (kernel 8): kernel and plain version both within the
    float64 rounding bound of `kernels.flash_attn.ref.float64_reference_
    and_bound`, within rtol 2e-4 / atol 2e-4 of each other, relaunches
    bit-identical; the short-sequence instances (S <= 64) at S = 1 to 64
    and 1 to 12 query heads a key/value head, and at the coded-head
    probe's (768, 32, 8, 32, 128) in the model's layout, also `torch.equal`
    to the D = 128 / D = 64 instance on the same rows and to the run-time-D
    instance of a misaligned view.
  * the hybrid and moe families: the reduced zamba2-1.2b at 5 layers
    (two uses of the shared block) and the reduced phi3.5-moe and
    llama4-maverick, prefilled on the card through kernels 7 and 8
    within rtol 1e-4 / atol 1e-4 * max(1, max|ref|) of the CPU prefill,
    logits and caches, with one kernel-7 launch per Mamba2 layer and one
    kernel-8 launch per attention block run.
  * the strategies built through `make_strategy` (GradientCodingFL,
    StochasticCodedFL from an (epsilon, delta) budget, LowLatencyCFL with
    its partial-return plan solved on the card), flat and at T = 3:
    exact launch counts, the reference path launching nothing, identical
    clocks and NMSE within rtol 1e-4 (the fused path against the
    reference path, and gradient coding against the CPU run).
  * the sweep and serving engines on the card: `run_sweep` lanes and
    `plan_sweep` plans bit-equal to solo runs and solo plans, served
    lanes bit-equal as a prefix of their solo runs, and exactly one
    round-gradient launch per epoch swept or served.
  * training: one float32 `make_train_step` and one `make_fed_train_step`
    step of the reduced granite-8b and mamba2-1.3b on the card against
    the CPU from the same parameters and batch, the loss within rtol
    1e-5 and every gradient leaf within rtol 1e-4 / atol 1e-6 *
    max(1, max|CPU leaf|), no kernel launched; each of the eight kernel
    wrappers refuses CUDA operands that require grad (no backward).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.cfl import CFLState
from repro_torch.fleet import FleetTopology, HierarchicalCFL, HierState
from repro_torch.device import resolve_device
from repro_torch.fleet import encode_fleet_tiered
from repro_torch.kernels.coded_grad import ops as cg_ops
from repro_torch.kernels.common import resolve_block
from repro_torch.kernels.coded_grad import ref as cg_ref
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import prng
from repro_torch.kernels.encode import ref as enc_ref
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn import ref as fa_ref
from repro_torch.kernels.round_grad import ops as rg_ops
from repro_torch.kernels.round_grad import ref as rg_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.schemes import StochasticCodedFL, StochasticState
from repro_torch.sim.network import make_fleet

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


@pytest.mark.parametrize("m,d", [(1, 1), (7, 5), (37, 13), (5632, 500),
                                 (7200, 500), (9, 3000), (700, 3000),
                                 (700, 2999)])
@pytest.mark.parametrize("weights", ["random", "zero_rows", "none"])
def test_round_grad_kernel_matches_plain(cuda, m, d, weights):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    x = torch.randn((m, d), generator=gen, device=cuda)
    y = torch.randn((m,), generator=gen, device=cuda)
    beta = torch.randn((d,), generator=gen, device=cuda)
    w = None
    if weights != "none":
        w = torch.rand((m,), generator=gen, device=cuda)
        if weights == "zero_rows":
            w[m // 2:] = 0.0
    before = rg_ops.COUNTER.launches
    got = rg_ops.masked_round_gradient(x, y, w, beta)
    again = rg_ops.masked_round_gradient(x, y, w, beta)
    plain = rg_ref.masked_round_gradient(x, y, w, beta)
    torch.cuda.synchronize()
    assert rg_ops.COUNTER.launches == before + 2
    assert torch.equal(got, again)
    w64 = None if w is None else w.double()
    exact = rg_ref.masked_round_gradient(x.double(), y.double(), w64,
                                         beta.double())
    w_abs = torch.ones_like(y) if w is None else w.abs()
    scale = (w_abs * (x.abs() @ beta.abs() + y.abs())) @ x.abs()
    for name, g in (("kernel", got), ("plain", plain)):
        err = (g.double() - exact).abs()
        bound = 1e-3 * exact.abs() + 1e-6 * scale.double()
        assert bool((err <= bound).all()), \
            f"{name}: max err/bound {float((err / bound).max()):.3g}"


def _held_to_float64(name, got, x, y, w, beta, masks=None):
    """`got` (the kernel's or the plain float32 result) against the float64
    expression within rtol 1e-3 + 1e-6 * S (see the module docstring);
    masks=None: one flat gradient, else (T, M) tier masks."""
    x64, y64, b64 = x.double(), y.double(), beta.double()
    w64 = torch.ones_like(y64) if w is None else w.double()
    ms = torch.ones((1, x.shape[0]), dtype=torch.float64, device=x.device) \
        if masks is None else masks.double()
    exact = ((x64 @ b64 - y64) * w64 * ms) @ x64
    scale = ((w64.abs() * ms.abs()) * (x64.abs() @ b64.abs() + y64.abs())) \
        @ x64.abs()
    got = got.double().reshape(exact.shape)
    err = (got - exact).abs()
    bound = 1e-3 * exact.abs() + 1e-6 * scale
    assert bool((err <= bound).all()), \
        f"{name}: max err/bound {float((err / bound).max()):.3g}"


def _rg_operands(gen, cuda, m, d, weights):
    x = torch.randn((m, d), generator=gen, device=cuda)
    y = torch.randn((m,), generator=gen, device=cuda)
    w = None
    if weights != "none":
        w = torch.rand((m,), generator=gen, device=cuda)
        if weights == "zero_rows":
            w[m // 2:] = 0.0
    return x, y, w


@pytest.mark.parametrize("m,c,d", [(1, 1, 1), (7, 3, 5), (37, 17, 13),
                                   (130, 0, 33), (7200, 2016, 500),
                                   (9, 5, 3000)])
@pytest.mark.parametrize("w_par", ["rows", "scalar"])
def test_coded_kernel_matches_plain(cuda, m, c, d, w_par):
    gen = torch.Generator(device=cuda).manual_seed(m + c + d)
    x, y, w = _rg_operands(gen, cuda, m, d, "zero_rows")
    xp, yp, _ = _rg_operands(gen, cuda, c, d, "none")
    beta = torch.randn((d,), generator=gen, device=cuda)
    if w_par == "rows":
        wp = torch.rand((c,), generator=gen, device=cuda)
        wp[::3] = 0.0  # unsampled parity rows
    else:
        wp = torch.tensor(0.37, device=cuda)
    before = (rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches)
    got = rg_ops.coded_round_gradient(x, y, w, xp, yp, wp, beta)
    again = rg_ops.coded_round_gradient(x, y, w, xp, yp, wp, beta)
    plain = rg_ref.coded_round_gradient(x, y, w, xp, yp, wp, beta)
    torch.cuda.synchronize()
    # c == 0 runs the flat kernel, as the reference does
    want = (before[0] + 2, before[1]) if c == 0 \
        else (before[0], before[1] + 2)
    assert (rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches) == want
    assert got.shape == (d,) and torch.equal(got, again)
    wp_rows = torch.broadcast_to(wp, (c,))
    x_all, y_all = torch.cat([x, xp]), torch.cat([y, yp])
    w_all = torch.cat([w, wp_rows])
    for name, g in (("kernel", got), ("plain", plain)):
        _held_to_float64(name, g, x_all, y_all, w_all, beta)


@pytest.mark.parametrize("m,d,t", [(7, 5, 1), (37, 13, 3), (300, 41, 3),
                                   (5632, 500, 3), (5632, 500, 8),
                                   (40, 3000, 12)])
@pytest.mark.parametrize("weights", ["random", "none"])
def test_tier_kernel_matches_plain(cuda, m, d, t, weights):
    """(40, 3000, 12) needs more tier partials than one CTA holds, so the
    tiers run in chunks."""
    gen = torch.Generator(device=cuda).manual_seed(m + d + t)
    x, y, w = _rg_operands(gen, cuda, m, d, weights)
    beta = torch.randn((d,), generator=gen, device=cuda)
    tier_of = torch.randint(0, t, (m,), generator=gen, device=cuda)
    masks = (torch.arange(t, device=cuda)[:, None] == tier_of[None, :]) \
        .float() * torch.rand((1, m), generator=gen, device=cuda) * 2.0
    before = rg_ops.TIER_COUNTER.launches
    got = rg_ops.tier_masked_round_gradient(x, y, w, masks, beta)
    again = rg_ops.tier_masked_round_gradient(x, y, w, masks, beta)
    plain = rg_ref.tier_masked_round_gradient(x, y, w, masks, beta)
    torch.cuda.synchronize()
    assert rg_ops.TIER_COUNTER.launches == before + 2
    assert got.shape == (t, d) and torch.equal(got, again)
    for name, g in (("kernel", got), ("plain", plain)):
        _held_to_float64(name, g, x, y, w, beta, masks=masks)


@pytest.mark.parametrize("m,d", [(1, 1), (37, 13), (5632, 500),
                                 (7200, 500), (9, 3000)])
@pytest.mark.parametrize("weights", ["zero_rows", "none"])
def test_tier_kernel_single_tier_is_the_flat_kernel(cuda, m, d, weights):
    gen = torch.Generator(device=cuda).manual_seed(7 * m + d)
    x, y, w = _rg_operands(gen, cuda, m, d, weights)
    beta = torch.randn((d,), generator=gen, device=cuda)
    ones = torch.ones((1, m), device=cuda)
    tiered = rg_ops.tier_masked_round_gradient(x, y, w, ones, beta)
    flat = rg_ops.masked_round_gradient(x, y, w, beta)
    torch.cuda.synchronize()
    assert torch.equal(tiered[0], flat)


def _resident_max_d(lib) -> int:
    """The widest D the row-resident instances take (past it the library's
    `rg_route` says another route)."""
    d = 8192
    while lib.rg_route(d, 0) != 0:
        d -= 1
    return d


@pytest.mark.parametrize("t", [1, 3, 4])
def test_round_grad_kernels_at_the_widest_d(cuda, t):
    """At the widest D of the row-resident instances and one column past
    it (the first D of the cluster route), the tier kernel runs at T = 1,
    3 and 4 (four masks a ring row, the most a launch carries), the flat,
    least-squares and coded kernels run too, each held to the float64
    bound; no D is refused."""
    lib = rg_ops._dispatch(cuda)
    d0 = _resident_max_d(lib)
    assert d0 >= 3000 and rg_ops.ROUTES[lib.rg_route(d0 + 1, 0)] == "cluster"
    for d in (d0, d0 + 1):
        gen = torch.Generator(device=cuda).manual_seed(d + t)
        x, y, w = _rg_operands(gen, cuda, 300, d, "random")
        beta = torch.randn((d,), generator=gen, device=cuda)
        tier_of = torch.randint(0, t, (300,), generator=gen, device=cuda)
        masks = (torch.arange(t, device=cuda)[:, None]
                 == tier_of[None, :]).float()
        tiers = rg_ops.tier_masked_round_gradient(x, y, w, masks, beta)
        flat = rg_ops.masked_round_gradient(x, y, w, beta)
        lsq = rg_ops.lsq_gradient(x, y, beta)
        coded = rg_ops.coded_round_gradient(x[:200], y[:200], w[:200],
                                            x[200:], y[200:], w[200:], beta)
        torch.cuda.synchronize()
        _held_to_float64(f"tiers D={d}", tiers, x, y, w, beta, masks=masks)
        _held_to_float64(f"flat D={d}", flat, x, y, w, beta)
        _held_to_float64(f"lsq D={d}", lsq, x, y, None, beta)
        _held_to_float64(f"coded D={d}", coded, x, y, w, beta)


# (m, D) past the row-resident width: the coded-head probe's 768 rows at
# granite-8b's d_model and twice it (clusters of 8 and of 16 CTAs; the
# coded kernel at 8192 the two-launch route), ragged D in (3220, 4096]
# (3600: 8 chunks, the last of 16 columns; 4099 and 3601: the 4-byte
# instance) and a single row
@pytest.mark.parametrize("m,d", [(768, 4096), (300, 8192), (768, 8192),
                                 (37, 4099), (768, 3600), (300, 3601),
                                 (1, 5000)])
def test_round_grad_kernels_at_any_d(cuda, m, d):
    """Past the row-resident width (the cluster route; the coded kernel
    at D = 5000 and 8192 the two-launch one, as the library's `rg_route`
    and the wrapper's `route` both say): kernels 1, 4, 5 (T = 1, 3 and 6:
    two launches of tiers) and 6 against the float64 bound, relaunches
    bit-identical, T = 1 `torch.equal` to the flat kernel and the
    least-squares kernel to the flat one at w = None; D = 4099 and 3601
    take the 4-byte instance, and a misaligned view too."""
    lib = rg_ops._dispatch(cuda)
    for coded in (False, True):
        assert rg_ops.ROUTES[lib.rg_route(d, int(coded))] \
            == rg_ops.route(d, coded=coded) != "resident"
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    x, y, w = _rg_operands(gen, cuda, m, d, "zero_rows")
    beta = torch.randn((d,), generator=gen, device=cuda)
    flat = rg_ops.masked_round_gradient(x, y, w, beta)
    again = rg_ops.masked_round_gradient(x, y, w, beta)
    _held_to_float64("flat", flat, x, y, w, beta)
    _held_to_float64("plain", rg_ref.masked_round_gradient(x, y, w, beta),
                     x, y, w, beta)
    assert torch.equal(flat, again)
    one = rg_ops.tier_masked_round_gradient(
        x, y, w, torch.ones((1, m), device=cuda), beta)
    assert torch.equal(one[0], flat)
    lsq = rg_ops.lsq_gradient(x, y, beta)
    assert torch.equal(lsq, rg_ops.masked_round_gradient(x, y, None, beta))
    _held_to_float64("lsq", lsq, x, y, None, beta)
    for t in (3, 6):
        tier_of = torch.randint(0, t, (m,), generator=gen, device=cuda)
        masks = (torch.arange(t, device=cuda)[:, None]
                 == tier_of[None, :]).float()
        tiers = rg_ops.tier_masked_round_gradient(x, y, w, masks, beta)
        _held_to_float64(f"tiers T={t}", tiers, x, y, w, beta, masks=masks)
    xp, yp, _ = _rg_operands(gen, cuda, 65, d, "none")
    wp = torch.rand((65,), generator=gen, device=cuda)
    coded = rg_ops.coded_round_gradient(x, y, w, xp, yp, wp, beta)
    _held_to_float64("coded", coded, torch.cat([x, xp]),
                     torch.cat([y, yp]), torch.cat([w, wp]), beta)
    buf = torch.randn((m * d + 1,), generator=gen, device=cuda)
    xv = buf[1:].view(m, d)  # 4-byte aligned only
    _held_to_float64("misaligned", rg_ops.masked_round_gradient(
        xv, y, w, beta), xv, y, w, beta)


def test_routes_and_instances_match_the_libraries(cuda):
    """The library's `rg_route` is the wrapper's `route` at every D to
    20000 (both variants), and kernel 8's `flash_attn_instance` the
    wrapper's `instance` at every head size and short and long
    sequences."""
    lib = rg_ops._dispatch(cuda)
    for d in list(range(1, 9000, 7)) + [3220, 3221, 4096, 4097, 8192, 8193,
                                        20000]:
        for coded in (False, True):
            assert rg_ops.ROUTES[lib.rg_route(d, int(coded))] \
                == rg_ops.route(d, coded=coded), (d, coded)
    fl = fa_ops._dispatch(cuda)
    for d in range(1, fa_ops.MAX_D + 1):
        for vec in (True, False):
            for s in (1, 15, 16, 31, 32, 33, 63, 64, 65, 100, 2048):
                got = fl.flash_attn_instance(d, int(vec), s)
                assert fa_ops.INSTANCES[got] == fa_ops.instance(
                    d, aligned=vec, s=s), (d, vec, s)
            assert fa_ops.INSTANCES[fl.flash_attn_instance(
                d, int(vec), 2048)] == fa_ops.instance(d, aligned=vec)


def _rg_calls(cuda, m=5632, d=500, seed=5, c=2016):
    """Each round-gradient kernel on one set of operands (at the §IV
    shape by default), as {name: call}."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, y, w = _rg_operands(gen, cuda, m, d, "zero_rows")
    xp, yp, _ = _rg_operands(gen, cuda, c, d, "none")
    wp = torch.rand((c,), generator=gen, device=cuda)
    beta = torch.randn((d,), generator=gen, device=cuda)
    tier_of = torch.randint(0, 3, (m,), generator=gen, device=cuda)
    masks = (torch.arange(3, device=cuda)[:, None]
             == tier_of[None, :]).float()
    return {
        "flat": lambda: rg_ops.masked_round_gradient(x, y, w, beta),
        "coded": lambda: rg_ops.coded_round_gradient(x, y, w, xp, yp, wp,
                                                     beta),
        "tier": lambda: rg_ops.tier_masked_round_gradient(x, y, w, masks,
                                                          beta),
        "lsq": lambda: rg_ops.lsq_gradient(xp, yp, beta),
    }


# (m, D, c): the §IV shape, and the coded-head probe's on the cluster route
RELAUNCH_SHAPES = [(5632, 500, 2016), (768, 4096, 230)]


@pytest.mark.parametrize("m,d,c", RELAUNCH_SHAPES)
@pytest.mark.parametrize("kernel", ["flat", "coded", "tier", "lsq"])
def test_round_grad_kernels_relaunch_bit_identical(cuda, kernel, m, d, c):
    """Three calls in a row, bit-identical: the in-launch reduce's ticket
    counter is back at 0 after each launch."""
    call = _rg_calls(cuda, m=m, d=d, c=c)[kernel]
    outs = [call() for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("m,d,c", RELAUNCH_SHAPES)
@pytest.mark.parametrize("kernel", ["flat", "coded", "tier", "lsq"])
def test_round_grad_kernels_on_two_streams(cuda, kernel, m, d, c):
    """Two calls at once on two streams (each stream held by a sleep
    kernel, then released together), each `torch.equal` to its result on
    one stream: the two launches take separate ticket counters."""
    calls = [_rg_calls(cuda, m=m, d=d, c=c, seed=s)[kernel] for s in (5, 6)]
    alone = [call() for call in calls]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in calls]
    outs = []
    for stream, call in zip(streams, calls):
        with torch.cuda.stream(stream):
            torch.cuda._sleep(2**20)
            outs.append([call() for _ in range(4)])
    torch.cuda.synchronize()
    for got, want in zip(outs, alone):
        assert all(torch.equal(g, want) for g in got)


def test_round_grad_kernels_on_a_misaligned_view(cuda):
    """X as a contiguous view one float into its storage (D = 500, rows
    not 16-byte aligned) takes the 4-byte instance: held to the float64
    bound, relaunches bit-identical, T = 1 and lsq `torch.equal` to flat."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    m, d = 1000, 500
    x = torch.randn((m * d + 1,), generator=gen, device=cuda)[1:].view(m, d)
    y = torch.randn((m,), generator=gen, device=cuda)
    beta = torch.randn((d,), generator=gen, device=cuda)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    flat = rg_ops.masked_round_gradient(x, y, None, beta)
    again = rg_ops.masked_round_gradient(x, y, None, beta)
    one = rg_ops.tier_masked_round_gradient(x, y, None,
                                            torch.ones((1, m), device=cuda),
                                            beta)
    lsq = rg_ops.lsq_gradient(x, y, beta)
    torch.cuda.synchronize()
    _held_to_float64("misaligned flat", flat, x, y, None, beta)
    assert torch.equal(flat, again)
    assert torch.equal(one[0], flat) and torch.equal(lsq, flat)


def test_round_grad_kernel_checks_operands(cuda):
    x = torch.randn((8, 4), device=cuda)
    y = torch.randn((8,), device=cuda)
    beta = torch.randn((4,), device=cuda)
    with pytest.raises(TypeError):
        rg_ops.masked_round_gradient(x.double(), y, None, beta)
    with pytest.raises(ValueError):
        rg_ops.masked_round_gradient(x.T, y, None, beta[:4])
    with pytest.raises(ValueError):
        rg_ops.masked_round_gradient(x, y[:7], None, beta)
    masks = torch.ones((2, 8), device=cuda)
    with pytest.raises(ValueError):
        rg_ops.tier_masked_round_gradient(x, y, None, masks[:, :7], beta)
    with pytest.raises(ValueError):
        rg_ops.tier_masked_round_gradient(x, y, None, masks[0], beta)
    with pytest.raises(ValueError):
        rg_ops.coded_round_gradient(x, y, None, x[:3, :3].contiguous(),
                                    y[:3], 1.0, beta)
    with pytest.raises(ValueError):
        rg_ops.coded_round_gradient(x, y, None, x[:3], y[:2], 1.0, beta)


def _encode_held(g, w, x):
    """Kernel 2 on (g, w, x) against the plain version within 2e-4 *
    max|ref|, kernel and plain within the float64 bound, and a
    bit-identical relaunch."""
    got = enc_ops.encode_parity(g, w, x)
    again = enc_ops.encode_parity(g, w, x)
    want = enc_ref.encode_parity(g, w, x)
    p64, bound64 = enc_ops.float64_reference_and_bound(g, w, x)
    torch.cuda.synchronize()
    bound = 2e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=bound)
    for name, p in (("kernel", got), ("plain", want)):
        err = (p.double() - p64).abs()
        assert bool((err <= bound64).all()), \
            f"{name}: max err/bound {float((err / bound64).max()):.3g}"
    assert torch.equal(got, again)


@pytest.mark.parametrize("c,ell,d", [(1, 1, 1), (5, 7, 3), (130, 17, 65),
                                     (2016, 300, 501), (131, 37, 67),
                                     (257, 9, 130), (2017, 301, 503),
                                     (300, 64, 128), (2016, 300, 500)])
def test_encode_kernel_matches_plain(cuda, c, ell, d):
    """Ragged C, L and D (not multiples of the 128 x 64 tile, the step
    of 32 or of 8) and both copy widths: L % 4 == 0 takes 16-byte copies
    of G, D % 4 == 0 of X."""
    gen = torch.Generator(device=cuda).manual_seed(c + ell + d)
    g = torch.randn((c, ell), generator=gen, device=cuda)
    w = torch.rand((ell,), generator=gen, device=cuda)
    x = torch.randn((ell, d), generator=gen, device=cuda)
    _encode_held(g, w, x)


def test_encode_kernel_on_misaligned_operands(cuda):
    """G and X as contiguous views one float into their storage: L and D
    are multiples of 4, but the rows are not 16-byte aligned, so the
    kernel takes its 4-byte copies; large operands (x 30) too."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    c, ell, d = 300, 64, 128
    g = torch.randn((c * ell + 1,), generator=gen, device=cuda)[1:] \
        .view(c, ell)
    x = torch.randn((ell * d + 1,), generator=gen, device=cuda)[1:] \
        .view(ell, d)
    w = torch.rand((ell,), generator=gen, device=cuda)
    assert g.is_contiguous() and g.data_ptr() % 16 != 0
    _encode_held(g, w, x)
    _encode_held(30.0 * g, w, 30.0 * x)


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
def test_session_on_the_card_matches_cpu(cuda, grad_path):
    """The same small run on the card and on the CPU (plain versions):
    identical clocks, NMSE within rtol 1e-4."""
    n, ell, d = 8, 64, 16
    fleet = make_fleet(n, d, 0.3, 0.3, np.random.default_rng(3))
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((n, ell, d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    ys = (xs @ beta + rng.standard_normal((n, ell))).astype(np.float32)
    cpu_data = api.TrainData(torch.tensor(xs), torch.tensor(ys),
                             torch.tensor(beta))
    strategy = api.CodedFL(key=1, fixed_c=143, grad_path=grad_path)
    cpu_sess = api.Session(strategy, fleet, 0.3, 30, device="cpu")
    cpu_state = cpu_sess.plan(cpu_data)
    # the same plan and parity on the card (its generator draws its own)
    gpu_state = CFLState(cpu_state.plan, *(
        t.to(cuda) for t in (cpu_state.weights, cpu_state.load_mask,
                             cpu_state.x_parity, cpu_state.y_parity)),
        edge=cpu_state.edge, server=cpu_state.server)
    gpu_data = api.TrainData(*(t.to(cuda) for t in (
        cpu_data.xs, cpu_data.ys, cpu_data.beta_true)))
    cpu_rep = cpu_sess.run(cpu_data, rng=np.random.default_rng(0),
                           state=cpu_state)
    gpu_rep = api.Session(strategy, fleet, 0.3, 30, device=cuda).run(
        gpu_data, rng=np.random.default_rng(0), state=gpu_state)
    np.testing.assert_array_equal(gpu_rep.times, cpu_rep.times)
    np.testing.assert_allclose(gpu_rep.nmse, cpu_rep.nmse, rtol=1e-4)


def _small_problem(cuda):
    n, ell, d = 8, 64, 16
    fleet = make_fleet(n, d, 0.3, 0.3, np.random.default_rng(3))
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((n, ell, d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    ys = (xs @ beta + rng.standard_normal((n, ell))).astype(np.float32)
    cpu_data = api.TrainData(torch.tensor(xs), torch.tensor(ys),
                             torch.tensor(beta))
    gpu_data = api.TrainData(*(t.to(cuda) for t in (
        cpu_data.xs, cpu_data.ys, cpu_data.beta_true)))
    return fleet, cpu_data, gpu_data


@pytest.mark.parametrize("grad_path", ["fused", "reference"])
@pytest.mark.parametrize("tiers", [0, 1, 3])
def test_scfl_on_the_card_matches_cpu(cuda, grad_path, tiers):
    """SCFL at rho = 0.5, flat (tiers = 0) and hierarchical, on the card
    and on the CPU from the same plan and noised parity: identical
    clocks, NMSE within rtol 1e-4; the fused flat run launches the coded
    kernel once per epoch, the hierarchical one the tier kernel."""
    fleet, cpu_data, gpu_data = _small_problem(cuda)
    strategy = StochasticCodedFL(key=1, fixed_c=143, sample_frac=0.5,
                                 include_upload_delay=False,
                                 grad_path=grad_path)
    cpu_state = strategy.plan(fleet, cpu_data)
    gpu_state = StochasticState(cpu_state.plan, *(
        t.to(cuda) for t in (cpu_state.load_mask, cpu_state.x_parity,
                             cpu_state.y_parity)),
        edge=cpu_state.edge, server=cpu_state.server,
        noise_scale_x=cpu_state.noise_scale_x,
        noise_scale_y=cpu_state.noise_scale_y,
        srv_weight=cpu_state.srv_weight)
    if tiers:
        topo = FleetTopology.uniform(8, tiers)
        strategy = HierarchicalCFL(strategy, topo)
        cpu_state = HierState(cpu_state, topo)
        gpu_state = HierState(gpu_state, topo)
    counters = (rg_ops.COUNTER, rg_ops.CODED_COUNTER, rg_ops.TIER_COUNTER)
    before = [k.launches for k in counters]
    cpu_rep = api.Session(strategy, fleet, 0.3, 30, device="cpu").run(
        cpu_data, rng=np.random.default_rng(0), state=cpu_state)
    gpu_rep = api.Session(strategy, fleet, 0.3, 30, device=cuda).run(
        gpu_data, rng=np.random.default_rng(0), state=gpu_state)
    launched = [k.launches - b for k, b in zip(counters, before)]
    if grad_path == "reference":
        assert launched == [0, 0, 0]
    elif tiers:  # tier kernel for the edge stage, flat one for the parity
        assert launched == [30, 0, 30]
    else:
        assert launched == [0, 30, 0]
    np.testing.assert_array_equal(gpu_rep.times, cpu_rep.times)
    np.testing.assert_allclose(gpu_rep.nmse, cpu_rep.nmse, rtol=1e-4)
    assert gpu_rep.extras == cpu_rep.extras


def _counted(counters):
    before = [k.launches for k in counters]
    return lambda: [k.launches - b for k, b in zip(counters, before)]


@pytest.mark.parametrize("tiers", [0, 3])
@pytest.mark.parametrize("r", [2, 4])
def test_gradcode_on_the_card(cuda, r, tiers):
    """GradientCodingFL on the card: the fused run launches the flat
    round-gradient kernel once per epoch (the tier-masked one under
    HierarchicalCFL) and nothing else; the reference path launches
    nothing, with identical clocks and NMSE within rtol 1e-4 of the fused
    run and of the CPU run."""
    fleet, cpu_data, gpu_data = _small_problem(cuda)
    counters = (rg_ops.COUNTER, rg_ops.CODED_COUNTER, rg_ops.TIER_COUNTER,
                enc_ops.COUNTER)
    reps = {}
    for grad_path in ("fused", "reference"):
        strategy = api.make_strategy("gradcode", r=r, grad_path=grad_path)
        state = strategy.plan(fleet, gpu_data)
        if tiers:
            topo = FleetTopology.uniform(8, tiers)
            strategy = HierarchicalCFL(strategy, topo)
            state = HierState(state, topo)
        launched = _counted(counters)
        reps[grad_path] = api.Session(strategy, fleet, 0.3, 30,
                                      device=cuda).run(
            gpu_data, rng=np.random.default_rng(0), state=state)
        torch.cuda.synchronize()
        if grad_path == "reference":
            assert launched() == [0, 0, 0, 0]
        else:
            assert launched() == ([0, 0, 30, 0] if tiers else [30, 0, 0, 0])
    cpu = api.Session(api.make_strategy("gradcode", r=r), fleet, 0.3, 30,
                      device="cpu").run(cpu_data,
                                        rng=np.random.default_rng(0))
    for other in (reps["reference"], cpu):
        np.testing.assert_array_equal(reps["fused"].times, other.times)
        np.testing.assert_allclose(reps["fused"].nmse, other.nmse,
                                   rtol=1e-4)


def test_dp_scfl_on_the_card(cuda):
    """StochasticCodedFL built from an (epsilon, delta) budget with the
    calibration, the accounting and the plan on the card: the calibrated
    sigma within 1e-9 relative of the CPU's, its spend within the budget;
    one encode launch per client, one coded launch per epoch; the
    reference path launches nothing, identical clocks, NMSE within rtol
    1e-4."""
    from repro_torch.privacy import calibrate_noise, epsilon_spent
    fleet, _, gpu_data = _small_problem(cuda)
    strategy = api.make_strategy("stochastic", key_seed=1, fixed_c=143,
                                 epsilon_target=4.0, rounds=30,
                                 sample_frac=0.5,
                                 include_upload_delay=False)
    sigma = strategy.noise_multiplier
    cpu_sigma = calibrate_noise(4.0, rounds=30, sample_frac=0.5,
                                device="cpu")
    assert abs(sigma - cpu_sigma) <= 1e-9 * cpu_sigma
    assert epsilon_spent(sigma, 0.5, 30, 1e-5) <= 4.0
    counters = (rg_ops.COUNTER, rg_ops.CODED_COUNTER, rg_ops.TIER_COUNTER,
                enc_ops.COUNTER)
    launched = _counted(counters)
    state = strategy.plan(fleet, gpu_data)
    fused = api.Session(strategy, fleet, 0.3, 30, device=cuda).run(
        gpu_data, rng=np.random.default_rng(0), state=state)
    torch.cuda.synchronize()
    assert launched() == [0, 30, 0, 8]
    launched = _counted(counters)
    ref = api.Session(dataclasses.replace(strategy, grad_path="reference"),
                      fleet, 0.3, 30, device=cuda).run(
        gpu_data, rng=np.random.default_rng(0), state=state)
    assert launched() == [0, 0, 0, 0]
    np.testing.assert_array_equal(fused.times, ref.times)
    np.testing.assert_allclose(fused.nmse, ref.nmse, rtol=1e-4)
    eps, delta = fused.privacy_budget()
    assert eps <= 4.0 and delta == 1e-5
    assert fused.extras["epsilon_schedule"].shape == (30,)


@pytest.mark.parametrize("tiers", [0, 3])
def test_lowlatency_on_the_card(cuda, tiers):
    """LowLatencyCFL with the partial-return plan solved on the card (loads
    and c equal to the CPU plan's, t* within rtol 1e-6): one encode launch
    per client, one round-gradient launch per epoch (the tier-masked one
    under HierarchicalCFL); the reference path launches nothing,
    identical clocks, NMSE within rtol 1e-4; at chunks = 1 the parity is
    CodedFL's (`torch.equal`)."""
    fleet, cpu_data, gpu_data = _small_problem(cuda)
    strategy = api.make_strategy("lowlatency", key_seed=1, fixed_c=143,
                                 chunks=4, include_upload_delay=False)
    counters = (rg_ops.COUNTER, rg_ops.CODED_COUNTER, rg_ops.TIER_COUNTER,
                enc_ops.COUNTER)
    launched = _counted(counters)
    state = strategy.plan(fleet, gpu_data)
    torch.cuda.synchronize()
    assert launched() == [0, 0, 0, 8]
    cpu_plan = strategy.plan(fleet, cpu_data).plan
    np.testing.assert_array_equal(state.plan.loads, cpu_plan.loads)
    assert state.plan.c == cpu_plan.c == 143
    np.testing.assert_allclose(state.plan.t_star, cpu_plan.t_star,
                               rtol=1e-6)
    run_strategy, run_state = strategy, state
    if tiers:
        topo = FleetTopology.uniform(8, tiers)
        run_strategy = HierarchicalCFL(strategy, topo)
        run_state = HierState(state, topo)
    launched = _counted(counters)
    fused = api.Session(run_strategy, fleet, 0.3, 30, device=cuda).run(
        gpu_data, rng=np.random.default_rng(0), state=run_state)
    torch.cuda.synchronize()
    assert launched() == ([0, 0, 30, 0] if tiers else [30, 0, 0, 0])
    ref_base = dataclasses.replace(strategy, grad_path="reference")
    ref_strategy = HierarchicalCFL(ref_base, topo) if tiers else ref_base
    launched = _counted(counters)
    ref = api.Session(ref_strategy, fleet, 0.3, 30, device=cuda).run(
        gpu_data, rng=np.random.default_rng(0), state=run_state)
    assert launched() == [0, 0, 0, 0]
    np.testing.assert_array_equal(fused.times, ref.times)
    np.testing.assert_allclose(fused.nmse, ref.nmse, rtol=1e-4)
    one = api.make_strategy("lowlatency", key_seed=1, fixed_c=143, chunks=1)
    cfl = api.make_strategy("cfl", key_seed=1, fixed_c=143, use_kernel=True)
    st_1, st_c = one.plan(fleet, gpu_data), cfl.plan(fleet, gpu_data)
    assert st_1.plan.t_star == st_c.plan.t_star
    assert torch.equal(st_1.x_parity, st_c.x_parity)
    assert torch.equal(st_1.y_parity, st_c.y_parity)


def test_single_tier_on_the_card_is_the_flat_run(cuda):
    """HierarchicalCFL over CodedFL at T = 1 on the card: the NMSE trace is
    bit-equal to the flat CodedFL run."""
    fleet, _, gpu_data = _small_problem(cuda)
    strategy = api.CodedFL(key=1, fixed_c=143, include_upload_delay=False)
    state = strategy.plan(fleet, gpu_data)
    flat = api.Session(strategy, fleet, 0.3, 30, device=cuda).run(
        gpu_data, rng=np.random.default_rng(0), state=state)
    topo = FleetTopology.uniform(8, 1)
    hier = api.Session(HierarchicalCFL(strategy, topo), fleet, 0.3, 30,
                       device=cuda).run(
        gpu_data, rng=np.random.default_rng(0),
        state=HierState(state, topo))
    np.testing.assert_array_equal(hier.nmse, flat.nmse)
    np.testing.assert_array_equal(hier.times, flat.times)


@pytest.mark.parametrize("kind", ["bernoulli", "normal"])
@pytest.mark.parametrize("c,ell", [(1, 1), (3, 5), (17, 33), (37, 13),
                                   (2016, 300)])
def test_prng_kernel_generator_is_the_plain_one(cuda, c, ell, kind):
    """At X = I and w = 1 the kernel returns G itself (odd c * ell
    included)."""
    key = prng.split_keys(prng.prng_key(c + ell), 3)[2]
    eye = torch.eye(ell, device=cuda)
    got = enc_ops.encode_parity_prng(key, torch.ones(ell, device=cuda), eye,
                                     c, kind)
    want = prng.generator_values(key, c, ell, kind, device=cuda)
    torch.cuda.synchronize()
    if kind == "bernoulli":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["bernoulli", "normal"])
@pytest.mark.parametrize("c,ell,d", [(1, 1, 1), (5, 7, 3), (37, 13, 5),
                                     (130, 17, 513), (2016, 300, 501)])
def test_prng_kernel_matches_plain(cuda, c, ell, d, kind):
    gen = torch.Generator(device=cuda).manual_seed(c + ell + d)
    w = torch.rand((ell,), generator=gen, device=cuda)
    x = torch.randn((ell, d), generator=gen, device=cuda)
    key = prng.prng_key(c * d)
    before = enc_ops.PRNG_COUNTER.launches
    got = enc_ops.encode_parity_prng(key, w, x, c, kind)
    again = enc_ops.encode_parity_prng(key, w, x, c, kind)
    want = enc_ref.encode_parity_prng(key, w, x, c, kind)
    torch.cuda.synchronize()
    assert enc_ops.PRNG_COUNTER.launches == before + 2
    assert torch.equal(got, again)
    bound = 2e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=bound)


@pytest.mark.parametrize("kind", ["bernoulli", "normal"])
@pytest.mark.parametrize("c,ell,d", [(1, 1, 1), (5, 7, 3), (37, 13, 5),
                                     (130, 17, 513), (2016, 300, 501),
                                     (2017, 299, 33), (128, 8, 33),
                                     (17, 40, 1100)])
def test_prng_kernel_within_the_float64_bound(cuda, c, ell, d, kind):
    """Kernel 3 and the plain version both within the encode's float64
    bound, G the plain generator; relaunches bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(c + ell + d + 1)
    w = torch.rand((ell,), generator=gen, device=cuda)
    x = torch.randn((ell, d), generator=gen, device=cuda)
    key = prng.prng_key(c * d + 1)
    got = enc_ops.encode_parity_prng(key, w, x, c, kind)
    again = enc_ops.encode_parity_prng(key, w, x, c, kind)
    plain = enc_ref.encode_parity_prng(key, w, x, c, kind)
    g = prng.generator_values(key, c, ell, kind, device=cuda)
    p64, bound64 = enc_ops.float64_reference_and_bound(g, w, x)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for name, p in (("kernel", got), ("plain", plain)):
        err = (p.double() - p64).abs()
        assert bool((err <= bound64).all()), \
            f"{name}: max err/bound {float((err / bound64).max()):.3g}"


def test_prng_kernel_on_a_misaligned_view(cuda):
    """X and w as contiguous views one float into their storage, D a
    multiple of 4: the kernel's 4-byte copies take any alignment."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    c, ell, d = 300, 64, 128
    x = torch.randn((ell * d + 1,), generator=gen, device=cuda)[1:] \
        .view(ell, d)
    w = torch.rand((ell + 1,), generator=gen, device=cuda)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    key = prng.prng_key(9)
    for kind in prng.KINDS:
        got = enc_ops.encode_parity_prng(key, w, x, c, kind)
        want = enc_ops.encode_parity_prng(key, w.clone(), x.clone(), c,
                                          kind)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_prng_kernel_guards(cuda):
    w = torch.ones(2**16, device=cuda)
    x = torch.ones((2**16, 1), device=cuda)
    before = enc_ops.PRNG_COUNTER.launches
    with pytest.raises(ValueError, match="2\\*\\*31"):
        enc_ops.encode_parity_prng(prng.prng_key(0), w, x, 2**15)
    with pytest.raises(ValueError, match="unknown generator kind"):
        enc_ops.encode_parity_prng(prng.prng_key(0), w[:4], x[:4], 2, "u")
    with pytest.raises(TypeError):
        enc_ops.encode_parity_prng(prng.prng_key(0), w[:4], x[:4].double(),
                                   2)
    assert enc_ops.PRNG_COUNTER.launches == before
    out = enc_ops.encode_parity_prng(prng.prng_key(0), w[:4], x[:4], 0)
    assert tuple(out.shape) == (0, 1)


@pytest.mark.parametrize("kind", ["bernoulli", "normal"])
def test_prng_fleet_encode_on_the_card(cuda, kind):
    """The fleet encoders: one launch per client, the plain composite
    within the encode bound, one tier `torch.equal` to the flat run."""
    n, ell, d, c = 12, 8, 32, 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    xs = torch.randn((n, ell, d), generator=gen, device=cuda)
    ys = torch.randn((n, ell), generator=gen, device=cuda)
    w = torch.rand((n, ell), generator=gen, device=cuda) + 0.5
    key = prng.prng_key(3)
    before = enc_ops.PRNG_COUNTER.launches
    fx, fy = enc_ops.encode_fleet_prng(key, xs, ys, w, c, kind)
    assert enc_ops.PRNG_COUNTER.launches == before + n
    tx, ty = encode_fleet_tiered(key, xs, ys, w, c,
                                 FleetTopology.uniform(n, 1), kind)
    torch.cuda.synchronize()
    assert torch.equal(tx, fx) and torch.equal(ty, fy)
    px, py = enc_ops.encode_fleet_prng(key, xs.cpu(), ys.cpu(), w.cpu(), c,
                                       kind)
    for got, want in ((fx, px), (fy, py)):
        bound = 2e-4 * float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=bound)
    t3x, t3y = encode_fleet_tiered(key, xs, ys, w, c,
                                   FleetTopology.uniform(n, 3), kind)
    torch.testing.assert_close(t3x, fx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(t3y, fy, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,d", [(1, 1), (7, 5), (37, 13), (179, 16),
                                 (2016, 500), (9, 3000)])
def test_lsq_kernel_matches_plain(cuda, m, d):
    gen = torch.Generator(device=cuda).manual_seed(3 * m + d)
    a = torch.randn((m, d), generator=gen, device=cuda)
    y = torch.randn((m,), generator=gen, device=cuda)
    beta = torch.randn((d,), generator=gen, device=cuda)
    before = (cg_ops.COUNTER.launches, rg_ops.COUNTER.launches)
    got = cg_ops.lsq_gradient(a, y, beta)
    again = cg_ops.lsq_gradient(a, y, beta)
    plain = cg_ref.lsq_gradient(a, y, beta)
    # the flat kernel at the row tile lsq_gradient's "auto" resolved
    tile = resolve_block("coded_grad", (m, d), "auto", 0, cuda)
    flat = rg_ops.masked_round_gradient(a, y, None, beta, block_m=tile)
    torch.cuda.synchronize()
    assert (cg_ops.COUNTER.launches, rg_ops.COUNTER.launches) == \
        (before[0] + 2, before[1] + 1)
    assert torch.equal(got, again)
    assert torch.equal(got, flat)
    _held_to_float64("lsq kernel", got, a, y, None, beta)
    _held_to_float64("lsq plain", plain, a, y, None, beta)


def _ssd_operands(gen, cuda, B, nc, Q, H, P, N, G, model_da):
    xc = torch.randn((B, nc, Q, H, P), generator=gen, device=cuda)
    dtc = torch.nn.functional.softplus(
        torch.randn((B, nc, Q, H), generator=gen, device=cuda))
    if model_da:
        da = dtc * -torch.linspace(1.0, 16.0, H, device=cuda)
    else:
        da = -0.1 * torch.randn((B, nc, Q, H), generator=gen,
                                device=cuda).abs()
    bc = torch.randn((B, nc, Q, G, N), generator=gen, device=cuda)
    cc = torch.randn((B, nc, Q, G, N), generator=gen, device=cuda)
    return xc, dtc, da, bc, cc


def _ssd_plain(xc, dtc, da, bc, cc):
    rep = xc.shape[3] // bc.shape[3]
    return ssd_ref.ssd_chunk_reference(xc, dtc, da,
                                       bc.repeat_interleave(rep, 3),
                                       cc.repeat_interleave(rep, 3))


# (B, nc, Q, H, P, N, G): the shapes of tests/test_kernels.py, the full
# per-head shape, the reduced mamba2's (Q 16, P 32, N 16), an odd Q, and
# the serving shape of mamba2-1.3b (a 2048-token prefill) with its one
# group and with per-head B and C, and zamba2-1.2b's (d_state 64, a
# 2048-token prefill); then the 3xTF32 kernel's edges: three
# heads a group, 5 and 12 heads against its block of 8, Q = 200 at the
# serving P and N, P = 80 / N = 96 and P = 130 / N = 136 against its 64-
# and 128-wide tiles, and P = 7 / N = 9 (4-byte copies)
SSD_SHAPES = [(1, 1, 8, 1, 4, 4, 1), (2, 3, 32, 4, 16, 8, 4),
              (1, 2, 128, 2, 64, 32, 2), (1, 2, 256, 2, 64, 128, 2),
              (2, 3, 16, 16, 32, 16, 1), (1, 2, 97, 4, 64, 128, 2),
              (1, 8, 256, 64, 64, 128, 1), (1, 8, 256, 64, 64, 128, 64),
              (1, 8, 256, 64, 64, 64, 1),
              (1, 2, 128, 6, 64, 64, 2), (1, 2, 96, 5, 32, 64, 1),
              (1, 2, 256, 12, 64, 128, 1), (1, 2, 200, 4, 64, 128, 1),
              (1, 2, 128, 2, 80, 96, 1), (1, 1, 64, 2, 130, 136, 1),
              (1, 2, 45, 3, 7, 9, 1)]


@pytest.mark.parametrize("B,nc,Q,H,P,N,G", SSD_SHAPES)
@pytest.mark.parametrize("model_da", [False, True])
def test_ssd_kernel_matches_plain(cuda, B, nc, Q, H, P, N, G, model_da):
    gen = torch.Generator(device=cuda).manual_seed(B + Q + H + G)
    ops = _ssd_operands(gen, cuda, B, nc, Q, H, P, N, G, model_da)
    before = ssd_ops.SSD_COUNTER.launches
    y, s = ssd_ops.ssd_chunk(*ops)
    y2, s2 = ssd_ops.ssd_chunk(*ops)
    y0, s0 = _ssd_plain(*ops)
    torch.cuda.synchronize()
    assert ssd_ops.SSD_COUNTER.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(s, s2)
    for got, want in ((y, y0), (s, s0)):
        bound = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=bound)
    if model_da:
        y64, s64, yb, sb = ssd_ref.float64_reference_and_bound(*ops)
        for got in (y, y0):
            assert bool(((got.double() - y64).abs() <= yb).all())
        for got in (s, s0):
            assert bool(((got.double() - s64).abs() <= sb).all())


def test_ssd_kernel_checks_operands(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    xc, dtc, da, bc, cc = _ssd_operands(gen, cuda, 1, 1, 8, 2, 4, 4, 1,
                                        False)
    with pytest.raises(TypeError, match="da must be float32"):
        ssd_ops.ssd_chunk(xc, dtc, da.double(), bc, cc)
    with pytest.raises(ValueError, match="groups do not divide"):
        ssd_ops.ssd_chunk(xc, dtc, da, torch.cat([bc] * 3, 3),
                          torch.cat([cc] * 3, 3))
    # a chunk one row longer than the kernel's shared memory holds (Q =
    # 257 > kMaxQ = 256 of csrc/ssd.cu, its query tile's scores for the
    # whole chunk): the launch function refuses it before a launch, and
    # nothing is counted
    n = ssd_ops.SSD_COUNTER.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ssd_ops.ssd_chunk(*_ssd_operands(gen, cuda, 1, 1, 257, 1, 1, 1, 1,
                                         False))
    assert ssd_ops.SSD_COUNTER.launches == n
    # bf16 operands are upcast exactly, as the Pallas kernel does on load
    y, s = ssd_ops.ssd_chunk(xc.bfloat16(), dtc, da, bc.bfloat16(),
                             cc.bfloat16())
    y0, s0 = ssd_ops.ssd_chunk(xc.bfloat16().float(), dtc, da,
                               bc.bfloat16().float(), cc.bfloat16().float())
    assert torch.equal(y, y0) and torch.equal(s, s0)


def _ssd_serving_operands(cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return _ssd_operands(gen, cuda, 1, 8, 256, 64, 64, 128, 1, True)


def test_ssd_kernel_relaunch_bit_identical(cuda):
    """Three calls in a row at the serving shape, bit-identical: every
    sum has a fixed order and no atomics."""
    ops = _ssd_serving_operands(cuda, 7)
    outs = [ssd_ops.ssd_chunk(*ops) for _ in range(3)]
    torch.cuda.synchronize()
    for y, s in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(s, outs[0][1])


def test_ssd_kernel_on_two_streams(cuda):
    """Two calls at once on two streams (each stream held by a sleep
    kernel, then released together), each `torch.equal` to its result on
    one stream: a launch keeps nothing between calls."""
    ops = [_ssd_serving_operands(cuda, s) for s in (5, 6)]
    alone = [ssd_ops.ssd_chunk(*o) for o in ops]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in ops]
    outs = []
    for stream, o in zip(streams, ops):
        with torch.cuda.stream(stream):
            torch.cuda._sleep(2**20)
            outs.append([ssd_ops.ssd_chunk(*o) for _ in range(4)])
    torch.cuda.synchronize()
    for got, want in zip(outs, alone):
        assert all(torch.equal(y, want[0]) and torch.equal(s, want[1])
                   for y, s in got)


def test_ssd_prefill_on_the_card_matches_cpu(cuda):
    """The reduced mamba2 prefill through kernel 7 (one launch per layer)
    against the CPU prefill on the same weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("mamba2-1.3b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params_gpu = _to(params, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 45),
                         generator=torch.Generator().manual_seed(1))
    want, want_cache = T.prefill(cfg, params, {"tokens": toks})
    before = ssd_ops.SSD_COUNTER.launches
    got, cache = T.prefill(cfg, params_gpu, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert ssd_ops.SSD_COUNTER.launches == before + cfg.n_layers
    for g, w in ((got, want), (cache["mamba"]["ssm"],
                               want_cache["mamba"]["ssm"])):
        bound = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=bound)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b"])
def test_hybrid_and_moe_prefill_on_the_card_match_cpu(cuda, arch):
    """The reduced zamba2 at 5 layers (kernel 7 in each Mamba2 layer,
    kernel 8 in each of the two uses of the shared block) and the reduced
    moe configs (kernel 8 in each layer) prefilled on the card against
    the CPU prefill on the same weights and tokens: logits and every
    cache leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(arch).reduced()
    if cfg.arch_type == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=5)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 45),
                         generator=torch.Generator().manual_seed(1))
    want, want_cache = T.prefill(cfg, params, {"tokens": toks}, cache_len=50)
    before = (ssd_ops.SSD_COUNTER.launches, fa_ops.FLASH_COUNTER.launches)
    got, cache = T.prefill(cfg, _to(params, cuda), {"tokens": toks.to(cuda)},
                           cache_len=50)
    torch.cuda.synchronize()
    launched = (ssd_ops.SSD_COUNTER.launches - before[0],
                fa_ops.FLASH_COUNTER.launches - before[1])
    if cfg.arch_type == "hybrid":
        assert launched == (5, 2)
    else:
        assert launched == (0, cfg.n_layers)
    pairs = [(got, want)] + [(cache[k][leaf], want_cache[k][leaf])
                             for k in want_cache for leaf in want_cache[k]]
    for g, w in pairs:
        bound = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=bound)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_vlm_and_audio_prefill_on_the_card_match_cpu(cuda, arch):
    """The reduced llama-3.2-vision at 6 layers with cross_every 3 and
    d_vision 192 (kernel 8 in each of its 4 self layers) and the reduced
    whisper-tiny (kernel 8 in each of its 2 decoder layers, none in its
    encoder), every gate 0.5 + U(0, 1), prefilled on the card against
    the CPU prefill on the same weights, tokens and stub inputs: logits
    and every cache leaf, self and cross."""
    from repro_torch.configs import VLMSpec, get_config
    from repro_torch.models import transformer as T

    cfg = get_config(arch).reduced()
    if cfg.vlm:
        cfg = dataclasses.replace(cfg, n_layers=6, vlm=VLMSpec(
            cross_every=3, n_patches=16, d_vision=192))
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, device="cpu")
    gates = params["cross_blocks"]["gate"]
    gates.copy_(0.5 + torch.rand(gates.shape, generator=gen))
    key, shape = (("patches", (2, 16, 192)) if cfg.vlm
                  else ("frames", (2, cfg.encdec.n_frames, cfg.d_model)))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 45), generator=gen),
             key: 0.1 * torch.randn(shape, generator=gen)}
    want, want_cache = T.prefill(cfg, params, batch, cache_len=50)
    before = fa_ops.FLASH_COUNTER.launches
    got, cache = T.prefill(cfg, _to(params, cuda), _to(batch, cuda),
                           cache_len=50)
    torch.cuda.synchronize()
    assert fa_ops.FLASH_COUNTER.launches - before == (4 if cfg.vlm else 2)
    pairs = [(got, want)] + [(cache[k][leaf], want_cache[k][leaf])
                             for k in want_cache for leaf in want_cache[k]]
    assert len(pairs) == 5
    for g, w in pairs:
        bound = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=bound)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# (B, Hq, Hkv, S, D): the shapes of tests/test_kernels.py (R = 1), the
# shapes of chip_smoke.py's check (the serving shape of granite-8b, a
# 2048-token prefill, its 100- and 1537-token prompts, the reduced
# granite's D 64 and R 2, R = 1 and R = 3 at D 128), R = 3 at D 64,
# R = 4 with one key/value head, one token, and a D that is no multiple
# of 16; S one off the edges of the kernel's 64-row query and 64-key
# tiles (127, 128, 129, 2049), and D of 70 (no multiple of 4: the
# kernel's 4-byte copies) and 72 (9 column tiles of 8: its run-time
# column count); the 2048-token prefills of zamba2-1.2b (32 heads of 64,
# one per key/value head) and mistral-large-123b (96 heads, 12 per
# key/value head, of 128), and whisper-tiny's 440-token decoder prefill
# (6 heads of 64, one per key/value head)
FLASH_SHAPES = [(1, 2, 2, 64, 16), (2, 4, 4, 128, 32), (1, 1, 1, 256, 64),
                (1, 2, 2, 96, 16), (1, 32, 8, 2048, 128),
                (1, 32, 8, 100, 128), (1, 32, 8, 1537, 128),
                (2, 4, 2, 77, 64), (1, 8, 8, 300, 128), (1, 12, 4, 257, 128),
                (1, 6, 2, 200, 64), (1, 4, 1, 33, 128), (1, 3, 3, 1, 8),
                (1, 2, 1, 70, 40), (1, 8, 2, 127, 128), (1, 8, 2, 128, 128),
                (1, 8, 2, 129, 128), (1, 8, 2, 2049, 128), (2, 4, 2, 150, 70),
                (1, 6, 3, 193, 72), (1, 32, 32, 2048, 64),
                (1, 96, 8, 2048, 128), (1, 6, 6, 440, 64)]


def _flash_operands(gen, cuda, B, Hq, Hkv, S, D):
    return tuple(torch.randn((B, h, S, D), generator=gen, device=cuda)
                 for h in (Hq, Hkv, Hkv))


def _hold_flash(q, k, v):
    """Kernel 8 and its plain version both within the float64 bound,
    within rtol 2e-4 / atol 2e-4 of each other, two launches counted and
    bit-identical."""
    before = fa_ops.FLASH_COUNTER.launches
    got = fa_ops.causal_attention(q, k, v)
    again = fa_ops.causal_attention(q, k, v)
    plain = fa_ref.causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.FLASH_COUNTER.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=2e-4)
    o64, bound = fa_ref.float64_reference_and_bound(q, k, v)
    for out in (got, plain):
        assert bool(((out.double() - o64).abs() <= bound).all())


@pytest.mark.parametrize("B,Hq,Hkv,S,D", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, B, Hq, Hkv, S, D):
    """Kernel 8 and its plain version both within the derived float32
    rounding bound of the float64 value
    (`kernels.flash_attn.ref.float64_reference_and_bound`), within rtol
    2e-4 / atol 2e-4 of each other (`tests/test_kernels.py`), and two
    launches bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(B + Hq + S + D)
    _hold_flash(*_flash_operands(gen, cuda, B, Hq, Hkv, S, D))


def _misaligned(t):
    """`t`'s values in a view whose base sits 4 bytes past a 16-byte
    boundary (the row strides unchanged)."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _wide_rows(t):
    """`t`'s values in a view with one unused float after each row (an odd
    row stride)."""
    out = torch.zeros((*t.shape[:-1], t.shape[-1] + 1), device=t.device,
                      dtype=t.dtype)[..., :-1]
    out.copy_(t)
    return out


# (layout, B, Hq, Hkv, S, D): views that take the 4-byte copies (the
# run-time-D instance) at a D the 16-byte ones would take (a base off a
# 16-byte boundary, an odd row stride), so the D = 128 and D = 64
# instances are held `torch.equal` to it, the latter at every D = 64 shape
# of chip_smoke.py's FLASH_CASES (the reduced configs', zamba2-1.2b's and
# whisper-tiny's); and q and k scaled x6, so that scores reach ~100, at
# the serving shape, at D = 64 and at D = 16
FLASH_LAYOUTS = [("misaligned", 1, 4, 2, 129, 72),
                 ("misaligned", 1, 8, 2, 300, 128),
                 ("misaligned", 1, 32, 8, 2048, 128),
                 ("misaligned", 2, 4, 2, 77, 64),
                 ("misaligned", 1, 32, 32, 2048, 64),
                 ("misaligned", 1, 6, 6, 440, 64),
                 ("wide rows", 2, 4, 2, 100, 64),
                 ("x6", 1, 32, 8, 2048, 128), ("x6", 1, 4, 1, 257, 64),
                 ("x6", 1, 3, 3, 129, 16)]


@pytest.mark.parametrize("layout,B,Hq,Hkv,S,D", FLASH_LAYOUTS)
def test_flash_kernel_on_views_and_large_scores(cuda, layout, B, Hq, Hkv,
                                                S, D):
    """The holds of `test_flash_kernel_matches_plain` on strided views
    (read in place, no copy: the output is also checked bit for bit
    against contiguous operands) and on scores of magnitude ~100, where
    the 3xTF32 split's error shows."""
    gen = torch.Generator(device=cuda).manual_seed(B + Hq + S + D + 1)
    q, k, v = _flash_operands(gen, cuda, B, Hq, Hkv, S, D)
    if layout == "x6":
        q, k = 6 * q, 6 * k
        assert float((q[0, 0] @ k[0, 0].T).abs().max()) / D ** 0.5 > 50
        _hold_flash(q, k, v)
        return
    view = _misaligned if layout == "misaligned" else _wide_rows
    views = [view(t) for t in (q, k, v)]
    assert views[0].data_ptr() % 16 or views[0].stride(2) % 4
    _hold_flash(*views)
    assert torch.equal(fa_ops.causal_attention(*views),
                       fa_ops.causal_attention(q, k, v))


def test_flash_kernel_reads_the_model_layout_in_place(cuda):
    """Transposed views of (B, S, H, D) projections give the result of
    contiguous operands bit for bit, and the output has q's strides."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    qm, km, vm = (torch.randn((2, 45, h, 64), generator=gen, device=cuda)
                  for h in (8, 2, 2))
    views = [t.transpose(1, 2) for t in (qm, km, vm)]
    got = fa_ops.causal_attention(*views)
    want = fa_ops.causal_attention(*(t.contiguous() for t in views))
    assert got.stride() == views[0].stride()
    assert torch.equal(got, want)


def test_flash_kernel_checks_operands(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _flash_operands(gen, cuda, 1, 4, 2, 16, 32)
    n = fa_ops.FLASH_COUNTER.launches
    with pytest.raises(ValueError, match="exceeds"):
        fa_ops.causal_attention(*_flash_operands(gen, cuda, 1, 2, 1, 8, 136))
    with pytest.raises(ValueError, match="do not divide"):
        fa_ops.causal_attention(q, k[:, :1].expand(1, 3, 16, 32).clone(),
                                v[:, :1].expand(1, 3, 16, 32).clone())
    assert fa_ops.FLASH_COUNTER.launches == n
    # bf16 operands are upcast exactly, as the Pallas kernel does on load
    got = fa_ops.causal_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    want = fa_ops.causal_attention(q.bfloat16().float(), k.bfloat16().float(),
                                   v.bfloat16().float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


# kernel 8's short instances (S <= 64, D = 128 or 64, 16-byte copies):
# (B, Hq, Hkv, S, D) over the sequence lengths at and around the 16-row
# warp tile and the 32- and 64-key tiles, 1 to 12 query heads a key/value
# head (packed rows of two heads in one warp tile, a ragged last chunk)
SHORT_FLASH_SHAPES = [(2, 2 * rep, 2, s, d) for d in (64, 128)
                      for s in (1, 15, 16, 33, 63, 64)
                      for rep in (1, 2, 4, 8, 12)]
PROBE_FLASH_SHAPE = (768, 32, 8, 32, 128)


def _longer(t, extra):
    """`t` (B, H, S, D) with `extra` more N(0, 1) rows after its S."""
    tail = torch.randn((*t.shape[:2], extra, t.shape[3]), device=t.device,
                       generator=torch.Generator(t.device).manual_seed(9))
    return torch.cat([t, tail], 2)


def _instances_launched(fn, *args):
    """fn(*args) and the kernel-8 instances it launched, by the counter's
    record (`FLASH_COUNTER.tiles`)."""
    before = dict(fa_ops.FLASH_COUNTER.tiles)
    out = fn(*args)
    names = [fa_ops.INSTANCES[key[0]]
             for key, n in fa_ops.FLASH_COUNTER.tiles.items()
             for _ in range(n - before.get(key, 0))]
    return out, names


def _equal_to_the_long_instance(q, k, v, got):
    """`got`, a short instance's result, against the D = 128 or D = 64
    instance on the same rows: the operands extended to S + 65 rows take
    it, and a row's causal result reads no later key, so its first S
    rows must be `got` bit for bit."""
    S, D = q.shape[2:]
    long_ops = [_longer(t, 65) for t in (q, k, v)]
    assert fa_ops.instance(D, s=S + 65) in ("D = 128", "D = 64")
    assert torch.equal(fa_ops.causal_attention(*long_ops)[:, :, :S], got)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", SHORT_FLASH_SHAPES)
def test_short_flash_instance_at_its_edges(cuda, B, Hq, Hkv, S, D):
    """The short instances within the float64 bound, within rtol 2e-4 of
    the plain version and bit-identical across two launches; `torch.equal`
    to the D = 128 / D = 64 instance on the same rows and to the run-time-D
    instance, which a misaligned view takes."""
    assert fa_ops.instance(D, s=S).startswith("short")
    assert fa_ops.instance(D, aligned=False, s=S) == "run-time D"
    gen = torch.Generator(device=cuda).manual_seed(B + Hq + S + D)
    q, k, v = _flash_operands(gen, cuda, B, Hq, Hkv, S, D)
    _hold_flash(q, k, v)
    got, names = _instances_launched(fa_ops.causal_attention, q, k, v)
    assert names == [fa_ops.instance(D, s=S)]
    _equal_to_the_long_instance(q, k, v, got)
    views = [_misaligned(t) for t in (q, k, v)]
    out, names = _instances_launched(fa_ops.causal_attention, *views)
    assert names == ["run-time D"] and torch.equal(out, got)


def test_short_flash_instance_at_the_probe_shape(cuda):
    """The coded-head probe's backbone shape, (768, 32, 8, 32, 128), in the
    model's layout (transposed views of (B, S, H, D) projections, read in
    place): within the float64 bound and rtol 2e-4 of plain, two launches
    bit-identical, the output with q's strides, and `torch.equal` to the
    D = 128 instance on the same rows (contiguous operands give the same
    bits)."""
    B, Hq, Hkv, S, D = PROBE_FLASH_SHAPE
    assert fa_ops.instance(D, s=S) == "short, D = 128, 32 keys"
    gen = torch.Generator(device=cuda).manual_seed(31)
    qm, km, vm = (torch.randn((B, S, h, D), generator=gen, device=cuda)
                  for h in (Hq, Hkv, Hkv))
    views = [t.transpose(1, 2) for t in (qm, km, vm)]
    _hold_flash(*views)
    got, names = _instances_launched(fa_ops.causal_attention, *views)
    assert names == ["short, D = 128, 32 keys"]
    assert got.stride() == views[0].stride()
    contiguous = [t.contiguous() for t in views]
    assert torch.equal(fa_ops.causal_attention(*contiguous), got)
    _equal_to_the_long_instance(*contiguous, got)


def test_dense_prefill_on_the_card_matches_cpu(cuda):
    """The reduced granite prefill through kernel 8 (one launch per layer)
    against the CPU prefill on the same weights and tokens, logits and
    KV cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("granite-8b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params_gpu = _to(params, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 45),
                         generator=torch.Generator().manual_seed(1))
    want, want_cache = T.prefill(cfg, params, {"tokens": toks}, cache_len=50)
    before = fa_ops.FLASH_COUNTER.launches
    got, cache = T.prefill(cfg, params_gpu, {"tokens": toks.to(cuda)},
                           cache_len=50)
    torch.cuda.synchronize()
    assert fa_ops.FLASH_COUNTER.launches == before + cfg.n_layers
    for g, w in ((got, want), (cache["attn"]["k"], want_cache["attn"]["k"]),
                 (cache["attn"]["v"], want_cache["attn"]["v"])):
        bound = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=bound)


def test_optimized_prefills_on_the_card(cuda):
    """The settings of `launch.dryrun.optimize_config` on the card: the
    reduced zamba2 at 5 layers under `head_shard` launches kernels 7 and
    8 as without it (5 and 2) with logits `torch.equal`; the reduced
    granite with `attn_impl="repeat"` at a float32 softmax takes kernel 8
    in every layer, `torch.equal` to the grouped kernel prefill; its
    full-sequence forward with the bf16 softmax launches no kernel and
    lies within 2^-7 * max(1, max|logit|) of the same forward on the CPU
    (`tests/test_torch_launch.py`'s bound: float32 scores that differ in
    their last bit may round to bf16 values 2^-8 apart)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import optimize_config
    from repro_torch.models import transformer as T

    def launches():
        return (ssd_ops.SSD_COUNTER.launches, fa_ops.FLASH_COUNTER.launches)

    toks = torch.randint(0, 512, (2, 45),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks.to(cuda)}
    hyb = dataclasses.replace(get_config("zamba2-1.2b").reduced(), n_layers=5)
    params = _to(T.init_params(hyb, torch.Generator().manual_seed(0),
                               device="cpu"), cuda)
    base, _ = T.prefill(hyb, params, batch)
    before = launches()
    got, _ = T.prefill(optimize_config(hyb, "prefill"), params, batch)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(launches(), before)) == (5, 2)
    assert torch.equal(got, base)

    dense = get_config("granite-8b").reduced()
    cpu_params = T.init_params(dense, torch.Generator().manual_seed(0),
                               device="cpu")
    params = _to(cpu_params, cuda)
    base, _ = T.prefill(dense, params, batch)
    before = launches()
    got, _ = T.prefill(dataclasses.replace(dense, attn_impl="repeat"),
                       params, batch)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(launches(), before)) == (
        0, dense.n_layers)
    assert torch.equal(got, base)
    opt = optimize_config(dense, "train")
    assert opt.softmax_dtype == "bf16"
    before = launches()
    with torch.inference_mode():
        got, _ = T.forward_train(opt, params, batch, use_kernel=True)
    torch.cuda.synchronize()
    assert launches() == before
    want, _ = T.forward_train(opt, cpu_params, {"tokens": toks})
    bound = 2.0 ** -7 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want, rtol=2.0 ** -7, atol=bound)


def _sweep_sessions(cuda):
    from repro_torch.sim.network import paper_fleet

    fleet = paper_fleet(0.2, 0.2, seed=1, n=10, d=16)
    data = api.TrainData.linreg(0, 10, 64, 16, device=cuda)
    sessions = [api.Session(api.make_strategy("cfl", key_seed=k,
                                              fixed_c=fixed_c),
                            fleet, 0.05, 20, seed=k, device=cuda)
                for k, fixed_c in ((1, 192), (2, 192), (3, 40))]
    sessions += [api.Session(api.make_strategy("uncoded"), fleet, lr, 20,
                             seed=9, device=cuda) for lr in (0.05, 0.03)]
    return data, sessions


def test_run_sweep_on_the_card_equals_solo(cuda):
    """Lanes of three buckets (packed and dense CFL, uncoded): the batched
    plans equal the solo plans, and each lane's trace, clock and final
    beta equal its solo run, with one round-gradient launch per epoch."""
    data, sessions = _sweep_sessions(cuda)
    states = api.plan_sweep(sessions, data)
    before = rg_ops.COUNTER.launches
    reports = api.run_sweep(sessions, data, states=states)
    torch.cuda.synchronize()
    assert rg_ops.COUNTER.launches - before == 20 * len(sessions)
    for sess, state, rep in zip(sessions, states, reports):
        solo = sess.run(data, rng=np.random.default_rng(sess.seed))
        if hasattr(state, "plan"):
            plan = sess.plan(data).plan
            np.testing.assert_array_equal(state.plan.loads, plan.loads)
            assert state.plan.t_star == plan.t_star
            np.testing.assert_array_equal(state.plan.p_return,
                                          plan.p_return)
        for got, want in ((rep.nmse, solo.nmse), (rep.times, solo.times),
                          (rep.beta, solo.beta)):
            np.testing.assert_array_equal(got, want)
        assert np.all(np.isfinite(rep.nmse)) and rep.nmse[-1] < rep.nmse[0]


def test_fed_serve_on_the_card_is_a_solo_prefix(cuda):
    """The serving engine on the card: each served trace is its solo
    run's prefix up to its exit epoch, and kernel 1 launches once per
    epoch served."""
    from repro_torch.serving import ConvergenceCriterion, FedServeEngine

    data, sessions = _sweep_sessions(cuda)
    states = api.plan_sweep(sessions, data)
    engine = FedServeEngine(data, lane_width=2, chunk=6, device=cuda,
                            criterion=ConvergenceCriterion(nmse_target=0.5))
    before = rg_ops.COUNTER.launches
    reports = engine.serve(sessions, arrivals=[0.0, 1.0, 2.0, 3.0, 4.0],
                           states=states)
    torch.cuda.synchronize()
    exits = [rep.extras["serve_exit_epoch"] for rep in reports]
    assert rg_ops.COUNTER.launches - before == sum(exits)
    assert any(t < 20 for t in exits) and engine.n_groups == 3
    for sess, state, rep in zip(sessions, states, reports):
        solo = sess.run(data, rng=np.random.default_rng(sess.seed),
                        state=state)
        t = rep.extras["serve_exit_epoch"]
        np.testing.assert_array_equal(rep.nmse, solo.nmse[:t + 1])
        np.testing.assert_array_equal(rep.times, solo.times[:t + 1])


def test_lanes_and_shards_over_every_card_equal_one_card(cuda):
    """The lane and shard meshes over every local card: a sweep's and a
    serving engine's lanes and a fleet-scale plan equal the same calls on
    this one card (on a one-card machine the meshes have size 1)."""
    from repro_torch.fleet import solve_fleet
    from repro_torch.launch.mesh import local_devices
    from repro_torch.plan import PlanRequest
    from repro_torch.serving import FedServeEngine
    from repro_torch.sim.network import mega_fleet

    cards = local_devices(cuda)
    assert len(cards) == torch.cuda.device_count() and cards[0] == cuda
    data, sessions = _sweep_sessions(cuda)
    states = api.plan_sweep(sessions, data)
    for run in (lambda devs: api.run_sweep(sessions, data, states=states,
                                            devices=devs),
                lambda devs: FedServeEngine(data, lane_width=2, device=cuda,
                                            devices=devs).serve(
                    sessions, states=states)):
        for got, want in zip(run(cards), run([cuda])):
            np.testing.assert_array_equal(got.nmse, want.nmse)
            np.testing.assert_array_equal(got.beta, want.beta)
    fleet = mega_fleet(5000, d=16, seed=1)
    req = PlanRequest(edge=fleet.edge, server=fleet.server,
                      data_sizes=np.full(5000, 12), c_up=256)
    one = solve_fleet(req, chunk=512, device=cuda, devices=[cuda])
    many = solve_fleet(req, chunk=512, device=cuda, devices=cards)
    assert many.t_star == one.t_star and many.c == one.c
    np.testing.assert_array_equal(many.loads, one.loads)


def test_coded_head_probe_reduced_on_the_card_matches_cpu(cuda):
    """`coded_head_probe.run` at reduced width on the card against the
    CPU on the same weights and tokens: features within rtol 1e-4 / atol
    1e-4 * max|CPU| (kernel 8 against the plain backbone), and exactly
    the backbone's kernel-8 launches (one a layer), 12 encodes and 600
    round gradients at D = d_model."""
    from repro_torch import coded_head_probe as probe
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(probe.ARCH).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device=torch.device("cpu"))
    toks = torch.randint(0, cfg.vocab, (probe.N_CLIENTS, probe.ELL,
                                        probe.SEQ),
                         generator=torch.Generator().manual_seed(1))
    want = probe.run(reduced=True, device="cpu", params=params, tokens=toks)
    counters = (fa_ops.FLASH_COUNTER, enc_ops.COUNTER, rg_ops.COUNTER)
    before = [c.launches for c in counters]
    got = probe.run(reduced=True, device=cuda,
                    params=_to_card(params, cuda),
                    tokens=toks.to(cuda))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [cfg.n_layers, probe.N_CLIENTS, 2 * probe.EPOCHS]
    top = float(want["backbone_feats"].abs().max())
    torch.testing.assert_close(got["backbone_feats"].cpu(),
                               want["backbone_feats"], rtol=1e-4,
                               atol=1e-4 * max(1.0, top))
    for rep in got["reports"].values():
        assert np.all(np.isfinite(rep.nmse)) and rep.nmse[-1] < rep.nmse[0]


def _to_card(tree_, cuda):
    return {k: _to_card(v, cuda) if isinstance(v, dict) else v.to(cuda)
            for k, v in tree_.items()}


def _train_leaves(params):
    from repro_torch import tree
    return tree.leaves(params)


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-1.3b"])
def test_train_steps_on_the_card_match_cpu(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import sgd

    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = next(token_batches(0, 4, 40, cfg.vocab, device="cpu"))
    w = torch.tensor([0.0, 1.5, 1.0, 2.0])
    counters = [rg_ops.COUNTER, rg_ops.CODED_COUNTER, rg_ops.TIER_COUNTER,
                rg_ops.LSQ_COUNTER, enc_ops.COUNTER, enc_ops.PRNG_COUNTER,
                ssd_ops.SSD_COUNTER, fa_ops.FLASH_COUNTER]
    before = [c.launches for c in counters]
    fed_grad = steps.make_fed_grad_fn(cfg)

    def losses_and_grads(p, b, w_):
        loss, _, grads = steps.value_and_grad(
            lambda q: T.loss_fn(cfg, q, b), p)
        return [(loss, grads), fed_grad(p, b, w_)]

    want = losses_and_grads(params, batch, w)
    got = losses_and_grads(_to(params, cuda), _to(batch, cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    for (got_loss, got_grads), (want_loss, want_grads) in zip(got, want):
        torch.testing.assert_close(got_loss.cpu(), want_loss, rtol=1e-5,
                                   atol=0)
        for g, ref in zip(_train_leaves(got_grads),
                          _train_leaves(want_grads)):
            torch.testing.assert_close(
                g.cpu(), ref, rtol=1e-4,
                atol=1e-6 * max(1.0, float(ref.abs().max())))
    # the steps themselves, on the card
    p_gpu = _to(params, cuda)
    _, st, m = steps.make_train_step(cfg, sgd(0.1), compute_dtype=torch.float32,
                                     remat=False)(p_gpu, sgd(0.1).init(p_gpu),
                                                  _to(batch, cuda))
    _, st, fm = steps.make_fed_train_step(cfg, sgd(0.1))(
        p_gpu, st, _to(batch, cuda), w.to(cuda))
    assert int(st.step) == 2 and st.step.device == cuda
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(fm["loss"]))
    assert [c.launches for c in counters] == before


def _grad_calls(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    x, y, w, beta = rand(40, 8), rand(40), rand(40).abs(), rand(8)
    key = prng.prng_key(1)
    return {
        "masked_round_gradient": (rg_ops.COUNTER, lambda g: (
            rg_ops.masked_round_gradient(x, y, w, g(beta)))),
        "coded_round_gradient": (rg_ops.CODED_COUNTER, lambda g: (
            rg_ops.coded_round_gradient(x, y, w, g(x[:6]), y[:6], 0.5,
                                        beta))),
        "tier_masked_round_gradient": (rg_ops.TIER_COUNTER, lambda g: (
            rg_ops.tier_masked_round_gradient(g(x), y, w,
                                              torch.ones((2, 40),
                                                         device=cuda),
                                              beta))),
        "lsq_gradient": (rg_ops.LSQ_COUNTER, lambda g: (
            rg_ops.lsq_gradient(x, g(y), beta))),
        "encode_parity": (enc_ops.COUNTER, lambda g: (
            enc_ops.encode_parity(rand(6, 40), g(w), x))),
        "encode_parity_prng": (enc_ops.PRNG_COUNTER, lambda g: (
            enc_ops.encode_parity_prng(key, w, g(x), 6))),
        "ssd_chunk": (ssd_ops.SSD_COUNTER, lambda g: ssd_ops.ssd_chunk(
            g(rand(1, 2, 16, 4, 8)), rand(1, 2, 16, 4).abs(),
            -rand(1, 2, 16, 4).abs(), rand(1, 2, 16, 1, 8),
            rand(1, 2, 16, 1, 8))),
        "causal_attention": (fa_ops.FLASH_COUNTER, lambda g: (
            fa_ops.causal_attention(g(rand(1, 4, 24, 16)),
                                    rand(1, 2, 24, 16),
                                    rand(1, 2, 24, 16)))),
    }


@pytest.mark.parametrize("name", ["masked_round_gradient",
                                  "coded_round_gradient",
                                  "tier_masked_round_gradient",
                                  "lsq_gradient", "encode_parity",
                                  "encode_parity_prng", "ssd_chunk",
                                  "causal_attention"])
def test_kernel_wrappers_refuse_grad_on_the_card(cuda, name):
    """A CUDA operand that requires grad is refused before any launch (the
    kernels have no backward); the same call without grad launches."""
    counter, call = _grad_calls(cuda)[name]
    before = counter.launches
    with pytest.raises(RuntimeError, match="has no backward"):
        call(lambda t: t.clone().requires_grad_())
    assert counter.launches == before
    call(lambda t: t)
    with torch.no_grad():
        call(lambda t: t.clone().requires_grad_())
    torch.cuda.synchronize()
    assert counter.launches == before + 2


# -- tiles and the tune cache ----------------------------------------------

@pytest.fixture
def tile_cache(tmp_path, monkeypatch):
    """The user tile cache in a fresh directory (the committed defaults
    are still read behind it)."""
    from repro_torch.tune import cache as tune_cache

    monkeypatch.setenv(tune_cache.CACHE_ENV, str(tmp_path))
    return tune_cache.TileCache(tune_cache.user_cache_path())


def test_library_partition_and_tiles_match_the_mirrors(cuda):
    """The kernels' own row partition, as the library reports it, equals
    the Python mirror that the families and the roofline read; kernel 2's
    library launches every tile of the mirror `TILES` and refuses a tile
    it does not instantiate."""
    lib = rg_ops._dispatch(cuda)
    for m in list(range(1, 3000, 7)) + [5632, 7200, 9216, 100_000]:
        assert lib.rg_num_ctas(m) == -(-m // rg_ops.rows_per_cta(m)), m
    enc = enc_ops._dispatch(cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    c, ell, d = 200, 64, 96
    g = torch.randn((c, ell), generator=gen, device=cuda)
    w = torch.rand((ell,), generator=gen, device=cuda)
    x = torch.randn((ell, d), generator=gen, device=cuda)
    want = enc_ref.encode_parity(g, w, x)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def launch(tile):
        out = torch.full((c, d), float("nan"), device=cuda)
        status = enc.enc_encode_parity(g.data_ptr(), w.data_ptr(),
                                       x.data_ptr(), out.data_ptr(), c, ell,
                                       d, *tile, stream)
        return status, out

    for tile in enc_ops.TILES:
        status, out = launch(tile)
        assert status == 0, tile
        torch.testing.assert_close(out, want, rtol=2e-4,
                                   atol=2e-4 * float(want.abs().max()))
    for tile in [(32, 64, 32), (128, 64, 16), (256, 64, 32)]:
        assert launch(tile)[0] != 0, tile


@pytest.mark.parametrize("m,d", [(5632, 500), (37, 13), (700, 2999)])
def test_every_row_tile_within_the_bound(cuda, m, d):
    """Kernels 1, 4 and 5 at every "round_grad" candidate and kernel 6 at
    every "coded_grad" candidate (ragged against 8-row tiles and 512
    columns, and the 4-byte copy instance at D = 2999)."""
    from repro_torch.tune.families import FAMILIES

    gen = torch.Generator(device=cuda).manual_seed(m + d)
    x, y, w = _rg_operands(gen, cuda, m, d, "zero_rows")
    beta = torch.randn((d,), generator=gen, device=cuda)
    c = max(1, m // 3)
    xp = torch.randn((c, d), generator=gen, device=cuda)
    yp = torch.randn((c,), generator=gen, device=cuda)
    masks = (torch.rand((3, m), generator=gen, device=cuda) < 0.5).float()
    for (tile,) in FAMILIES["round_grad"].candidate_blocks((m, d),
                                                           "cuda-sm90"):
        flat = rg_ops.masked_round_gradient(x, y, w, beta, block_m=tile)
        again = rg_ops.masked_round_gradient(x, y, w, beta, block_m=tile)
        coded = rg_ops.coded_round_gradient(x, y, w, xp, yp, 0.5, beta,
                                            block_m=tile)
        tier = rg_ops.tier_masked_round_gradient(x, y, w, masks, beta,
                                                 block_m=tile)
        one = rg_ops.tier_masked_round_gradient(
            x, y, w, torch.ones((1, m), device=cuda), beta, block_m=tile)
        torch.cuda.synchronize()
        _held_to_float64(f"flat {tile}", flat, x, y, w, beta)
        _held_to_float64(f"coded {tile}", coded, torch.cat([x, xp]),
                         torch.cat([y, yp]),
                         torch.cat([w, torch.full((c,), 0.5, device=cuda)]),
                         beta)
        _held_to_float64(f"tier {tile}", tier, x, y, w, beta, masks)
        assert torch.equal(flat, again) and torch.equal(one[0], flat)
    for (tile,) in FAMILIES["coded_grad"].candidate_blocks((m, d),
                                                           "cuda-sm90"):
        got = cg_ops.lsq_gradient(x, y, beta, block_m=tile)
        flat = rg_ops.masked_round_gradient(x, y, None, beta, block_m=tile)
        torch.cuda.synchronize()
        _held_to_float64(f"lsq {tile}", got, x, y, None, beta)
        assert torch.equal(got, flat)


@pytest.mark.parametrize("c,ell,d", [(2016, 300, 501), (359, 100, 257),
                                     (131, 37, 67), (2160, 300, 513)])
def test_every_encode_tile_within_the_bound(cuda, c, ell, d):
    """Kernel 2 at every candidate CTA tile: 2e-4 * max|ref| of the plain
    version, the float64 bound, relaunches bit-identical."""
    from repro_torch.tune.families import FAMILIES

    gen = torch.Generator(device=cuda).manual_seed(c + ell + d)
    g = torch.randn((c, ell), generator=gen, device=cuda)
    w = torch.rand((ell,), generator=gen, device=cuda)
    x = torch.randn((ell, d), generator=gen, device=cuda)
    want = enc_ref.encode_parity(g, w, x)
    p64, bound64 = enc_ops.float64_reference_and_bound(g, w, x)
    tiles = FAMILIES["encode"].candidate_blocks((c, ell, d), "cuda-sm90")
    assert tiles == list(enc_ops.TILES)
    for tile in tiles:
        got = enc_ops.encode_parity(g, w, x, block=tile)
        again = enc_ops.encode_parity(g, w, x, block=tile)
        torch.cuda.synchronize()
        bound = 2e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=2e-4, atol=bound)
        err = (got.double() - p64).abs()
        assert bool((err <= bound64).all()), \
            f"{tile}: max err/bound {float((err / bound64).max()):.3g}"
        assert torch.equal(got, again)


def test_encode_prng_tile_within_the_bound(cuda, tile_cache):
    """Kernel 3 at its one tile, explicit and "auto"; "auto" reads no
    cache (a stored entry under "encode_prng" is not launched)."""
    c, ell, d = 2016, 300, 501
    gen = torch.Generator(device=cuda).manual_seed(3)
    key = prng.prng_key(3)
    w = torch.rand((ell,), generator=gen, device=cuda)
    x = torch.randn((ell, d), generator=gen, device=cuda)
    tile_cache.store("encode_prng", (c, ell, d), "cuda-sm90", (64, 512, 32))
    enc_ops.PRNG_COUNTER.reset()
    got = enc_ops.encode_parity_prng(key, w, x, c, block=enc_ops.PRNG_BLOCK)
    auto = enc_ops.encode_parity_prng(key, w, x, c)
    assert enc_ops.PRNG_COUNTER.tiles == {enc_ops.PRNG_BLOCK: 2}
    g = prng.generator_values(key, c, ell, "normal", device=cuda)
    p64, bound64 = enc_ops.float64_reference_and_bound(g, w, x)
    torch.cuda.synchronize()
    assert torch.equal(got, auto)
    err = (got.double() - p64).abs()
    assert bool((err <= bound64).all())
    with pytest.raises(ValueError, match="one tile"):
        enc_ops.encode_parity_prng(key, w, x, c, block=(64, 512, 32))


def _tile_calls(cuda, m=3000, c=2900, d=500):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x, y, w = _rg_operands(gen, cuda, m, d, "random")
    beta = torch.randn((d,), generator=gen, device=cuda)
    xp = torch.randn((c, d), generator=gen, device=cuda)
    yp = torch.randn((c,), generator=gen, device=cuda)
    masks = (torch.rand((3, m), generator=gen, device=cuda) < 0.5).float()
    g = torch.randn((1000, 300), generator=gen, device=cuda)
    we = torch.rand((300,), generator=gen, device=cuda)
    xe = torch.randn((300, 501), generator=gen, device=cuda)
    key = prng.prng_key(4)
    # {kernel: (family, shape, counter, call of block)}
    return {
        "flat": ("round_grad", (m, d), rg_ops.COUNTER,
                 lambda b: rg_ops.masked_round_gradient(x, y, w, beta,
                                                        block_m=b)),
        "coded": ("round_grad", (m, d), rg_ops.CODED_COUNTER,
                  lambda b: rg_ops.coded_round_gradient(
                      x, y, w, xp, yp, 0.5, beta, block_m=b)),
        "tier": ("round_grad", (m, d), rg_ops.TIER_COUNTER,
                 lambda b: rg_ops.tier_masked_round_gradient(
                     x, y, w, masks, beta, block_m=b)),
        "lsq": ("coded_grad", (m, d), rg_ops.LSQ_COUNTER,
                lambda b: rg_ops.lsq_gradient(x, y, beta, block_m=b)),
        "encode": ("encode", (1000, 300, 501), enc_ops.COUNTER,
                   lambda b: enc_ops.encode_parity(g, we, xe, block=b)),
        "encode_prng": ("encode_prng", (1000, 300, 501),
                        enc_ops.PRNG_COUNTER,
                        lambda b: enc_ops.encode_parity_prng(
                            key, we, xe, 1000, block=b)),
    }


@pytest.mark.parametrize("kernel", ["flat", "coded", "tier", "lsq",
                                    "encode", "encode_prng"])
def test_cold_miss_is_the_default_tile(cuda, tile_cache, kernel):
    """At a shape whose bucket no cache holds, "auto" launches the
    kernel's default (the round gradients' own partition, 24 rows a CTA
    for both 3000 and 2900 rows), `torch.equal` to the explicit tile."""
    from repro_torch.tune import cache as tune_cache
    from repro_torch.tune.families import FAMILIES

    family, shape, counter, call = _tile_calls(cuda)[kernel]
    assert tune_cache.lookup_entry(family, shape, "cuda-sm90") is None
    default = enc_ops.PRNG_BLOCK if family == "encode_prng" \
        else FAMILIES[family].default_block(shape)
    if family in ("round_grad", "coded_grad"):  # (0,): the rows it gives
        assert default == (0,)
        default = (rg_ops.rows_per_cta(shape[0]),)
    counter.reset()
    cold = call("auto")
    explicit = call(default if len(default) > 1 else default[0])
    torch.cuda.synchronize()
    assert torch.equal(cold, explicit)
    assert counter.launches == 2
    if family in ("round_grad", "coded_grad"):
        assert counter.tiles == {(0,): 1, default: 1}


@pytest.mark.parametrize("kernel,tile", [
    ("flat", (64,)), ("coded", (16,)), ("tier", (128,)), ("lsq", (32,)),
    ("encode", (64, 128, 32))])
def test_cache_hit_launches_the_stored_tile(cuda, tile_cache, kernel, tile):
    family, shape, counter, call = _tile_calls(cuda)[kernel]
    tile_cache.store(family, shape, "cuda-sm90", tile)
    counter.reset()
    got = call("auto")
    assert counter.tiles == {tile: 1}
    explicit = call(tile if len(tile) > 1 else tile[0])
    torch.cuda.synchronize()
    assert torch.equal(got, explicit)


def test_keyed_encode_fleet_on_the_card(cuda):
    """`encode_fleet` (kernel 2 once per client, G_i from the clients'
    seeds) within 2e-4 * max|ref| of the plain streamed encode with the
    same G_i."""
    from repro_torch.core.encoding import (encode_fleet_streamed,
                                           generator_matrix)

    n, ell, d, c = 5, 40, 33, 70
    gen = torch.Generator(device=cuda).manual_seed(8)
    xs = torch.randn((n, ell, d), generator=gen, device=cuda)
    ys = torch.randn((n, ell), generator=gen, device=cuda)
    ws = torch.rand((n, ell), generator=gen, device=cuda)
    seeds = [11 * i + 1 for i in range(n)]
    before = enc_ops.COUNTER.launches
    got = torch.cat([t.reshape(c, -1) for t in
                     enc_ops.encode_fleet(seeds, xs, ys, ws, c)], dim=1)
    assert enc_ops.COUNTER.launches == before + n

    def g_source(i):
        g_i = torch.Generator(device=cuda).manual_seed(seeds[i])
        return generator_matrix(g_i, c, ell)

    want = torch.cat([t.reshape(c, -1) for t in encode_fleet_streamed(
        g_source, xs, ys, ws, c, enc_ref.encode_parity)], dim=1)
    torch.testing.assert_close(got, want, rtol=2e-4,
                               atol=2e-4 * float(want.abs().max()))


def test_tune_cli_writes_a_card_entry(cuda, tile_cache):
    """`python -m repro_torch.tune --family round_grad --shape 5632x500`
    tunes on the card and stores a `cuda-sm90` entry naming the card."""
    from repro_torch.tune import __main__ as cli

    assert cli.main(["--family", "round_grad", "--shape", "5632x500",
                     "--iters", "5"]) == 0
    ent = tile_cache.lookup("round_grad", (5632, 500), "cuda-sm90")
    assert ent is not None and ent["source"] == "measured"
    assert ent["bound_us"] > 0 and ent["us"] > 0
    assert ent["device"] and ent["device"] != "cpu"
