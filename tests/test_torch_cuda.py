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
    Two launches must also be bit-identical: the cross-CTA reduction has
    a fixed order.
    The coded and tier-masked kernels are held the same way, each tier
    partial and the coded sum against their float64 expressions with S
    summed over the rows that enter them.  The tier kernel at T = 1 with
    an all-ones mask must be bit-equal (`torch.equal`) to the flat
    kernel on the same operands.
  * encode: 2e-4 * max|ref|, as in `tests/test_torch_kernels.py`.
  * in-kernel-generator encode: the generator itself, exposed with
    X = I and w = 1, Rademacher entries `torch.equal` to the plain
    `prng.generator_values` on the card, normal entries within rtol 1e-6
    / atol 1e-7 (both evaluate Giles' float32 erfinv operation by
    operation; `log1pf` may differ from torch's `log1p` by an ulp); the
    product within 2e-4 * max|ref|; relaunches bit-identical; the fleet
    encoders' one-tier tiered run `torch.equal` to the flat one.
  * least-squares gradient: the float64 bound of the round gradient, and
    `torch.equal` to the flat kernel at w = None (the same instance).
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.cfl import CFLState
from repro_torch.fleet import FleetTopology, HierarchicalCFL, HierState
from repro_torch.device import resolve_device
from repro_torch.fleet import encode_fleet_tiered
from repro_torch.kernels.coded_grad import ops as cg_ops
from repro_torch.kernels.coded_grad import ref as cg_ref
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import prng
from repro_torch.kernels.encode import ref as enc_ref
from repro_torch.kernels.round_grad import ops as rg_ops
from repro_torch.kernels.round_grad import ref as rg_ref
from repro_torch.schemes import StochasticCodedFL, StochasticState
from repro_torch.sim.network import make_fleet

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


@pytest.mark.parametrize("m,d", [(1, 1), (7, 5), (37, 13), (5632, 500),
                                 (7200, 500), (9, 3000)])
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


@pytest.mark.parametrize("c,ell,d", [(1, 1, 1), (5, 7, 3), (130, 17, 65),
                                     (2016, 300, 501)])
def test_encode_kernel_matches_plain(cuda, c, ell, d):
    gen = torch.Generator(device=cuda).manual_seed(c + ell + d)
    g = torch.randn((c, ell), generator=gen, device=cuda)
    w = torch.rand((ell,), generator=gen, device=cuda)
    x = torch.randn((ell, d), generator=gen, device=cuda)
    got = enc_ops.encode_parity(g, w, x)
    want = enc_ref.encode_parity(g, w, x)
    torch.cuda.synchronize()
    bound = 2e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=bound)


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
    flat = rg_ops.masked_round_gradient(a, y, None, beta)
    torch.cuda.synchronize()
    assert (cg_ops.COUNTER.launches, rg_ops.COUNTER.launches) == \
        (before[0] + 2, before[1] + 1)
    assert torch.equal(got, again)
    assert torch.equal(got, flat)
    _held_to_float64("lsq kernel", got, a, y, None, beta)
    _held_to_float64("lsq plain", plain, a, y, None, beta)
