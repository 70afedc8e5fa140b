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
  * encode: 2e-4 * max|ref|, as in `tests/test_torch_kernels.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.cfl import CFLState
from repro_torch.device import resolve_device
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import ref as enc_ref
from repro_torch.kernels.round_grad import ops as rg_ops
from repro_torch.kernels.round_grad import ref as rg_ref
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
