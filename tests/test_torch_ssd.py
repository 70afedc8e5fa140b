"""The port's Mamba2 SSD functions and the plain path of kernel 7 against
the JAX package, on the CPU.

The same NumPy inputs (from a seeded generator) go to both packages.
`repro.kernels.ssd.ops.ssd_chunk` runs its Pallas kernel in interpret
mode; on a CPU tensor the port's wrapper `kernels.ssd.ops.ssd_chunk`
computes its plain version, the arithmetic the CUDA kernel is held to on
the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).

Bounds:
  * the intra-chunk step (y_diag and states), `segsum`, `ssd_chunked`
    and `ssd_decode_step`: rtol 1e-4 and atol 1e-4 * max(1, max|ref|),
    the bound of `tests/test_kernels.py` — float32 contractions taken in
    another order, and the port's prefix sums of da accumulated in
    float64 where the reference's are float32 (at these inputs |cum|
    stays below ~60, so the reference's own rounding is ~1e-6);
  * at the model's own decay logs (dt = softplus(N(0, 1)), a = -linspace
    (1, 16, H), Q = 256, |cum| up to ~3e3) the float32 reference carries
    ~1e-3 relative error in the decays, so there the port is held against
    the float64 value of the function within the rounding bound derived
    in `kernels.ssd.ref.float64_reference_and_bound`;
  * the state after a padded tail, and `ssd_chunked` against the
    token-by-token recurrence of `ssd_decode_step`: rtol 1e-4 / atol
    1e-4 * max(1, max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as j_ssd_ops
from repro.models import ssm as j_ssm
from repro_torch.kernels.ssd import ops as t_ssd_ops
from repro_torch.kernels.ssd import ref as t_ssd_ref
from repro_torch.models import ssm as t_ssm


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _softplus(v):
    return np.log1p(np.exp(-np.abs(v))) + np.maximum(v, 0.0)


def _chunk_inputs(seed, B, nc, Q, H, P, N, G=None, model_da=False):
    """xc, dtc, da, bc, cc as float32 NumPy arrays; bc/cc per group when
    G is given (else per head, the reference's layout).  The synthetic da
    of `tests/test_kernels.py` is -0.1 |N(0, 1)|; `model_da` takes the
    model's own dt * a instead."""
    rng = np.random.default_rng(seed)
    G = H if G is None else G
    xc = rng.standard_normal((B, nc, Q, H, P))
    dtc = _softplus(rng.standard_normal((B, nc, Q, H)))
    if model_da:
        da = dtc * -np.linspace(1.0, 16.0, H)
    else:
        da = -np.abs(rng.standard_normal((B, nc, Q, H))) * 0.1
    bc = rng.standard_normal((B, nc, Q, G, N))
    cc = rng.standard_normal((B, nc, Q, G, N))
    return [a.astype(np.float32) for a in (xc, dtc, da, bc, cc)]


SHAPES = [(1, 1, 8, 1, 4, 4), (2, 3, 32, 4, 16, 8), (1, 2, 128, 2, 64, 32),
          (1, 2, 256, 2, 64, 128)]


@pytest.mark.parametrize("B,nc,Q,H,P,N", SHAPES)
@pytest.mark.parametrize("port", ["reference", "wrapper"])
def test_ssd_chunk_matches_jax(B, nc, Q, H, P, N, port):
    """The port's plain version and its wrapper on CPU tensors against the
    JAX reference and the Pallas kernel (interpret mode)."""
    ops = _chunk_inputs(B + Q + H, B, nc, Q, H, P, N)
    fn = (t_ssd_ref.ssd_chunk_reference if port == "reference"
          else t_ssd_ops.ssd_chunk)
    y, s = fn(*(torch.from_numpy(a) for a in ops))
    jops = [jnp.asarray(a) for a in ops]
    y_ref, s_ref = j_ssm.ssd_chunk_reference(*jops)
    y_pl, s_pl = j_ssd_ops.ssd_chunk(*jops)
    for got, want in ((y, y_ref), (s, s_ref), (y, y_pl), (s, s_pl)):
        _close(got, want)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunk_wrapper_takes_groups(G):
    """B and C per group give what their per-head copies give (the kernel
    indexes group h // (H / G) instead of reading the copies)."""
    xc, dtc, da, bc, cc = (torch.from_numpy(a) for a in
                           _chunk_inputs(3, 1, 2, 32, 4, 8, 16, G=G))
    rep = 4 // G
    y, s = t_ssd_ops.ssd_chunk(xc, dtc, da, bc, cc)
    y_h, s_h = t_ssd_ref.ssd_chunk_reference(
        xc, dtc, da, bc.repeat_interleave(rep, 3),
        cc.repeat_interleave(rep, 3))
    assert torch.equal(y, y_h) and torch.equal(s, s_h)


@pytest.mark.parametrize("Q,H", [(256, 8), (97, 4)])
def test_ssd_chunk_at_model_da_within_float64_bound(Q, H):
    """At the model's own decay logs the plain version stays within the
    derived rounding bound of the float64 value, y and states."""
    ops = [torch.from_numpy(a) for a in
           _chunk_inputs(11, 1, 2, Q, H, 16, 32, G=1, model_da=True)]
    cum = torch.cumsum(ops[2].double(), dim=2)
    assert float(cum.abs().max()) > 1e3  # the regime the bound is for
    y, s = t_ssd_ops.ssd_chunk(*ops)
    y64, s64, yb, sb = t_ssd_ref.float64_reference_and_bound(*ops)
    assert bool(((y.double() - y64).abs() <= yb).all())
    assert bool(((s.double() - s64).abs() <= sb).all())


def test_ssd_chunk_wrapper_rejects_mismatched_operands():
    xc, dtc, da, bc, cc = (torch.from_numpy(a) for a in
                           _chunk_inputs(0, 1, 1, 8, 3, 4, 4))
    with pytest.raises(ValueError, match="groups do not divide"):
        t_ssd_ops.ssd_chunk(xc, dtc, da, bc[..., :2, :], cc[..., :2, :])
    with pytest.raises(ValueError, match="dtc has shape"):
        t_ssd_ops.ssd_chunk(xc, dtc[:, :, :4], da, bc, cc)


@pytest.mark.parametrize("q", [1, 5, 16])
def test_segsum_matches_jax(q):
    a = (np.random.default_rng(q).standard_normal((2, 3, q)) * 0.5) \
        .astype(np.float32)
    got = t_ssm.segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(j_ssm.segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    _close(got[finite], want[finite])


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    got = t_ssm.causal_conv(*(torch.from_numpy(v) for v in (w, b, x)))
    _close(got, j_ssm.causal_conv(*(jnp.asarray(v) for v in (w, b, x))))


def _scan_inputs(seed, B, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = _softplus(rng.standard_normal((B, S, H)))
    a = -np.exp(rng.standard_normal(H))
    b = rng.standard_normal((B, S, G, N))
    c = rng.standard_normal((B, S, G, N))
    h0 = rng.standard_normal((B, H, P, N)) * 0.5
    return [v.astype(np.float32) for v in (x, dt, a, b, c, h0)]


@pytest.mark.parametrize("S", [16, 37, 64])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(S, use_kernel, with_h0):
    """Tail padding (S not a multiple of the chunk), two state groups and
    a carried-in state; the JAX side with its Pallas kernel in interpret
    mode where `use_kernel`."""
    x, dt, a, b, c, h0 = _scan_inputs(S, 2, S, 4, 8, 2, 16)
    h0_t = torch.from_numpy(h0) if with_h0 else None
    h0_j = jnp.asarray(h0) if with_h0 else None
    y, h = t_ssm.ssd_chunked(*(torch.from_numpy(v) for v in (x, dt, a, b, c)),
                             chunk=16, h0=h0_t, use_kernel=use_kernel)
    y_j, h_j = j_ssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                                 chunk=16, h0=h0_j, use_kernel=use_kernel)
    _close(y, y_j)
    _close(h, h_j)


@pytest.mark.parametrize("S", [20, 32])
def test_ssd_chunked_is_the_recurrence(S):
    """The chunked scan equals S steps of `ssd_decode_step` from h0: a
    padded tail (dt = 0) leaves the state unchanged."""
    x, dt, a, b, c, h0 = (torch.from_numpy(v)
                          for v in _scan_inputs(7, 1, S, 4, 8, 2, 16))
    y, h = t_ssm.ssd_chunked(x, dt, a, b, c, chunk=16, h0=h0)
    hs, ys = h0, []
    for t in range(S):
        yt, hs = t_ssm.ssd_decode_step(hs, x[:, t], dt[:, t], a, b[:, t],
                                       c[:, t])
        ys.append(yt)
    _close(y, torch.stack(ys, dim=1).numpy())
    _close(h, hs.numpy())


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(4)
    B, H, P, G, N = 3, 4, 8, 2, 16
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((B, H))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    b = rng.standard_normal((B, G, N)).astype(np.float32)
    c = rng.standard_normal((B, G, N)).astype(np.float32)
    y, hn = t_ssm.ssd_decode_step(*(torch.from_numpy(v)
                                    for v in (h, x, dt, a, b, c)))
    y_j, hn_j = j_ssm.ssd_decode_step(*(jnp.asarray(v)
                                        for v in (h, x, dt, a, b, c)))
    _close(y, y_j)
    _close(hn, hn_j)


def test_ssd_chunked_head_shard_is_not_ported():
    """`head_shard`, a mesh hint once refused, changes nothing: the scan
    with it is bit-equal to the scan without it, on both routes.  The
    name is the one the test had while `head_shard` raised."""
    x, dt, a, b, c, _ = (torch.from_numpy(v)
                         for v in _scan_inputs(0, 1, 16, 4, 8, 2, 16))
    for use_kernel in (True, False):
        with_hint = t_ssm.ssd_chunked(x, dt, a, b, c, chunk=16,
                                      use_kernel=use_kernel, head_shard=True)
        without = t_ssm.ssd_chunked(x, dt, a, b, c, chunk=16,
                                    use_kernel=use_kernel)
        assert all(torch.equal(u, v) for u, v in zip(with_hint, without))

