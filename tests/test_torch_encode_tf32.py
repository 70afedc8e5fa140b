"""Kernel 2's 3xTF32 arithmetic, emulated on the CPU and held to its
float64 bound.

`csrc/encode.cu` forms P = G diag(w) X on the tensor cores: w x rounded
once to float32, each operand element split once into (big, small) TF32
words (`tf32::split`), and for each step of 8 along L the three products
small.big, big.small, big.big added to one float32 accumulator, each
tensor-core sum truncated (`test_torch_tf32.product3`, in float64 from
the split words).  That emulation is held to the bound stated before the
first card run, `ops.float64_reference_and_bound`: |P - P64| <= 1.01
(L + 20) u (|G| |diag(w) X|), u = 2^-24 (`-s` prints the share, the
proxy of the card's); the plain float32 version is held to it too, and
plain TF32 (big.big alone) is shown to fall outside it.  The emulation
also stays within the reference's 2e-4 * max|ref| of the plain version
(`tests/test_kernels.py`).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import ref as enc_ref
from test_torch_tf32 import product3


def _operands(c, ell, d, seed):
    """G ~ N(0, 1), w ~ U(0, 1), X ~ N(0, 1) (X's last column the labels,
    as the encode takes them), made with numpy."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((c, ell))
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(0.0, 1.0, ell).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((ell, d))
                             .astype(np.float32)))


def _emulate_kernel(g, w, x, split=True):
    """`encode_kernel`'s arithmetic: w x rounded once, then 3xTF32 (or,
    with split=False, plain TF32) products over steps of 8 along L."""
    wx = w[:, None] * x  # float32, rounded once
    return product3(g, wx, torch.zeros((g.shape[0], x.shape[1])), split)


def _share(p, p64, bound):
    return float(((p.double() - p64).abs() / bound).max())


# the §IV shape (C, L, D) = (2016, 300, 501), and ragged ones: C, L and D
# not multiples of the 128 x 64 tile, of the step 32 or of 8
SHAPES = [(2016, 300, 501), (131, 37, 67), (257, 9, 130), (5, 3, 1)]


@pytest.mark.parametrize("c,ell,d", SHAPES)
def test_kernel_arithmetic_within_the_float64_bound(c, ell, d):
    g, w, x = _operands(c, ell, d, seed=c + ell + d)
    p64, bound = enc_ops.float64_reference_and_bound(g, w, x)
    got = _emulate_kernel(g, w, x)
    plain = enc_ref.encode_parity(g, w, x)
    shares = {"kernel": _share(got, p64, bound),
              "plain": _share(plain, p64, bound)}
    print(f"emulated 3xTF32 kernel 2 at (C, L, D) = {(c, ell, d)}: worst "
          f"element at {shares['kernel']:.4f} (kernel) and "
          f"{shares['plain']:.4f} (plain float32) of the float64 bound")
    assert shares["kernel"] <= 1.0 and shares["plain"] <= 1.0
    atol = 2e-4 * float(plain.abs().max())
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=atol)


def test_plain_tf32_is_outside_the_float64_bound():
    """The bound tells the split from plain TF32 at the §IV shape: one
    TF32 product per float32 product lands outside it, 3xTF32 inside."""
    g, w, x = _operands(2016, 300, 501, seed=5)
    p64, bound = enc_ops.float64_reference_and_bound(g, w, x)
    shares = [_share(_emulate_kernel(g, w, x, split), p64, bound)
              for split in (False, True)]
    assert shares[0] > 1.0 > shares[1]


def test_bound_grows_with_the_summed_magnitudes():
    """The bound is (L + 20) u times |G| |diag(w) X|, entry by entry: it
    scales with the operands and is zero where a row of G is zero."""
    g, w, x = _operands(7, 11, 5, seed=1)
    g[3] = 0.0
    p64, bound = enc_ops.float64_reference_and_bound(g, w, x)
    want = 1.01 * 31 * 2.0 ** -24 * (g.double().abs()
                                     @ (w.double()[:, None]
                                        * x.double()).abs())
    torch.testing.assert_close(bound, want, rtol=1e-12, atol=0.0)
    assert bool((bound[3] == 0).all()) and bool((p64[3] == 0).all())
    _, twice = enc_ops.float64_reference_and_bound(2 * g, w, x)
    torch.testing.assert_close(twice, 2 * bound, rtol=1e-12, atol=0.0)
