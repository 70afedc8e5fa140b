"""Kernel 3's 3xTF32 arithmetic, emulated on the CPU and held to its
float64 bound.

`csrc/encode.cu`'s `encode_prng_kernel` forms P = G diag(w) X on the
tensor cores with G hashed inside the kernel: each generator entry
scaled by w[k] and rounded once to float32 (diag(w) on the G side), each
operand element split once into (big, small) TF32 words (`tf32::split`),
and for each step of 8 along L the three products small.big, big.small,
big.big added to one float32 accumulator, each tensor-core sum truncated
(`test_torch_tf32.product3`, in float64 from the split words).  G is
`prng.generator_values`, the plain generator the kernel's entries equal
(Rademacher bit for bit, normal to within the last ulp of `log1pf`).

The emulation is held to the bound stated before the first card run,
`ops.float64_reference_and_bound`: |P - P64| <= 1.01 (L + 20) u (|G|
|diag(w) X|), u = 2^-24 (`-s` prints the share, the proxy of the
card's); plain TF32 (big.big alone) is shown to fall outside it.  The
emulation also stays within the reference's 2e-4 * max|ref| of the plain
`ref.encode_parity_prng`, and at X = I, w = 1 it returns G as the card
check holds it: Rademacher entries exactly, normal ones within rtol 1e-6
/ atol 1e-7 (big + small drops at most 2^-22 |g|).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import prng
from repro_torch.kernels.encode import ref as enc_ref
from test_torch_tf32 import product3


def _operands(c, ell, d, seed):
    """A key, w ~ U(0, 1) and X ~ N(0, 1), made with numpy."""
    rng = np.random.default_rng(seed)
    return (prng.prng_key(seed),
            torch.from_numpy(rng.uniform(0.0, 1.0, ell).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((ell, d))
                             .astype(np.float32)))


def _emulate_kernel(g, w, x, split=True):
    """`encode_prng_kernel`'s arithmetic on the generator g: g * w
    rounded once, then 3xTF32 (or, with split=False, plain TF32)
    products over steps of 8 along L."""
    gw = g * w[None, :]  # float32, rounded once
    return product3(gw, x, torch.zeros((g.shape[0], x.shape[1])), split)


def _share(p, p64, bound):
    return float(((p.double() - p64).abs() / bound).max())


# kernel 2's proxy shapes (the §IV shape and ragged ones) and the odd
# C * L of chip_smoke's second check
SHAPES = [(2016, 300, 501), (131, 37, 67), (257, 9, 130), (5, 3, 1),
          (2017, 299, 33)]


@pytest.mark.parametrize("kind", prng.KINDS)
@pytest.mark.parametrize("c,ell,d", SHAPES)
def test_kernel_arithmetic_within_the_float64_bound(c, ell, d, kind):
    key, w, x = _operands(c, ell, d, seed=c + ell + d)
    g = prng.generator_values(key, c, ell, kind)
    p64, bound = enc_ops.float64_reference_and_bound(g, w, x)
    got = _emulate_kernel(g, w, x)
    plain = enc_ref.encode_parity_prng(key, w, x, c, kind)
    shares = {"kernel": _share(got, p64, bound),
              "plain": _share(plain, p64, bound)}
    print(f"emulated 3xTF32 kernel 3 ({kind}) at (C, L, D) = "
          f"{(c, ell, d)}: worst element at {shares['kernel']:.4f} "
          f"(kernel) and {shares['plain']:.4f} (plain float32) of the "
          f"float64 bound")
    assert shares["kernel"] <= 1.0 and shares["plain"] <= 1.0
    atol = 2e-4 * float(plain.abs().max())
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=atol)


@pytest.mark.parametrize("kind", prng.KINDS)
def test_plain_tf32_is_outside_the_float64_bound(kind):
    """The bound tells the split from plain TF32 at the §IV shape: one
    TF32 product per float32 product lands outside it, 3xTF32 inside."""
    key, w, x = _operands(2016, 300, 501, seed=5)
    g = prng.generator_values(key, 2016, 300, kind)
    p64, bound = enc_ops.float64_reference_and_bound(g, w, x)
    shares = [_share(_emulate_kernel(g, w, x, split), p64, bound)
              for split in (False, True)]
    assert shares[0] > 1.0 > shares[1]


@pytest.mark.parametrize("kind", prng.KINDS)
@pytest.mark.parametrize("c,ell", [(1, 1), (17, 33), (2016, 300)])
def test_identity_returns_the_generator(c, ell, kind):
    """At X = I and w = 1 the emulated kernel returns G: Rademacher
    entries exactly, normal ones as big + small, within the card check's
    rtol 1e-6 / atol 1e-7."""
    key = prng.split_keys(prng.prng_key(c + ell), 3)[2]
    g = prng.generator_values(key, c, ell, kind)
    got = _emulate_kernel(g, torch.ones(ell), torch.eye(ell))
    if kind == "bernoulli":
        assert torch.equal(got, g)
    else:
        torch.testing.assert_close(got, g, rtol=1e-6, atol=1e-7)
        rel = ((got.double() - g.double()).abs() / g.double().abs()).max()
        assert float(rel) <= 2.0 ** -22
