"""The threefry generator of the port (`repro_torch.kernels.encode.prng`)
and the plain version of the in-kernel-generator encode against the JAX
package, on the CPU.

Bounds:
  * keys (`prng_key`, `split_keys` against `jax.random.split` under this
    process's default config), hash words and Rademacher (`bernoulli`)
    generator entries: bit-equal;
  * normal entries: rtol 1e-6, atol 1e-7 (about 8 float32 ulp).  Both
    sides evaluate Giles' float32 erfinv, XLA's polynomial, but XLA
    brings its own log1p: on (2016, 300) 95% of entries are bit-equal and
    none is more than 3 ulp apart (torch's own `erfinv`, a different
    approximation, is up to 89 ulp apart there);
  * the plain `encode_parity_prng` and the fleet encoders against JAX's
    Pallas kernels in interpret mode: 2e-4 * max|ref|, the reference's
    encode bound (`tests/test_kernels.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.encode import encode as j_enc
from repro.kernels.encode import ops as j_ops
from repro_torch.kernels.encode import ops as t_ops
from repro_torch.kernels.encode import prng

KINDS = ("normal", "bernoulli")


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 123456789])
def test_prng_key_matches_jax(seed):
    got = prng.prng_key(seed)
    np.testing.assert_array_equal(got, _key(seed))
    assert got.dtype == np.uint32 and prng.key_words(got) == \
        tuple(int(v) for v in _key(seed))
    assert prng.key_words(torch.tensor(got.astype(np.int64))) == \
        prng.key_words(got)


@pytest.mark.parametrize("n", [1, 2, 7, 256, 1000])
@pytest.mark.parametrize("seed", [0, 9, 2024])
def test_split_keys_bit_equal(n, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.split(key, n))
    got = prng.split_keys(np.asarray(key), n)
    assert got.dtype == np.uint32 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, want)


def test_threefry2x32_bit_equal():
    rng = np.random.default_rng(0)
    x0, x1 = (rng.integers(0, 2**32, size=4096, dtype=np.uint64)
              .astype(np.uint32) for _ in range(2))
    for k0, k1 in ((0, 0), (0, 42), (0xDEADBEEF, 0x12345678),
                   (2**32 - 1, 2**32 - 1)):
        want = j_enc._threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                                   jnp.asarray(x0), jnp.asarray(x1))
        got = prng.threefry2x32(k0, k1,
                                torch.tensor(x0.astype(np.int64)),
                                torch.tensor(x1.astype(np.int64)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                          np.asarray(w))


@pytest.mark.parametrize("size", [1, 2, 7, 64, 65, 4095])
def test_threefry_bits_at_bit_equal(size):
    """The legacy split-half pairing, odd sizes included."""
    k0, k1 = prng.key_words(_key(5))
    idx = np.arange(size, dtype=np.int32)
    want = np.asarray(j_enc._threefry_bits_at(jnp.uint32(k0),
                                              jnp.uint32(k1),
                                              jnp.asarray(idx), size))
    got = prng.threefry_bits_at(k0, k1, torch.arange(size), size)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def _assert_generator_close(got, want, kind):
    if kind == "bernoulli":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("c,ell,seed", [(1, 1, 0), (7, 13, 1), (33, 5, 2),
                                        (64, 48, 3), (2016, 300, 4)])
def test_generator_values_match_jax(c, ell, seed, kind):
    key = _key(seed)
    want = np.asarray(j_enc.generator_values(jnp.asarray(key), c, ell,
                                             kind))
    got = prng.generator_values(key, c, ell, kind)
    assert got.dtype == torch.float32 and tuple(got.shape) == (c, ell)
    _assert_generator_close(got.numpy(), want, kind)


@settings(max_examples=6, deadline=None, database=None)
@given(c=st.integers(1, 40), ell=st.integers(1, 40),
       seed=st.integers(0, 2**31 - 1))
def test_generator_values_property(c, ell, seed):
    """Random shapes (odd c * ell half the time) and keys."""
    key = _key(seed)
    for kind in KINDS:
        want = np.asarray(j_enc.generator_values(jnp.asarray(key), c, ell,
                                                 kind))
        _assert_generator_close(
            prng.generator_values(key, c, ell, kind).numpy(), want, kind)


def test_erfinv_f32_near_the_ends():
    """Giles' erfinv against XLA's over u's whole range, the tail branch
    (w >= 5) included."""
    u = np.concatenate([np.linspace(-0.99999994, 0.99999994, 20001),
                        1.0 - np.logspace(-7.2, -1, 500),
                        -1.0 + np.logspace(-7.2, -1, 500)]).astype(
        np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    got = prng.erfinv_f32(torch.tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _encode_case(ell, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(ell).astype(np.float32) + 0.5,
            rng.standard_normal((ell, d)).astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("c,ell,d,block", [(45, 37, 19, (16, 8, 8)),
                                           (24, 30, 9, (8, 16, 16)),
                                           (7, 5, 3, (128, 128, 128))])
def test_encode_parity_prng_plain_matches_pallas(c, ell, d, block, kind):
    w, x = _encode_case(ell, d, c + ell)
    key = _key(c)
    want = np.asarray(j_enc.encode_parity_prng(
        jnp.asarray(key), jnp.asarray(w), jnp.asarray(x), c, kind=kind,
        block=block, interpret=True))
    got = t_ops.encode_parity_prng(key, torch.tensor(w), torch.tensor(x), c,
                                   kind)
    assert got.dtype == torch.float32 and tuple(got.shape) == (c, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def _fleet_case(n=6, ell=5, d=8):
    rng = np.random.default_rng(11)
    return (rng.standard_normal((n, ell, d)).astype(np.float32),
            rng.standard_normal((n, ell)).astype(np.float32),
            rng.uniform(0.5, 1.5, (n, ell)).astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_encode_fleet_prng_matches_pallas(kind):
    xs, ys, w = _fleet_case()
    key = _key(9)
    jx, jy = j_ops.encode_fleet_prng(jnp.asarray(key), jnp.asarray(xs),
                                     jnp.asarray(ys), jnp.asarray(w), 4,
                                     kind=kind, force_interpret=True)
    tx, ty = t_ops.encode_fleet_prng(key, torch.tensor(xs), torch.tensor(ys),
                                     torch.tensor(w), 4, kind)
    for got, want in ((tx, jx), (ty, jy)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max())
    # the keyed entry over the split table is the same computation
    kx, ky = t_ops.encode_fleet_prng_keys(
        prng.split_keys(key, 6), torch.tensor(xs), torch.tensor(ys),
        torch.tensor(w), 4, kind)
    assert torch.equal(kx, tx) and torch.equal(ky, ty)


def test_encode_prng_validation():
    w, x = torch.ones(4), torch.ones((4, 3))
    key = prng.prng_key(0)
    with pytest.raises(ValueError, match="unknown generator kind"):
        t_ops.encode_parity_prng(key, w, x, 2, kind="uniform")
    with pytest.raises(ValueError, match="2\\*\\*31"):
        t_ops.encode_parity_prng(key, torch.ones(2**16),
                                 torch.ones((2**16, 1)), 2**15)
    t_ops.encode_parity_prng(key, torch.ones(2**16), torch.ones((2**16, 1)),
                             1)  # c * ell far below 2**31 runs
    with pytest.raises(ValueError, match="keys must be"):
        t_ops.encode_fleet_prng_keys(np.zeros((3, 2), np.uint32),
                                     torch.ones((2, 4, 3)),
                                     torch.ones((2, 4)), torch.ones((2, 4)),
                                     2)
    with pytest.raises(ValueError, match="two uint32 words"):
        prng.key_words(np.zeros(3, np.uint32))
    out = t_ops.encode_parity_prng(key, w, x, 0)
    assert tuple(out.shape) == (0, 3)
