"""The counter-based threefry2x32 generator behind the in-kernel-PRNG
encode, and its host side: the plain generator of the kernel's tiles.

The counterpart of `repro/kernels/encode/encode.py`'s `_threefry2x32`,
`_threefry_bits_at`, `_bits_to_generator` and `generator_values`, and of
`jax.random.split` for the fleet's per-client key table.  Two layouts
are reproduced, each as the reference runs on JAX 0.9:

  * `split_keys(key, n)` — `jax.random.split` under JAX's default
    `jax_threefry_partitionable=True`: row i is the hash of the
    counter pair (0, i);
  * `threefry_bits_at` — the generator tiles, which always use the
    legacy split-half counter pairing: flat position idx of a size-S
    stream is word 0 of hash(j, j + ceil(S/2)) for idx < ceil(S/2) and
    word 1 for the upper half (odd sizes pair the last low counter with
    0).

Keys are (2,) uint32 values (a NumPy array, or a tensor holding them);
`prng_key(seed)` is `jax.random.PRNGKey(seed)`.  torch has no uint32
add, shift or compare on the CPU, so the hash runs in int64 tensors
holding uint32 values, masked with `& 0xFFFFFFFF` after every add and
shift; the same expressions run on any device.

Bits become floats as `jax.random` makes them: `(bits >> 9) | 0x3F800000`
viewed as float32, minus 1.  Rademacher (`bernoulli`) entries are then
exact.  Normal entries are sqrt(2) * erfinv(u) with XLA's float32
erfinv: Giles' single-precision polynomial ("Approximating the erfinv
function", 2010), evaluated operation by operation in float32.  It is
not XLA's own code (XLA's log1p differs), so normal entries agree with
JAX's `generator_values` to a few ulp, not bit for bit (on the CPU at
(2016, 300): 95% of entries bit-equal, at most 3 ulp apart); torch's
own `erfinv` is a different approximation (up to 89 ulp apart there).
`csrc/encode.cu` evaluates the same float32 operations.
"""
from __future__ import annotations

import numpy as np
import torch

KINDS = ("normal", "bernoulli")

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_ONE_BITS = 0x3F800000  # float32 1.0

# Giles' float32 erfinv coefficients (XLA's ErfInv32), highest power first
ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def prng_key(seed: int) -> np.ndarray:
    """The (2,) uint32 key `jax.random.PRNGKey(seed)` builds."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & _MASK], dtype=np.uint32)


def key_words(key) -> tuple[int, int]:
    """The two uint32 words of a (2,) key as Python ints."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    k = np.asarray(key).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {k.shape}")
    return int(k[0]) & _MASK, int(k[1]) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash (20 rounds) of counter pairs (x0, x1) under
    key (k0, k1).  x0, x1: int64 tensors of uint32 values; returns the
    two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i, rots in enumerate((_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A)):
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def threefry_bits_at(k0: int, k1: int, idx: torch.Tensor,
                     size: int) -> torch.Tensor:
    """Word `idx` of the size-`size` bit stream in the legacy split-half
    pairing (see the module docstring).  idx: int64 tensor."""
    half = (size + 1) // 2
    hi = idx >= half
    j = torch.where(hi, idx - half, idx)
    cnt1 = j + half
    if size % 2:  # odd sizes pair the last low counter with the zero pad
        cnt1 = torch.where(cnt1 == size, torch.zeros_like(cnt1), cnt1)
    out0, out1 = threefry2x32(k0, k1, j, cnt1)
    return torch.where(hi, out1, out0)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """Giles' float32 erfinv for |x| < 1, each operation rounded to
    float32 (a float32 tensor in, the same out).  The constants enter as
    Python scalars, so no host-to-device copy stalls the stream."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, ERFINV_W_LT_5[0], ERFINV_W_GE_5[0])
    for lt_c, ge_c in zip(ERFINV_W_LT_5[1:], ERFINV_W_GE_5[1:]):
        p = torch.where(lt, lt_c, ge_c) + p * w
    return p * x


# float32 values of the normal path's constants, as jax.random rounds them
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_ONE_MINUS_LO = float(np.float32(1.0) - np.float32(_LO))  # 2.0 in float32
_SQRT2 = float(np.float32(np.sqrt(2)))


def bits_to_generator(bits: torch.Tensor, kind: str) -> torch.Tensor:
    """uint32 words (an int64 tensor) -> float32 generator entries."""
    if kind not in KINDS:
        raise ValueError(f"unknown generator kind: {kind}")
    floats = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) \
        - 1.0
    if kind == "bernoulli":  # Rademacher: +-1 from a fair bernoulli draw
        u = torch.clamp(floats, min=0.0)
        return torch.where(u < 0.5, 1.0, -1.0).to(torch.float32)
    u = torch.clamp(floats * _ONE_MINUS_LO + _LO, min=_LO)
    return _SQRT2 * erfinv_f32(u)


def generator_values(key, c: int, ell: int, kind: str = "normal",
                     device="cpu") -> torch.Tensor:
    """The (c, ell) float32 generator the kernel's tiles produce for
    `key`, on `device`: entry (r, k) is word r * ell + k of the
    size-c*ell stream."""
    k0, k1 = key_words(key)
    idx = torch.arange(c * ell, dtype=torch.int64,
                       device=device).reshape(c, ell)
    return bits_to_generator(threefry_bits_at(k0, k1, idx, c * ell), kind)


def split_keys(key, n: int) -> np.ndarray:
    """(n, 2) uint32 per-client keys: `jax.random.split(key, n)` under
    JAX 0.9's default (partitionable) layout, row i = hash of (0, i)."""
    k0, k1 = key_words(key)
    i = torch.arange(n, dtype=torch.int64)
    out0, out1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return torch.stack([out0, out1], dim=1).numpy().astype(np.uint32)
