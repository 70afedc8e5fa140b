"""Wrappers of the parity-encoding CUDA kernels (`csrc/encode.cu`).

Two kernels, one per TPU kernel of `repro.kernels.encode`:
`encode_parity` (G an input) and `encode_parity_prng` (G regenerated
inside the kernel from a threefry key, tile by tile, never stored), with
the fleet encoders: `encode_fleet` (the keyed streamed encode: each
client's G_i drawn from its key, kernel 2 once per client), and over the
in-kernel generator `encode_fleet_prng` (the fleet key split per client)
and `encode_fleet_prng_keys` (the per-client key table given).  The
fleet encoders launch once per client, in client order, each launch
adding its client's (c, d+1) parity (labels as column d) into the
running composite, as the reference's scan does.

Tiles: every entry point takes `block`, the CTA tile (bc, bd, bl).
Kernel 2 launches any tile of `TILES` (the library's instantiations);
its `block="auto"` (the default) reads the tune cache
(`repro_torch.tune`) at (c, ell, d) under the family "encode", and a
cold miss takes `DEFAULT_BLOCK`, bit for bit the launch of a wrapper
without tiles.  Kernel 3 has one tile, `PRNG_BLOCK` (its CTA pair spans
512 columns, so at d + 1 <= 512 each generator entry is hashed once):
its `block` is "auto" or that tile, with no cache to read and no tune
family until it has a second.  On the CPU the tile means nothing and is
ignored.

CPU tensors take the plain versions (`ref.py`); CUDA tensors launch the
kernel on the current stream or raise.  There is no fallback from a CUDA
tensor to a plain version, and a CUDA call with an operand that requires
grad raises (the kernels have no backward; `common.refuse_grad`).
`COUNTER` counts `encode_parity` launches,
`PRNG_COUNTER` the in-kernel-generator launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (AUTO, LaunchCounter,
                                        check_cuda_operand, on_card,
                                        refuse_grad, resolve_block)

from . import prng, ref

COUNTER = LaunchCounter()
PRNG_COUNTER = LaunchCounter()

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_SIGNATURES: build.Signatures = {
    "enc_encode_parity": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "enc_encode_parity_prng": ([_U, _U] + [_P] * 3 + [_I] * 5 + [_P], _I),
}
# kernel 2's instantiated CTA tiles (bc, bd, bl), as `kTiles` of
# csrc/encode.cu lists them (each fits a CTA's shared memory, which the
# library asserts as it builds), the first the default; kernel 3's one
# tile
TILES = ((128, 64, 32), (64, 64, 32), (64, 128, 32), (128, 32, 32),
         (64, 32, 32), (128, 128, 32))
DEFAULT_BLOCK = TILES[0]
PRNG_BLOCK = (32, 512, 32)


def _encode_tile(shape: tuple, block, device) -> tuple:
    """Kernel 2's tile for `block` at (c, ell, d): resolved against the
    tune cache and checked against the instantiations."""
    tile = tuple(int(b) for b in resolve_block("encode", shape, block,
                                               DEFAULT_BLOCK, device))
    if tile not in TILES:
        raise ValueError(f"encode has no tile {tile}; it launches {TILES}")
    return tile


def _prng_tile(block) -> tuple:
    """Kernel 3's tile for `block`: its one tile, "auto" included."""
    tile = PRNG_BLOCK if block == AUTO else tuple(int(b) for b in block)
    if tile != PRNG_BLOCK:
        raise ValueError(f"encode_prng has one tile, {PRNG_BLOCK}; got "
                         f"{tile}")
    return tile


_KIND_CODES = {"normal": 0, "bernoulli": 1}
# the generator's flat index r * ell + k is int32, as in the reference
_MAX_STREAM = 2**31


def _dispatch(device: torch.device):
    """The loaded kernel library for `device`, or None for the CPU.

    CUDA devices get the library (a failed build raises `BuildFailure`);
    any other device type raises."""
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"no encode kernel for device {device}")
    return build.load("encode", _SIGNATURES)


# unit roundoff of float32
U32 = 2.0 ** -24


def float64_reference_and_bound(g: torch.Tensor, w: torch.Tensor,
                                x: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """P = G diag(w) X in float64 and a bound on each entry's float32
    error: |P - P64| <= 1.01 (L + 20) u (|G| |diag(w) X|), u = 2^-24.
    Returns (P64, bound), both float64 (C, D) on the operands' device.

    Any float32 route: w x (or, in kernel 3, g w) rounds once (u), and
    a sum of L products in any order adds at most (L - 1) u of the
    summed magnitudes.  The kernels' 3xTF32 route (`csrc/encode.cu`,
    kernels 2 and 3; for kernel 3, G is the plain generator
    `prng.generator_values`): the split leaves out at
    most ~12 u |g||w x| a product, and each of the 3 ceil(L / 8) tensor-
    core products truncates its float32 sum, at most ~2 u of the partial
    sum's magnitude each (Fasi, Higham, Mikaitis and Pranesh, "Numerical
    behavior of NVIDIA tensor cores", PeerJ CS 2021): (0.75 L + 19) u.
    Both are inside (L + 20) u for every L; 1.01 covers the second-order
    terms.  One TF32 product per float32 product leaves out up to
    2^-10 |g||w x| (4096 u) and falls outside.
    """
    f64 = torch.float64
    wx = w.to(f64)[:, None] * x.to(f64)
    g64 = g.to(f64)
    bound = 1.01 * (g.shape[1] + 20) * U32 * (g64.abs() @ wx.abs())
    return g64 @ wx, bound


def encode_parity(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                  block=AUTO) -> torch.Tensor:
    """P = G diag(w) X in float32 precision (3xTF32 tensor-core products
    on the card, within `float64_reference_and_bound`).  g: (C, L),
    w: (L,), x: (L, D); block: the CTA tile (see the module docstring)."""
    lib = _dispatch(g.device)
    if lib is None:
        return ref.encode_parity(g, w, x)
    refuse_grad("encode_parity", g, w, x)
    if g.dim() != 2 or x.dim() != 2:
        raise ValueError("g must be (C, L) and x (L, D)")
    c, ell = g.shape
    d = x.shape[1]
    check_cuda_operand("g", g, (c, ell), g.device)
    check_cuda_operand("w", w, (ell,), g.device)
    check_cuda_operand("x", x, (ell, d), g.device)
    tile = _encode_tile((c, ell, d), block, g.device)
    out = torch.empty((c, d), dtype=torch.float32, device=g.device)
    if c == 0 or d == 0 or ell == 0:
        return out.zero_()
    with on_card(g.device):
        status = lib.enc_encode_parity(
            g.data_ptr(), w.data_ptr(), x.data_ptr(), out.data_ptr(), c, ell,
            d, *tile, torch.cuda.current_stream(g.device).cuda_stream)
    build.check_status(lib, status, "encode_parity")
    COUNTER.add(tile)
    return out


def _check_prng_args(ell: int, c: int, kind: str) -> None:
    if kind not in _KIND_CODES:
        raise ValueError(f"unknown generator kind: {kind}")
    if c < 0:
        raise ValueError(f"c must be >= 0, got {c}")
    if c * ell >= _MAX_STREAM:
        raise ValueError(
            f"c * ell = {c * ell} reaches 2**31: the generator's flat "
            f"index is int32")


def _launch_prng(lib, key, w: torch.Tensor, x: torch.Tensor, c: int,
                 kind: str, out: torch.Tensor, accumulate: bool) -> None:
    """out (C, D) = [out +] G(key) diag(w) X on the card (one launch)."""
    ell, d = x.shape
    check_cuda_operand("w", w, (ell,), x.device)
    check_cuda_operand("x", x, (ell, d), x.device)
    check_cuda_operand("out", out, (c, d), x.device)
    if c == 0 or d == 0:
        return
    k0, k1 = prng.key_words(key)
    with on_card(x.device):
        status = lib.enc_encode_parity_prng(
            k0, k1, w.data_ptr(), x.data_ptr(), out.data_ptr(), c, ell, d,
            _KIND_CODES[kind], int(accumulate),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_status(lib, status, "encode_parity_prng")
    PRNG_COUNTER.add(PRNG_BLOCK)


def encode_parity_prng(key, w: torch.Tensor, x: torch.Tensor, c: int,
                       kind: str = "normal", block=AUTO) -> torch.Tensor:
    """P = G diag(w) X with G = `prng.generator_values(key, c, L, kind)`
    regenerated inside the kernel and never stored (3xTF32 tensor-core
    products on the card, within `float64_reference_and_bound`).

    key: (2,) uint32; w: (L,), x: (L, D) float32 -> (C, D) float32;
    block: the tile, `PRNG_BLOCK` or "auto".  Raises ValueError when
    c * L reaches 2**31."""
    if x.dim() != 2:
        raise ValueError(f"x must be (L, D), got shape {tuple(x.shape)}")
    _check_prng_args(x.shape[0], c, kind)
    lib = _dispatch(x.device)
    if lib is None:
        return ref.encode_parity_prng(key, w, x, c, kind)
    refuse_grad("encode_parity_prng", w, x)
    _prng_tile(block)
    out = torch.empty((c, x.shape[1]), dtype=torch.float32, device=x.device)
    if c == 0 or x.shape[1] == 0:
        return out.zero_()
    _launch_prng(lib, key, w, x, c, kind, out, accumulate=False)
    return out


def encode_fleet_prng_keys(keys, xs: torch.Tensor, ys: torch.Tensor,
                           weights: torch.Tensor, c: int,
                           kind: str = "normal", block=AUTO
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite parity (X~ (c, d), y~ (c,)) with in-kernel generators,
    the per-client keys given.

    keys: (n, 2) uint32; xs: (n, ell, d), ys: (n, ell), weights: (n, ell).
    Client i's parity G(keys[i]) diag(w_i) [X_i | y_i] is added into the
    (c, d+1) composite in client order.  block: kernel 3's tile,
    checked once."""
    n, ell, d = xs.shape
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    keys = np.asarray(keys)
    if keys.shape != (n, 2):
        raise ValueError(f"keys must be ({n}, 2), got {keys.shape}")
    xa = torch.cat([xs, ys[..., None]], dim=-1).contiguous()  # labels ride along
    _check_prng_args(ell, c, kind)
    acc = torch.zeros((c, d + 1), dtype=xs.dtype, device=xs.device)
    lib = _dispatch(xs.device)
    if lib is not None:
        refuse_grad("encode_parity_prng", xs, ys, weights)
        _prng_tile(block)
    for i in range(n):
        w_i = weights[i].contiguous()
        if lib is None:
            acc = acc + ref.encode_parity_prng(keys[i], w_i, xa[i], c, kind)
        else:
            _launch_prng(lib, keys[i], w_i, xa[i], c, kind, acc,
                         accumulate=True)
    return acc[:, :d].contiguous(), acc[:, d].contiguous()


def encode_fleet_prng(key, xs: torch.Tensor, ys: torch.Tensor,
                      weights: torch.Tensor, c: int, kind: str = "normal",
                      block=AUTO) -> tuple[torch.Tensor, torch.Tensor]:
    """`encode_fleet_prng_keys` over the fleet key split per client
    (`prng.split_keys`, `jax.random.split`'s layout)."""
    return encode_fleet_prng_keys(prng.split_keys(key, xs.shape[0]), xs, ys,
                                  weights, c, kind, block=block)


def encode_fleet(keys, xs: torch.Tensor, ys: torch.Tensor,
                 weights: torch.Tensor, c: int, kind: str = "normal",
                 block=AUTO) -> tuple[torch.Tensor, torch.Tensor]:
    """The keyed streamed fleet encode: composite parity (X~ (c, d),
    y~ (c,)) with kernel 2 once per client, in client order.

    keys: client i's generator G_i (c, ell) is
    `core.encoding.generator_matrix` drawn from a `torch.Generator` on
    xs's device seeded with keys[i] (an (n,) sequence of ints), or, when
    `keys` is callable, keys(i) itself.  xs: (n, ell, d), ys: (n, ell),
    weights: (n, ell).  One tile is resolved at (c, ell, d) for every
    client; the streaming is `core.encoding.encode_fleet_streamed`'s.
    """
    from functools import partial

    from repro_torch.core.encoding import (encode_fleet_streamed,
                                           generator_matrix)

    n, ell, d = xs.shape
    if callable(keys):
        g_source = keys
    else:
        seeds = [int(k) for k in keys]
        if len(seeds) != n:
            raise ValueError(f"keys has {len(seeds)} seeds for {n} clients")

        def g_source(i):
            gen = torch.Generator(device=xs.device).manual_seed(seeds[i])
            return generator_matrix(gen, c, ell, kind=kind, dtype=xs.dtype)
    if xs.device.type == "cuda":
        block = _encode_tile((c, ell, d), block, xs.device)
    return encode_fleet_streamed(g_source, xs, ys, weights, c,
                                 partial(encode_parity, block=block))


# the plain oracles under the reference's names (`repro.kernels.encode.ops`)
generator_values = prng.generator_values
reference = ref.encode_parity
reference_fleet = ref.encode_fleet
