"""Wrappers of the parity-encoding CUDA kernels (`csrc/encode.cu`).

Two kernels, one per TPU kernel of `repro.kernels.encode`:
`encode_parity` (G an input) and `encode_parity_prng` (G regenerated
inside the kernel from a threefry key, tile by tile, never stored), with
the fleet encoders over the latter: `encode_fleet_prng` (the fleet key
split per client) and `encode_fleet_prng_keys` (the per-client key table
given).  The fleet encoders launch once per client, in client order,
each launch adding its client's (c, d+1) parity (labels as column d)
into the running composite, as the reference's scan does.

CPU tensors take the plain versions (`ref.py`); CUDA tensors launch the
kernel on the current stream or raise.  There is no fallback from a CUDA
tensor to a plain version.  `COUNTER` counts `encode_parity` launches,
`PRNG_COUNTER` the in-kernel-generator launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LaunchCounter, check_cuda_operand

from . import prng, ref

COUNTER = LaunchCounter()
PRNG_COUNTER = LaunchCounter()

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_SIGNATURES: build.Signatures = {
    "enc_encode_parity": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "enc_encode_parity_prng": ([_U, _U] + [_P] * 3 + [_I] * 5 + [_P], _I),
}
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


def encode_parity(g: torch.Tensor, w: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """P = G diag(w) X in full float32.  g: (C, L), w: (L,), x: (L, D)."""
    lib = _dispatch(g.device)
    if lib is None:
        return ref.encode_parity(g, w, x)
    if g.dim() != 2 or x.dim() != 2:
        raise ValueError("g must be (C, L) and x (L, D)")
    c, ell = g.shape
    d = x.shape[1]
    check_cuda_operand("g", g, (c, ell), g.device)
    check_cuda_operand("w", w, (ell,), g.device)
    check_cuda_operand("x", x, (ell, d), g.device)
    out = torch.empty((c, d), dtype=torch.float32, device=g.device)
    if c == 0 or d == 0 or ell == 0:
        return out.zero_()
    status = lib.enc_encode_parity(
        g.data_ptr(), w.data_ptr(), x.data_ptr(), out.data_ptr(), c, ell, d,
        torch.cuda.current_stream(g.device).cuda_stream)
    build.check_status(lib, status, "encode_parity")
    COUNTER.launches += 1
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
    status = lib.enc_encode_parity_prng(
        k0, k1, w.data_ptr(), x.data_ptr(), out.data_ptr(), c, ell, d,
        _KIND_CODES[kind], int(accumulate),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_status(lib, status, "encode_parity_prng")
    PRNG_COUNTER.launches += 1


def encode_parity_prng(key, w: torch.Tensor, x: torch.Tensor, c: int,
                       kind: str = "normal") -> torch.Tensor:
    """P = G diag(w) X with G = `prng.generator_values(key, c, L, kind)`
    regenerated inside the kernel and never stored.

    key: (2,) uint32; w: (L,), x: (L, D) float32 -> (C, D) float32.
    Raises ValueError when c * L reaches 2**31."""
    if x.dim() != 2:
        raise ValueError(f"x must be (L, D), got shape {tuple(x.shape)}")
    _check_prng_args(x.shape[0], c, kind)
    lib = _dispatch(x.device)
    if lib is None:
        return ref.encode_parity_prng(key, w, x, c, kind)
    out = torch.empty((c, x.shape[1]), dtype=torch.float32, device=x.device)
    if c == 0 or x.shape[1] == 0:
        return out.zero_()
    _launch_prng(lib, key, w, x, c, kind, out, accumulate=False)
    return out


def encode_fleet_prng_keys(keys, xs: torch.Tensor, ys: torch.Tensor,
                           weights: torch.Tensor, c: int,
                           kind: str = "normal"
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite parity (X~ (c, d), y~ (c,)) with in-kernel generators,
    the per-client keys given.

    keys: (n, 2) uint32; xs: (n, ell, d), ys: (n, ell), weights: (n, ell).
    Client i's parity G(keys[i]) diag(w_i) [X_i | y_i] is added into the
    (c, d+1) composite in client order."""
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
    for i in range(n):
        w_i = weights[i].contiguous()
        if lib is None:
            acc = acc + ref.encode_parity_prng(keys[i], w_i, xa[i], c, kind)
        else:
            _launch_prng(lib, keys[i], w_i, xa[i], c, kind, acc,
                         accumulate=True)
    return acc[:, :d].contiguous(), acc[:, d].contiguous()


def encode_fleet_prng(key, xs: torch.Tensor, ys: torch.Tensor,
                      weights: torch.Tensor, c: int, kind: str = "normal"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """`encode_fleet_prng_keys` over the fleet key split per client
    (`prng.split_keys`, `jax.random.split`'s layout)."""
    return encode_fleet_prng_keys(prng.split_keys(key, xs.shape[0]), xs, ys,
                                  weights, c, kind)
