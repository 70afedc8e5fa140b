"""Wrapper of the weighted parity-encoding CUDA kernel (`csrc/encode.cu`).

CPU tensors take the plain version (`ref.py`); CUDA tensors launch the
kernel on the current stream or raise.  There is no fallback from a CUDA
tensor to the plain version.  `COUNTER.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LaunchCounter, check_cuda_operand

from . import ref

COUNTER = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES: build.Signatures = {
    "enc_encode_parity": ([_P] * 4 + [_I] * 3 + [_P], _I),
}


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
