"""Wrapper of the masked round-gradient CUDA kernel (`csrc/round_grad.cu`).

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
    "rg_masked_round_gradient": ([_P] * 6 + [_I, _I, _P], _I),
    "rg_num_ctas": ([_I], _I),
    "rg_max_d": ([], _I),
}


def _dispatch(device: torch.device):
    """The loaded kernel library for `device`, or None for the CPU.

    CUDA devices get the library (a failed build raises `BuildFailure`);
    any other device type raises."""
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"no round_grad kernel for device {device}")
    return build.load("round_grad", _SIGNATURES)


def masked_round_gradient(x: torch.Tensor, y: torch.Tensor,
                          w: torch.Tensor | None,
                          beta: torch.Tensor) -> torch.Tensor:
    """g = (w * (X beta - y)) @ X in one pass over X; w=None means w = 1.

    x: (M, D), y/w: (M,), beta: (D,), all float32 -> (D,) float32.
    """
    lib = _dispatch(x.device)
    if lib is None:
        return ref.masked_round_gradient(x, y, w, beta)
    if x.dim() != 2:
        raise ValueError(f"x must be (M, D), got shape {tuple(x.shape)}")
    m, d = x.shape
    if d > lib.rg_max_d():
        raise ValueError(f"D={d} exceeds the kernel's limit {lib.rg_max_d()}")
    check_cuda_operand("x", x, (m, d), x.device)
    check_cuda_operand("y", y, (m,), x.device)
    check_cuda_operand("beta", beta, (d,), x.device)
    if w is not None:
        check_cuda_operand("w", w, (m,), x.device)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    partials = torch.empty((lib.rg_num_ctas(m), d), dtype=torch.float32,
                           device=x.device)
    status = lib.rg_masked_round_gradient(
        x.data_ptr(), y.data_ptr(), None if w is None else w.data_ptr(),
        beta.data_ptr(), partials.data_ptr(), out.data_ptr(), m, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_status(lib, status, "masked_round_gradient")
    COUNTER.launches += 1
    return out
