"""Wrappers of the round-gradient CUDA kernels (`csrc/round_grad.cu`).

Three kernels, one per TPU kernel of `repro.kernels.round_grad`: the flat
masked round gradient, the coded (systematic + parity rows in one
launch) and the tier-masked ((T, D) tier partials from one pass over X).
CPU tensors take the plain versions (`ref.py`); CUDA tensors launch the
kernel on the current stream or raise.  There is no fallback from a CUDA
tensor to a plain version.  Each kernel has its own launch counter:
`COUNTER` (flat), `CODED_COUNTER`, `TIER_COUNTER`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LaunchCounter, check_cuda_operand

from . import ref

COUNTER = LaunchCounter()
CODED_COUNTER = LaunchCounter()
TIER_COUNTER = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES: build.Signatures = {
    "rg_masked_round_gradient": ([_P] * 6 + [_I, _I, _P], _I),
    "rg_tier_round_gradient": ([_P] * 4 + [_I] + [_P] * 3 + [_I, _I, _P],
                               _I),
    "rg_coded_round_gradient": ([_P] * 3 + [_I] + [_P] * 3 + [_I]
                                + [_P] * 3 + [_I, _P], _I),
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


def _check_rows(lib, x: torch.Tensor, y: torch.Tensor,
                w: torch.Tensor | None, beta: torch.Tensor,
                name: str = "x") -> tuple[int, int]:
    """Check one row block (x (M, D), y/w (M,), beta (D,)); return M, D."""
    if x.dim() != 2:
        raise ValueError(
            f"{name} must be (M, D), got shape {tuple(x.shape)}")
    m, d = x.shape
    if d > lib.rg_max_d():
        raise ValueError(f"D={d} exceeds the kernel's limit {lib.rg_max_d()}")
    check_cuda_operand(name, x, (m, d), x.device)
    check_cuda_operand(f"y of {name}", y, (m,), x.device)
    check_cuda_operand("beta", beta, (d,), x.device)
    if w is not None:
        check_cuda_operand(f"w of {name}", w, (m,), x.device)
    return m, d


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def masked_round_gradient(x: torch.Tensor, y: torch.Tensor,
                          w: torch.Tensor | None,
                          beta: torch.Tensor) -> torch.Tensor:
    """g = (w * (X beta - y)) @ X in one pass over X; w=None means w = 1.

    x: (M, D), y/w: (M,), beta: (D,), all float32 -> (D,) float32.
    """
    lib = _dispatch(x.device)
    if lib is None:
        return ref.masked_round_gradient(x, y, w, beta)
    m, d = _check_rows(lib, x, y, w, beta)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    partials = torch.empty((lib.rg_num_ctas(m), d), dtype=torch.float32,
                           device=x.device)
    status = lib.rg_masked_round_gradient(
        x.data_ptr(), y.data_ptr(), _ptr(w), beta.data_ptr(),
        partials.data_ptr(), out.data_ptr(), m, d, _stream(x.device))
    build.check_status(lib, status, "masked_round_gradient")
    COUNTER.launches += 1
    return out


def coded_round_gradient(x: torch.Tensor, y: torch.Tensor,
                         w: torch.Tensor | None, x_par: torch.Tensor,
                         y_par: torch.Tensor, w_par,
                         beta: torch.Tensor) -> torch.Tensor:
    """g_sys + g_par = (w * (X beta - y)) @ X + (w_par * (X~ beta - y~)) @ X~
    in one launch over both row blocks.

    x: (M, D), y/w: (M,), x_par: (C, D), y_par: (C,), w_par: (C,) or a
    scalar (0-d tensor or number, broadcast over the parity rows), beta:
    (D,), all float32 -> (D,) float32.  An empty parity block (C == 0)
    runs the flat masked kernel instead, as the reference does.
    """
    if x_par.shape[0] == 0:
        return masked_round_gradient(x, y, w, beta)
    w_par = torch.broadcast_to(
        torch.as_tensor(w_par, dtype=y_par.dtype, device=y_par.device),
        y_par.shape).contiguous()
    lib = _dispatch(x.device)
    if lib is None:
        return ref.coded_round_gradient(x, y, w, x_par, y_par, w_par, beta)
    m, d = _check_rows(lib, x, y, w, beta)
    c, _ = _check_rows(lib, x_par, y_par, w_par, beta, name="x_par")
    if x_par.shape[1] != d:
        raise ValueError(f"x_par has D={x_par.shape[1]}, x has D={d}")
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    n_parts = lib.rg_num_ctas(m) + lib.rg_num_ctas(c)
    partials = torch.empty((n_parts, d), dtype=torch.float32,
                           device=x.device)
    status = lib.rg_coded_round_gradient(
        x.data_ptr(), y.data_ptr(), _ptr(w), m, x_par.data_ptr(),
        y_par.data_ptr(), w_par.data_ptr(), c, beta.data_ptr(),
        partials.data_ptr(), out.data_ptr(), d, _stream(x.device))
    build.check_status(lib, status, "coded_round_gradient")
    CODED_COUNTER.launches += 1
    return out


def tier_masked_round_gradient(x: torch.Tensor, y: torch.Tensor,
                               w: torch.Tensor | None,
                               tier_masks: torch.Tensor,
                               beta: torch.Tensor) -> torch.Tensor:
    """(T, D) tier partials, partial[t] = ((w * mask_t) * (X beta - y)) @ X,
    with one pass over X shared by all T tiers; w=None means w = 1.

    x: (M, D), y/w: (M,), tier_masks: (T, M), beta: (D,), all float32.
    At T = 1 with an all-ones mask the result is bit-equal to
    `masked_round_gradient` (one kernel body, the same row ranges and
    reduction order, and w * 1.0 is exact).
    """
    lib = _dispatch(x.device)
    if lib is None:
        return ref.tier_masked_round_gradient(x, y, w, tier_masks, beta)
    m, d = _check_rows(lib, x, y, w, beta)
    if tier_masks.dim() != 2 or tier_masks.shape[0] < 1:
        raise ValueError(
            f"tier_masks must be (T, M), T >= 1, got shape "
            f"{tuple(tier_masks.shape)}")
    nt = int(tier_masks.shape[0])
    check_cuda_operand("tier_masks", tier_masks, (nt, m), x.device)
    out = torch.empty((nt, d), dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    partials = torch.empty((nt, lib.rg_num_ctas(m), d), dtype=torch.float32,
                           device=x.device)
    status = lib.rg_tier_round_gradient(
        x.data_ptr(), y.data_ptr(), _ptr(w), tier_masks.data_ptr(), nt,
        beta.data_ptr(), partials.data_ptr(), out.data_ptr(), m, d,
        _stream(x.device))
    build.check_status(lib, status, "tier_masked_round_gradient")
    TIER_COUNTER.launches += 1
    return out
