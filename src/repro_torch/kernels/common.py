"""Backend detection, tile resolution and launch counters for the kernels.

The counterpart of `repro/kernels/common.py`.  `backend()` names the live
target (also the future tune-cache key component); `resolve_block` turns
the `"auto"` sentinel into a tile.  The tune cache is not ported yet, so
`"auto"` always resolves to the kernel's default.
"""
from __future__ import annotations

import dataclasses

import torch

AUTO = "auto"


def backend(device: str | torch.device | None = None) -> str:
    """`"cuda-sm90"` on a compute-capability (9, 0) card, else `"cpu"`."""
    if not torch.cuda.is_available():
        return "cpu"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.get_device_capability(dev) == (9, 0):
        return "cuda-sm90"
    return "cpu"


def resolve_block(family: str, shape: tuple[int, ...], block, default):
    """Concrete tile for `block`: pass-through unless `block == "auto"`,
    which resolves to `default` until the tune cache is ported."""
    del family, shape  # the cache key, once there is a cache
    return default if block == AUTO else block


@dataclasses.dataclass
class LaunchCounter:
    """Plain-integer count of kernel launches, bumped by a wrapper only
    where it launches its kernel (never on the plain CPU path)."""

    launches: int = 0

    def reset(self) -> None:
        self.launches = 0


def refuse_grad(kernel: str, *operands) -> None:
    """Raise if autograd would record this launch: the CUDA kernels write
    into `torch.empty` outputs through raw pointers and have no backward,
    so their outputs carry no `grad_fn` and every gradient above the
    call would be cut without a word.  Wrappers call it on the kernel
    route only; on the CPU they compute the differentiable plain
    version."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in operands):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward and an operand "
            "requires grad; call it under torch.no_grad() or "
            "torch.inference_mode(), or train through the plain version "
            "(use_kernel=False)")


def check_cuda_operand(name: str, t: torch.Tensor, shape: tuple[int, ...],
                       device: torch.device) -> None:
    """Raise unless `t` is a contiguous float32 tensor of `shape` on
    `device` — the layout every kernel here reads through raw pointers."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
