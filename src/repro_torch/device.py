"""Device resolution for the port's entry points.

Every entry point takes an explicit `device`.  `None` means the card: the
port is written for CUDA, so a missing card is an error, never a silent
fall back to the CPU (the tests ask for `device="cpu"` explicitly).
"""
from __future__ import annotations

import torch


def full_fp32() -> None:
    """Keep float32 products in full float32 on the card: TF32 keeps about
    three decimal digits, below the reference's encode and gradient
    bounds.  Both flags are set explicitly so the plain versions that run
    beside the kernels compute what their CPU counterparts compute."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device` as a `torch.device`; `None` means `cuda`, which must exist.
    A CUDA device comes back with its index, as tensors report it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        full_fp32()
        if dev.index is None:  # tensors report an indexed device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
