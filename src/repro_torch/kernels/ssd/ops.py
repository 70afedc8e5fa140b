"""Wrapper of the SSD intra-chunk CUDA kernel (`csrc/ssd.cu`), the
counterpart of `repro.kernels.ssd.ops.ssd_chunk`.

CPU tensors take the plain version (`ref.ssd_chunk_reference`); CUDA
tensors launch the kernel on the current stream or raise.  There is no
fallback from a CUDA tensor to the plain version, and a CUDA call with
an operand that requires grad raises (the kernel has no backward, so its
output would cut the gradient; `common.refuse_grad`).  `SSD_COUNTER`
counts the launches.

B and C come per group: bc/cc (B, nc, Q, G, N) with G dividing H, and
the kernel reads group h // (H / G) for head h.  G == H is the
reference's per-head layout (its `jnp.repeat`), so a call with the
reference's operands works unchanged; the model passes G = n_groups and
no per-head copy is made.  The kernel reads float32: x, dt, B and C are
upcast here, as the Pallas kernel upcasts them on load (exact for bf16);
da must be float32, as in the reference.  The kernel takes chunks of at
most 256 rows (a CTA holds its query tile's scores for the whole chunk
in shared memory); a longer chunk is refused before any launch, and
nothing is counted.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (LaunchCounter, check_cuda_operand,
                                        on_card, refuse_grad)

from . import ref

SSD_COUNTER = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES: build.Signatures = {
    # xc, dtc, da, bc, cc, y, states, B, nc, Q, H, P, G, N, stream
    "ssd_chunk_launch": ([_P] * 7 + [_I] * 7 + [_P], _I),
}


def _dispatch(device: torch.device):
    """The loaded kernel library for `device`, or None for the CPU.

    CUDA devices get the library (a failed build raises `BuildFailure`);
    any other device type raises."""
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"no ssd kernel for device {device}")
    return build.load("ssd", _SIGNATURES)


def _shapes(xc, dtc, da, bc, cc) -> tuple[int, ...]:
    """(B, nc, Q, H, P, G, N) of the operands; raises on a mismatch."""
    if xc.dim() != 5 or bc.dim() != 5:
        raise ValueError(f"xc and bc must be 5-d, got {tuple(xc.shape)} "
                         f"and {tuple(bc.shape)}")
    B, nc, Q, H, P = xc.shape
    G, N = bc.shape[3], bc.shape[4]
    if G < 1 or H % G:
        raise ValueError(f"{G} groups do not divide {H} heads")
    for name, t, shape in (("dtc", dtc, (B, nc, Q, H)),
                           ("da", da, (B, nc, Q, H)),
                           ("bc", bc, (B, nc, Q, G, N)),
                           ("cc", cc, (B, nc, Q, G, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    return B, nc, Q, H, P, G, N


def ssd_chunk(xc: torch.Tensor, dtc: torch.Tensor, da: torch.Tensor,
              bc: torch.Tensor, cc: torch.Tensor):
    """Intra-chunk SSD.

    xc (B, nc, Q, H, P), dtc (B, nc, Q, H), da (B, nc, Q, H) float32,
    bc/cc (B, nc, Q, G, N), G dividing H.
    Returns (y_diag (B, nc, Q, H, P) float32, states (B, nc, H, P, N)
    float32).
    """
    B, nc, Q, H, P, G, N = _shapes(xc, dtc, da, bc, cc)
    lib = _dispatch(xc.device)
    if lib is None:
        rep = H // G
        return ref.ssd_chunk_reference(xc, dtc, da,
                                       bc.repeat_interleave(rep, dim=3),
                                       cc.repeat_interleave(rep, dim=3))
    refuse_grad("ssd_chunk", xc, dtc, da, bc, cc)
    if da.dtype != torch.float32:
        raise TypeError(f"da must be float32, got {da.dtype}")
    ops = [t.to(torch.float32).contiguous() for t in (xc, dtc, da, bc, cc)]
    dev = xc.device
    for name, t in zip(("xc", "dtc", "da", "bc", "cc"), ops):
        check_cuda_operand(name, t, tuple(t.shape), dev)
    y = torch.empty((B, nc, Q, H, P), dtype=torch.float32, device=dev)
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=dev)
    with on_card(dev):
        status = lib.ssd_chunk_launch(
            *(t.data_ptr() for t in ops), y.data_ptr(), states.data_ptr(),
            B, nc, Q, H, P, G, N, torch.cuda.current_stream(dev).cuda_stream)
    build.check_status(lib, status, "ssd_chunk")
    SSD_COUNTER.launches += 1
    return y, states


reference = ref.ssd_chunk_reference  # the plain oracle, the reference's name
