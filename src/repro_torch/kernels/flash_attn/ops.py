"""Wrapper of the causal flash-attention CUDA kernel
(`csrc/flash_attn.cu`), the counterpart of
`repro.kernels.flash_attn.ops.causal_attention`.

CPU tensors take the plain version (`ref.causal_attention`); CUDA tensors
launch the kernel on the current stream or raise.  There is no fallback
from a CUDA tensor to the plain version, and a CUDA call with an operand
that requires grad raises (the kernel has no backward, so its output
would cut the gradient; `common.refuse_grad`).  `FLASH_COUNTER` counts
the launches, and by the instance the library reports launching
(`tiles`: {(code, an index into INSTANCES): launches}).

q is (B, Hq, S, D) and k, v are (B, Hkv, S, D) with Hkv dividing Hq:
query head h reads key/value head h // (Hq / Hkv), so a model's grouped
key/value heads go in as they are.  The kernel addresses each operand by
its batch, head and row strides, so a transposed view of the model's
(B, S, H, D) projections is read in place, and the output comes back
with q's strides (a view of a (B, S, Hq, D) tensor when q is one): the
wrapper makes no copy of a float32 operand whose last dimension is
contiguous.  Other dtypes are upcast to float32, as the Pallas kernel
upcasts on load, and the output is cast back to q's dtype.  Any S (the
kernel masks the ragged tail; there is no TPU block size to divide);
D at most 128.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LaunchCounter, on_card, refuse_grad

from . import ref

FLASH_COUNTER = LaunchCounter()
MAX_D = 128

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES: build.Signatures = {
    # q, k, v, o, B, Hq, Hkv, S, D, 4 x (b, h, s) strides, scale, stream,
    # out: the instance launched
    "flash_attn_launch": ([_P] * 4 + [_I] * 5 + [_L] * 12
                          + [ctypes.c_float, _P, ctypes.POINTER(_I)], _I),
    "flash_attn_smem_bytes": ([_I], _I),
    "flash_attn_instance": ([_I] * 3, _I),
}
# flash_attn_instance's 0-6
INSTANCES = ("run-time D", "D = 128", "D = 64", "short, D = 128, 32 keys",
             "short, D = 128, 64 keys", "short, D = 64, 32 keys",
             "short, D = 64, 64 keys")
SHORT_MAX_S = 64  # the short instances' longest sequence (kShortMaxS)


def instance(d: int, aligned: bool = True, s: int | None = None) -> str:
    """The compiled instance of the kernel a call at head size D and S
    rows takes, a pure function of its arguments (`aligned`: D % 4 == 0
    and every base and batch, head and row stride of q, k, v a multiple
    of 4 floats, so 16-byte copies; `s=None`: a sequence longer than
    SHORT_MAX_S), mirrored by the library's `flash_attn_instance`.
    Aligned, D in 121..128 (16 column tiles of 8) or 57..64 (8 tiles)
    takes a short instance at S <= SHORT_MAX_S (32 keys at S <= 32, else
    64; one key/value head's query group packed into a CTA's rows,
    however many query heads it holds), else "D = 128" (two CTAs an SM)
    or "D = 64" (three); every other call takes "run-time D" (the column
    tile count read at run time, 4-byte copies where not aligned).  Every
    instance computes the same sums in the same order: the result of a
    call is the run-time instance's bit for bit."""
    nd = -(-d // 8)
    if not aligned or nd not in (8, 16):
        return INSTANCES[0]
    if s is not None and s <= SHORT_MAX_S:
        return INSTANCES[(3 if nd == 16 else 5) + (s > 32)]
    return INSTANCES[1 if nd == 16 else 2]


def _dispatch(device: torch.device):
    """The loaded kernel library for `device`, or None for the CPU.

    CUDA devices get the library (a failed build raises `BuildFailure`);
    any other device type raises."""
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"no flash_attn kernel for device {device}")
    return build.load("flash_attn", _SIGNATURES)


def _shapes(q, k, v) -> tuple[int, int, int, int, int]:
    """(B, Hq, Hkv, S, D) of the operands; raises on a mismatch."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hkv} key/value heads do not divide {Hq} heads")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, Hkv, S, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, Hkv, S, D)}")
    if D > MAX_D:
        raise ValueError(f"head dim {D} exceeds the kernel's {MAX_D}")
    return B, Hq, Hkv, S, D


def smem_bytes(D: int) -> int:
    """Dynamic shared memory (bytes) of one CTA of the kernel at head size
    D, as the kernel's library computes it (built on first use)."""
    return build.load("flash_attn", _SIGNATURES).flash_attn_smem_bytes(D)


@functools.lru_cache(maxsize=None)
def scale(D: int) -> float:
    """1/sqrt(D) computed in float32, as the model computes it; a host
    number, computed once per D."""
    return float(np.float32(1) / np.sqrt(np.float32(D)))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """Causal softmax attention: q (B, Hq, S, D), k/v (B, Hkv, S, D) ->
    (B, Hq, S, D) in q's dtype, float32 softmax."""
    B, Hq, Hkv, S, D = _shapes(q, k, v)
    lib = _dispatch(q.device)
    if lib is None:
        return ref.causal_attention(q, k, v)
    refuse_grad("causal_attention", q, k, v)
    dev = q.device
    ops = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        t = t.to(torch.float32)
        ops.append(t if t.stride(-1) == 1 else t.contiguous())
    o = torch.empty_like(ops[0])
    strides = [st for t in (*ops, o) for st in t.stride()[:3]]
    chosen = ctypes.c_int(-1)
    with on_card(dev):
        status = lib.flash_attn_launch(
            *(t.data_ptr() for t in ops), o.data_ptr(), B, Hq, Hkv, S, D,
            *strides, scale(D), torch.cuda.current_stream(dev).cuda_stream,
            ctypes.byref(chosen))
    build.check_status(lib, status, "flash_attn")
    FLASH_COUNTER.add((chosen.value,))
    return o.to(q.dtype)


reference = ref.causal_attention  # the plain oracle, the reference's name
