"""Backend detection, tile resolution and launch counters for the kernels.

The counterpart of `repro/kernels/common.py`.  `backend()` names the live
target (also the tune cache's key component); `resolve_block` turns the
`"auto"` sentinel into a tile by reading the persisted tune cache
(`repro_torch.tune.cache.lookup_block`), and falls back to the kernel's
default on a cold miss.  Resolution only reads: populating the cache is
`python -m repro_torch.tune`'s job.  A wrapper resolves on every launch,
so what a lookup found is kept for the life of the process
(`tune.cache.RESOLVED`, cleared by `TileCache.store`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os

import torch

from repro_torch.tune import cache as tune_cache

AUTO = "auto"


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> tuple[int, int]:
    return torch.cuda.get_device_capability(index)


def backend(device: str | torch.device | None = None) -> str:
    """`"cuda-sm90"` on a compute-capability (9, 0) card, else `"cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return "cuda-sm90" if _capability(index) == (9, 0) else "cpu"


def resolve_block(family: str, shape: tuple[int, ...], block, default,
                  device: str | torch.device | None = None):
    """Concrete tile for `block`: pass-through unless `block == "auto"`.

    `shape` is the family's problem shape (`(m, d)` for the round
    gradients, `(c, ell, d)` for the encodes), bucketed by the cache;
    the backend is `backend(device)`.  A cold miss returns `default`,
    bit for bit what the kernel launches without a tuned tile.  A hit is
    an int where `default` is one (the 1-d row tiles), else a tuple.
    The answer is memoized per (family, shape, device, user cache
    directory) until a `TileCache.store`.
    """
    if block != AUTO:
        return block
    key = (family, tuple(shape), device,
           os.environ.get(tune_cache.CACHE_ENV))
    tile = tune_cache.RESOLVED.get(key)
    if tile is None:
        found = tune_cache.lookup_block(family, shape, backend(device))
        if found is None:
            tile = default
        elif isinstance(default, int):
            tile = int(found[0])
        else:
            tile = tuple(int(b) for b in found)
        tune_cache.RESOLVED[key] = tile
    return tile


@dataclasses.dataclass
class LaunchCounter:
    """Plain-integer count of kernel launches, bumped by a wrapper only
    where it launches its kernel (never on the plain CPU path), and the
    launches by tile (`tiles`: {tile as the C entry point took it, or
    chose it and reports it: launches}; `(0,)` is a round-gradient
    kernel's own partition, kernel 8's key its compiled instance)."""

    launches: int = 0
    tiles: dict = dataclasses.field(default_factory=dict)

    def add(self, tile: tuple) -> None:
        """One launch of the kernel with `tile`."""
        self.launches += 1
        self.tiles[tile] = self.tiles.get(tile, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.tiles.clear()


def on_card(device: torch.device):
    """The context a launch through ctypes runs in: `device` made the
    CUDA runtime's current device (a kernel launched onto a stream of
    another card than the current one fails, and the wrappers launch on
    their operands' card, which the lane and shard meshes spread over
    every local card); a no-op for any other device type."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


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
