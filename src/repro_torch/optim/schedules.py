"""Learning-rate schedules and global-norm gradient clipping (counterpart
of `repro/optim/schedules.py`), in float32 on the step's device.

A schedule takes the step as an int or a 0-d tensor (the optimizer
state's int32 step) and returns a 0-d float32 tensor on that tensor's
device, so a training step never reads the step back to the host."""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch import tree

F32 = torch.float32


def constant(lr: float) -> Callable:
    def schedule(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), lr, dtype=F32, device=dev)
    return schedule


def cosine_with_warmup(peak_lr: float, warmup_steps: int,
                       total_steps: int, final_frac: float = 0.1) -> Callable:
    """Linear warmup then cosine decay to final_frac * peak."""
    def schedule(step):
        step = torch.as_tensor(step).to(F32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def global_norm(grads) -> torch.Tensor:
    """sqrt of the float32 sum of squares over the leaves, in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree.leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped grads, pre-clip norm)."""
    norm = global_norm(grads)
    # max_norm / norm as one division (`scalar / tensor` multiplies by a
    # rounded reciprocal)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return tree.tree_map(lambda g: (g.to(F32) * scale).to(g.dtype),
                         grads), norm
