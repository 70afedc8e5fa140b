"""Step functions shared by the launchers (counterpart of
`repro/launch/steps.py`): prefill and decode.  The train steps wait for
the training port (ROADMAP.md item 13).  Both compute in the parameters'
dtype: the serving entry points run float32, and a compute dtype of its
own comes with the first caller that needs one."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ArchConfig,
                      cache_len: int | None = None) -> Callable:
    """`cache_len` reserves KV slots beyond the prompt for the decode
    steps (the dense family; the ssm family ignores it)."""
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, batch, cache):
        return T.decode_step(cfg, params, batch, cache)
    return serve_step
