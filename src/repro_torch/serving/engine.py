"""Continuous-batching serving engine (counterpart of
`repro/serving/engine.py`): slot management on a fixed-batch decode
step.

  * arriving requests are prefilled one at a time and their per-slot
    cache rows written into the live batch cache (slot dim 1 of every
    cache tensor, in place);
  * every engine step decodes ONE token for all slots; empty slots decode
    garbage into rows nobody reads;
  * per-slot position counters let slots run at different sequence
    offsets within the same cache.

Runs on the card by default (`device=None`); the parameters must live on
the engine's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.serve import check_on_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (len,) integer token ids
    max_new_tokens: int
    out_tokens: list = dataclasses.field(default_factory=list)
    slot: Optional[int] = None

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


def _splice(live: dict, new: dict, slot: int) -> None:
    """Write a one-request cache tree into slot `slot` of the live one."""
    for k, v in live.items():
        if isinstance(v, dict):
            _splice(v, new[k], slot)
        else:
            v[:, slot].copy_(new[k][:, 0])


class ServeEngine:
    """Continuous batching over `n_slots` decode slots.

    The reference vmaps a one-slot `decode_step` over the slot dimension
    so that each slot's `pos` stays a scalar inside the model.  The port
    runs one batched `decode_step` over the slot dimension with `pos` a
    (n_slots,) tensor, and computes the same function: every row is
    roped at its own position, writes its K/V at its own slot of its own
    cache row and attends the keys j <= pos[row] of that row only, and
    every other product of the decode (norms, projections, MLP, the ssm
    recurrence, which reads no position) is row by row over the batch.
    So is the MoE FFN: the batch is one dispatch group of n_slots tokens
    (or a divisor of it), and the decode's capacity is k * group
    (`models.transformer._moe_dims`), while one expert receives at most
    one copy of each token of the group, so no token is dropped, and a
    row's output, its gated sum over its own experts, does not depend on
    the other rows (the empty slots' garbage rows included).  Admission
    prefills with `cache_len=max_seq`, so the splice writes whole cache
    rows and nothing of a slot's previous request survives.
    """

    def __init__(self, cfg: ArchConfig, params, n_slots: int, max_seq: int,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        check_on_device(params, self.device)
        self.cache = T.init_cache(cfg, n_slots, max_seq,
                                  dtype=params["embed"].dtype,
                                  device=self.device)
        self.positions = np.zeros(n_slots, dtype=np.int64)  # next pos per slot
        self.active: dict[int, Request] = {}                # slot -> request
        self.last_token = np.zeros(n_slots, dtype=np.int64)
        self._prefill = make_prefill_step(cfg, cache_len=max_seq)
        self._decode = make_decode_step(cfg)

    # ------------------------------------------------------------------
    def fits(self, req: Request) -> bool:
        """A request is servable iff its prompt prefills into the cache
        with room to decode at least one token.  Oversized requests are
        never admissible (see `run`)."""
        return len(req.prompt) + 1 <= self.max_seq

    @torch.inference_mode()
    def try_admit(self, req: Request) -> bool:
        """Prefill a request into a free slot; False if the engine is full
        or the request can never fit."""
        if not self.fits(req):
            return False
        free = [s for s in range(self.n_slots) if s not in self.active]
        if not free:
            return False
        slot = free[0]
        toks = torch.as_tensor(np.asarray(req.prompt, dtype=np.int64),
                               device=self.device)[None, :]
        logits, cache1 = self._prefill(self.params, {"tokens": toks})
        _splice(self.cache, cache1, slot)
        tok = int(torch.argmax(logits[0, -1]))
        req.out_tokens.append(tok)
        req.slot = slot
        self.active[slot] = req
        self.positions[slot] = len(req.prompt)
        self.last_token[slot] = tok
        return True

    @torch.inference_mode()
    def step(self) -> list[Request]:
        """Decode one token for every active slot; returns finished reqs."""
        if not self.active:
            return []
        tokens = torch.as_tensor(self.last_token, device=self.device)
        pos = torch.tensor(self.positions, device=self.device)
        logits, self.cache = self._decode(
            self.params, {"token": tokens[:, None], "pos": pos}, self.cache)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        finished = []
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self.positions[slot] += 1
            self.last_token[slot] = tok
            if req.done or self.positions[slot] >= self.max_seq - 1:
                finished.append(req)
                del self.active[slot]
        return finished

    def run(self, requests: list[Request], max_steps: int = 10_000
            ) -> list[Request]:
        """Drive a queue of requests to completion (continuous batching).

        Admission scans the WHOLE pending queue each iteration, not just
        its head: a request that cannot be admitted right now (engine
        momentarily full, or oversized and never admissible) must not
        starve admissible requests behind it.  Requests that can never
        fit are rejected up front and are not returned as done.
        """
        pending = [r for r in requests if self.fits(r)]
        done: list[Request] = []
        steps = 0
        while (pending or self.active) and steps < max_steps:
            pending = [r for r in pending if not self.try_admit(r)]
            if not self.active:
                break  # nothing running and nothing admissible: idle-exit
            done.extend(self.step())
            steps += 1
        return done
