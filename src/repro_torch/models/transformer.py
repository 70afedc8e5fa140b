"""Decoder LM over the reference's parameter tree (counterpart of
`repro/models/transformer.py`), the `ssm` family (uniform Mamba2 blocks,
attention-free) so far.

Entry points, with the reference's names and batch dicts:

  * ``init_params(cfg, gen)``                    -> parameter tree
  * ``prefill(cfg, params, batch)``              -> (last-token logits, cache)
  * ``decode_step(cfg, params, batch, cache)``   -> (logits, new cache)

The parameter tree is a dict of tensors with the reference's keys and
its stacked leading layer dimension (`params["blocks"][...]` is
(n_layers, ...)), so weights cross between the packages by key
(`repro_torch.interop.lm_params`).  The layers run as a Python loop over
the stack where the reference scans.  Serving runs under
`torch.inference_mode()`.

Every other `arch_type` raises `NotImplementedError`: the dense, moe,
hybrid, vlm and audio families, `forward_train` and `loss_fn` wait for
ROADMAP.md item 13.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from . import layers as L
from . import ssm as S


def _require_ssm(cfg: ArchConfig) -> None:
    if cfg.arch_type != "ssm":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) is not ported; only "
            "the ssm family is (ROADMAP.md item 13)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> dict:
    """The parameter tree, drawn from `gen` on `device` (the card by
    default; `gen` must live there).  On `device="meta"` nothing is drawn
    and `gen` may be None: shapes only.

    The reference's initialisers (N(0, 0.02) embedding, dense layers
    N(0, 1)/sqrt(fan_in), conv taps N(0, 0.01), a_log = log(linspace(1,
    16, H)), unit norms), each layer its own draws; the numbers differ
    from `jax.random`'s for any seed.
    """
    _require_ssm(cfg)
    dev = resolve_device(device)
    d, s = cfg.d_model, cfg.ssm
    p: dict[str, Any] = {
        "embed": L.normal(gen, (cfg.vocab, d), 0.02, dtype, dev),
        "final_norm": L.init_norm(d, dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, cfg.vocab, dtype, dev)
    stack = (cfg.n_layers,)
    p["blocks"] = {
        "norm": L.init_norm(d, dtype, dev, stack),
        "mixer": S.init_mamba2(gen, d, s.d_state, s.n_heads(d), s.headdim,
                               s.n_groups, s.d_conv, dtype, dev, stack),
    }
    return p


def _layer(stacked: dict, i: int) -> dict:
    """Layer i of a stacked tree (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# embedding in and out
# ---------------------------------------------------------------------------

def _embed(cfg: ArchConfig, params: dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    return params["embed"][tokens]


def _unembed(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return (x @ head.to(x.dtype)).to(torch.float32)


# ---------------------------------------------------------------------------
# serving: cache init, prefill, single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, seq_len: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None) -> dict:
    """Zero-initialized decode cache (`seq_len` is unused by the ssm
    family: its state does not grow with the sequence)."""
    _require_ssm(cfg)
    del seq_len
    return {"mamba": _mamba_cache_stack(cfg, cfg.n_layers, batch_size, dtype,
                                        resolve_device(device))}


def _mamba_cache_stack(cfg: ArchConfig, n: int, B: int, dtype: torch.dtype,
                       device: torch.device) -> dict:
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    conv_dim = H * s.headdim + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((n, B, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((n, B, H, s.headdim, s.d_state),
                           dtype=torch.float32, device=device),
    }


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, batch: dict, cache: dict):
    """One new token against the cache, computed in the parameters' dtype.

    batch: {"token": (B, 1) int64, "pos": absolute position of the new
    token (unused by the ssm family)}. Returns (logits fp32 (B, 1, V),
    new cache)."""
    _require_ssm(cfg)
    s = cfg.ssm
    x = _embed(cfg, params, batch["token"])
    blocks, mc = params["blocks"], cache["mamba"]
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        bp = _layer(blocks, i)
        hn = L.rmsnorm(bp["norm"], x)
        y, nc = S.mamba2_decode(bp["mixer"], hn, _layer(mc, i),
                                d_state=s.d_state,
                                n_heads=s.n_heads(cfg.d_model),
                                headdim=s.headdim, n_groups=s.n_groups)
        x = x + y
        convs.append(nc["conv"])
        ssms.append(nc["ssm"])
    new_cache = dict(cache)
    new_cache["mamba"] = {"conv": torch.stack(convs),
                          "ssm": torch.stack(ssms)}
    return _unembed(cfg, params, x), new_cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: dict, batch: dict, *,
            use_kernel: bool = True):
    """Process the prompt and build the decode cache, computed in the
    parameters' dtype.

    batch: {"tokens": (B, S) int64}.  Returns (last-position logits fp32
    (B, 1, V), cache).  `use_kernel` defaults
    to True (the reference's to False): each layer's intra-chunk SSD step
    goes to `kernels.ssd.ops.ssd_chunk`, which launches kernel 7 for
    tensors on the card and computes the plain version on the CPU."""
    _require_ssm(cfg)
    s = cfg.ssm
    x = _embed(cfg, params, batch["tokens"])
    blocks = params["blocks"]
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        bp = _layer(blocks, i)
        h = L.rmsnorm(bp["norm"], x)
        y, mc = S.mamba2_prefill(
            bp["mixer"], h, d_state=s.d_state,
            n_heads=s.n_heads(cfg.d_model), headdim=s.headdim,
            n_groups=s.n_groups, chunk=s.chunk, use_kernel=use_kernel,
            head_shard=s.head_shard)
        x = x + y
        convs.append(mc["conv"])
        ssms.append(mc["ssm"])
    cache = {"mamba": {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}}
    return _unembed(cfg, params, x[:, -1:, :]), cache
