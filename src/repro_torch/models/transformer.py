"""Decoder LM over the reference's parameter tree (counterpart of
`repro/models/transformer.py`), the `dense` family (uniform [attention +
MLP] blocks) and the `ssm` family (uniform Mamba2 blocks) so far.

Entry points, with the reference's names and batch dicts:

  * ``init_params(cfg, gen)``                    -> parameter tree
  * ``forward_train(cfg, params, batch)``        -> (logits fp32, aux)
  * ``loss_fn(cfg, params, batch)``              -> (next-token loss, aux)
  * ``prefill(cfg, params, batch)``              -> (last-token logits, cache)
  * ``decode_step(cfg, params, batch, cache)``   -> (logits, new cache)

The parameter tree is a dict of tensors with the reference's keys and
its stacked leading layer dimension (`params["blocks"][...]` is
(n_layers, ...)), so weights cross between the packages by key
(`repro_torch.interop.lm_params`).  The layers run as a Python loop over
the stack where the reference scans.  Serving runs under
`torch.inference_mode()`.  The dense decode writes each layer's new K/V
into the cache in place (the reference returns a new cache).

Training (`forward_train`, `loss_fn`) is differentiable by autograd and,
as the reference's default, takes the plain expressions
(`use_kernel=False`): the CUDA kernels have no backward, and their
wrappers raise when an operand requires grad.  `remat=True` recomputes
each block in the backward pass (`torch.utils.checkpoint`); the
reference's `"save_ar"`, which keeps the activations after a
tensor-parallel all-reduce, is full remat here (one card runs no such
all-reduce).  Stacked leaves are split once per forward (`unbind`), so
each leaf's gradient is assembled once, not once per layer.

Every other `arch_type` raises `NotImplementedError`: the moe, hybrid,
vlm and audio families wait for ROADMAP.md §1 item 8, as do the
attention knobs no config sets (`attn_impl="repeat"`, a bf16 softmax,
`fused_proj`, `attn_seq_shard`); so does the moe family's
`moe_aux_loss`.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from . import layers as L
from . import ssm as S

PORTED_FAMILIES = ("dense", "ssm")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.arch_type not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) is not ported; only "
            f"the {' and '.join(PORTED_FAMILIES)} families are (ROADMAP.md "
            "§1 item 8)")
    for knob, ported in (("attn_impl", "grouped"), ("softmax_dtype", "f32"),
                         ("fused_proj", False), ("attn_seq_shard", False)):
        if getattr(cfg, knob) != ported:
            raise NotImplementedError(
                f"{knob}={getattr(cfg, knob)!r} ({cfg.name}) is not ported")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_init(cfg: ArchConfig, d: int, dtype: torch.dtype,
               device: torch.device, stack: tuple[int, ...] = ()) -> dict:
    if cfg.norm == "ln":
        return L.init_ln(d, dtype, device, stack)
    return L.init_norm(d, dtype, device, stack)


def _init_self_block(gen: Optional[torch.Generator], cfg: ArchConfig,
                     dtype: torch.dtype, device: torch.device,
                     stack: tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    return {
        "attn_norm": _norm_init(cfg, d, dtype, device, stack),
        "attn": L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd, dtype, device, stack,
                                 bias=cfg.attn_bias),
        "mlp_norm": _norm_init(cfg, d, dtype, device, stack),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, dtype, device, stack,
                          act=cfg.act),
    }


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> dict:
    """The parameter tree, drawn from `gen` on `device` (the card by
    default; `gen` must live there).  On `device="meta"` nothing is drawn
    and `gen` may be None: shapes only.

    The reference's initialisers (N(0, 0.02) embedding, dense layers
    N(0, 1)/sqrt(fan_in), conv taps N(0, 0.01), a_log = log(linspace(1,
    16, H)), unit norms, zero biases), each layer its own draws; the
    numbers differ from `jax.random`'s for any seed.
    """
    _require_ported(cfg)
    dev = resolve_device(device)
    d = cfg.d_model
    p: dict[str, Any] = {
        "embed": L.normal(gen, (cfg.vocab, d), 0.02, dtype, dev),
        "final_norm": _norm_init(cfg, d, dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, cfg.vocab, dtype, dev)
    stack = (cfg.n_layers,)
    if cfg.arch_type == "dense":
        p["blocks"] = _init_self_block(gen, cfg, dtype, dev, stack)
    else:
        s = cfg.ssm
        p["blocks"] = {
            "norm": L.init_norm(d, dtype, dev, stack),
            "mixer": S.init_mamba2(gen, d, s.d_state, s.n_heads(d),
                                   s.headdim, s.n_groups, s.d_conv, dtype,
                                   dev, stack),
        }
    return p


def _unstack(stacked: dict, n: int) -> list[dict]:
    """The n layers of a stacked tree, each leaf split once by `unbind`
    into views (no copy; in training one backward for all layers, where
    a `select` per layer would build a full-size gradient for each)."""
    layers: list[dict] = [{} for _ in range(n)]
    for k, v in stacked.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


# ---------------------------------------------------------------------------
# embedding in and out
# ---------------------------------------------------------------------------

def _embed(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The tokens' embeddings, the table cast to `compute_dtype` first (as
    the reference, so its gradient accumulates in that dtype)."""
    table = params["embed"]
    if compute_dtype is not None:
        table = table.to(compute_dtype)
    return table[tokens]


def _unembed(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return (x @ head.to(x.dtype)).to(torch.float32)


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def _remat(fn, remat):
    """remat: False | True ("full") | "save_ar" (full here: one card has
    no tensor-parallel all-reduce whose output it would keep)."""
    if not remat:
        return fn
    if remat not in (True, "full", "save_ar"):
        raise ValueError(f"unknown remat policy {remat!r}")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _mamba_block(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                 use_kernel: bool) -> torch.Tensor:
    s = cfg.ssm
    h = L.rmsnorm(bp["norm"], x)
    return x + S.mamba2_block(
        bp["mixer"], h, d_state=s.d_state, n_heads=s.n_heads(cfg.d_model),
        headdim=s.headdim, n_groups=s.n_groups, chunk=s.chunk,
        use_kernel=use_kernel, head_shard=s.head_shard)


def _run_backbone(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, remat=False,
                  use_kernel: bool = False):
    """Apply the full layer stack of a ported family. Returns (x, aux)."""
    if cfg.arch_type == "dense":
        def block(h, bp):
            return _self_block(cfg, bp, h, positions, use_kernel)
    else:
        def block(h, bp):
            return _mamba_block(cfg, bp, h, use_kernel)
    fn = _remat(block, remat)
    for bp in _unstack(params["blocks"], cfg.n_layers):
        x = fn(x, bp)
    return x, {}


def forward_train(cfg: ArchConfig, params: dict, batch: dict, *,
                  compute_dtype: torch.dtype = torch.float32, remat=False,
                  use_kernel: bool = False):
    """Full-sequence forward in `compute_dtype`. Returns (logits fp32
    (B, S, V), aux).  batch: {"tokens": (B, S) int64}."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    x = _embed(cfg, params, tokens, compute_dtype)
    positions = torch.arange(Sq, device=x.device)[None, :].expand(B, Sq)
    x, aux = _run_backbone(cfg, params, x, positions, remat=remat,
                           use_kernel=use_kernel)
    return _unembed(cfg, params, x), aux


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, S) next-token negative log-likelihoods of fp32 logits."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            compute_dtype: torch.dtype = torch.float32, remat=False,
            use_kernel: bool = False):
    """Next-token cross-entropy. Returns (loss, aux)."""
    logits, aux = forward_train(cfg, params, batch,
                                compute_dtype=compute_dtype, remat=remat,
                                use_kernel=use_kernel)
    return torch.mean(token_nll(logits, batch["targets"])), aux


# ---------------------------------------------------------------------------
# serving: cache init, prefill, single-token decode
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """Rolling-window caches only keep `window` slots (sub-quadratic decode)."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ArchConfig, batch_size: int, seq_len: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None) -> dict:
    """Zero-initialized decode cache for `seq_len` positions (the ssm
    family's state does not grow with the sequence)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    if cfg.arch_type == "dense":
        return {"attn": L.init_kv_cache(batch_size,
                                        _attn_cache_len(cfg, seq_len),
                                        cfg.n_kv_heads, cfg.hd, dtype, dev,
                                        (cfg.n_layers,))}
    return {"mamba": _mamba_cache_stack(cfg, cfg.n_layers, batch_size, dtype,
                                        dev)}


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


def _self_block_decode(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                       cache_l: dict, pos):
    h = L.apply_norm(bp["attn_norm"], x, cfg.norm)
    attn, new_cache = L.decode_self_attention(
        bp["attn"], h, cache_l, pos, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta,
        window=cfg.sliding_window)
    x = x + attn
    h = L.apply_norm(bp["mlp_norm"], x, cfg.norm)
    return x + L.mlp(bp["mlp"], h, act=cfg.act), new_cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, batch: dict, cache: dict):
    """One new token against the cache, computed in the parameters' dtype.

    batch: {"token": (B, 1) int64, "pos": absolute position of the new
    token, an int for every row or a (B,) tensor, one per row (unused by
    the ssm family)}.  Returns (logits fp32 (B, 1, V), new cache); the
    dense family writes the new K/V into `cache`'s tensors in place."""
    _require_ported(cfg)
    x = _embed(cfg, params, batch["token"])
    blocks = params["blocks"]
    new_cache = dict(cache)
    if cfg.arch_type == "dense":
        pos = torch.as_tensor(batch["pos"], device=x.device)
        kv = cache["attn"]
        for bp, kv_l in zip(_unstack(blocks, cfg.n_layers),
                            _unstack(kv, cfg.n_layers)):
            x, _ = _self_block_decode(cfg, bp, x, kv_l, pos)
        return _unembed(cfg, params, x), new_cache
    s = cfg.ssm
    mc = cache["mamba"]
    convs, ssms = [], []
    for bp, mc_l in zip(_unstack(blocks, cfg.n_layers),
                        _unstack(mc, cfg.n_layers)):
        hn = L.rmsnorm(bp["norm"], x)
        y, nc = S.mamba2_decode(bp["mixer"], hn, mc_l,
                                d_state=s.d_state,
                                n_heads=s.n_heads(cfg.d_model),
                                headdim=s.headdim, n_groups=s.n_groups)
        x = x + y
        convs.append(nc["conv"])
        ssms.append(nc["ssm"])
    new_cache["mamba"] = {"conv": torch.stack(convs),
                          "ssm": torch.stack(ssms)}
    return _unembed(cfg, params, x), new_cache


def _self_block(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                positions: torch.Tensor, use_kernel: bool,
                return_kv: bool = False):
    """One [attention + MLP] block over the full sequence; with
    return_kv also the post-rope (k, v) for the decode cache."""
    h = L.apply_norm(bp["attn_norm"], x, cfg.norm)
    attn = L.self_attention(
        bp["attn"], h, positions, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta,
        window=cfg.sliding_window, return_kv=return_kv,
        use_kernel=use_kernel)
    if return_kv:
        attn, kv = attn
    x = x + attn
    h = L.apply_norm(bp["mlp_norm"], x, cfg.norm)
    x = x + L.mlp(bp["mlp"], h, act=cfg.act)
    return (x, kv) if return_kv else x


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: dict, batch: dict, *,
            use_kernel: bool = True, cache_len: Optional[int] = None):
    """Process the prompt and build the decode cache, computed in the
    parameters' dtype.

    batch: {"tokens": (B, S) int64}.  `cache_len` reserves KV slots
    beyond the prompt for the decode steps (default: the prompt length;
    the ssm family's state does not grow, so it ignores it).  Returns
    (last-position logits fp32 (B, 1, V), cache).  `use_kernel` defaults
    to True (the reference's to False): each dense layer's causal
    attention goes to `kernels.flash_attn.ops.causal_attention` (kernel 8
    for tensors on the card, its plain version on the CPU), each ssm
    layer's intra-chunk SSD step to `kernels.ssd.ops.ssd_chunk` (kernel
    7); `use_kernel=False` keeps the plain expressions."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    x = _embed(cfg, params, tokens)
    blocks = params["blocks"]
    if cfg.arch_type == "dense":
        positions = torch.arange(Sq, device=x.device)[None, :].expand(B, Sq)
        window = cfg.sliding_window
        kv = L.init_kv_cache(B, L.kv_cache_len(Sq, window, cache_len),
                             cfg.n_kv_heads, cfg.hd, x.dtype, x.device,
                             (cfg.n_layers,))
        for i, bp in enumerate(_unstack(blocks, cfg.n_layers)):
            x, (k, v) = _self_block(cfg, bp, x, positions, use_kernel,
                                    return_kv=True)
            if window is None:  # slot == position; the rest stays zero
                kv["k"][i, :, :Sq] = k
                kv["v"][i, :, :Sq] = v
            else:
                kv_i = L.kv_to_cache(k, v, window, cache_len)
                kv["k"][i].copy_(kv_i["k"])
                kv["v"][i].copy_(kv_i["v"])
        return _unembed(cfg, params, x[:, -1:, :]), {"attn": kv}
    s = cfg.ssm
    convs, ssms = [], []
    for bp in _unstack(blocks, cfg.n_layers):
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
