"""Decoder LM over the reference's parameter tree (counterpart of
`repro/models/transformer.py`), all six of its families:

  dense   — uniform [attention + MLP] blocks
  moe     — [attention + (MoE FFN every k-th | dense MLP)] blocks,
            k = cfg.moe.every: (k - 1) dense blocks, then one MoE block
  ssm     — uniform Mamba2 blocks (attention-free)
  hybrid  — Mamba2 backbone; ONE weight-shared [attention + MLP] block
            applied after every cfg.hybrid.attn_every-th layer (Zamba2)
  vlm     — groups of (cross_every - 1) self blocks + 1 gated
            cross-attention block over stub vision patch embeddings
            (Llama-3.2-Vision); batch["patches"] (B, n_patches, d_vision)
  audio   — encoder (unmasked self blocks over stub frame embeddings,
            then enc_norm) + decoder of [self block, gated cross block]
            pairs (Whisper); batch["frames"] (B, n_frames, d_model)

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
the stack where the reference scans: the moe family's interleave and the
hybrid family's shared block are read off the layer index (the
reference reshapes its stacks into groups, and the hybrid's training
forward takes the shared block under `lax.cond`), and the caches keep
the reference's layout: the moe family's attention cache in layer order,
the hybrid's Mamba2 cache over all its layers in order and its attention
cache one row per use of the shared block, the vlm's self-attention
cache at row g * (cross_every - 1) + j for self layer j of group g and
its cross cache one row per group, the audio decoder's one row per
layer for each.  Serving runs under
`torch.inference_mode()`.  The decode writes each attention layer's new
K/V into the cache in place (the reference returns a new cache).

Training (`forward_train`, `loss_fn`) is differentiable by autograd and,
as the reference's default, takes the plain expressions
(`use_kernel=False`): the CUDA kernels have no backward, and their
wrappers raise when an operand requires grad.  `remat=True` recomputes
each block in the backward pass (`torch.utils.checkpoint`); the
reference's `"save_ar"`, which keeps the activations after a
tensor-parallel all-reduce, is full remat here (one card runs no such
all-reduce).  Stacked leaves are split once per forward (`unbind`), so
each leaf's gradient is assembled once, not once per layer; the
hybrid's shared block gathers the gradient of all its uses.  The moe
family's loss adds 0.01 times `aux["moe_aux_loss"]`, the mean over its
MoE layers of the load-balancing loss.

The vlm prefill projects each cross block's K/V from the patches once
(cast to the parameters' dtype) and both attends them and keeps them as
the cross cache; the reference projects them twice, the second time
from the uncast patches (the same numbers in float32).  As in the
reference, `_vlm_layout` builds n_layers // cross_every groups and a
remainder of layers is not built (no config has one), and the cross
path is dead at init: `gate` starts at 0 and tanh(0) scales the cross
output to 0.

The settings of the reference's `launch.dryrun.optimize_config`, and
its `fused_proj` field (which `optimize_config` does not set), are
read from the config as the reference reads them: `fused_proj` packs
the self blocks' (and the moe blocks' and the shared block's) K/V and
gate/up projections, never the cross blocks'; `attn_impl` reaches every
attention; `softmax_dtype` reaches the full-sequence
forward (training, and the audio encoder in the prefill) but not the
prefill's causal self-attention, which the reference takes in float32
whatever the config (its `_self_block_prefill`), nor decode or
cross-attention.  So a prefill under `optimize_config(cfg, "prefill")`
keeps kernel 8 (`layers.self_attention`).  `attn_seq_shard` and
`ssm.head_shard` are mesh hints that change nothing on one card, so
`attn_seq_shard` is not read.
`cache_specs` is `init_cache` on the meta device.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from . import layers as L
from . import moe as M
from . import ssm as S

PORTED_FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.arch_type not in PORTED_FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r} ({cfg.name})")
    if cfg.arch_type == "moe" and cfg.n_layers % cfg.moe.every:
        raise ValueError(f"{cfg.name}: the moe interleave needs n_layers "
                         f"divisible by every={cfg.moe.every}")


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
                     stack: tuple[int, ...] = (), moe: bool = False) -> dict:
    """[attention + MLP] blocks, or [attention + MoE FFN] ones with
    `moe`."""
    d = cfg.d_model
    p = {
        "attn_norm": _norm_init(cfg, d, dtype, device, stack),
        "attn": L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd, dtype, device, stack,
                                 bias=cfg.attn_bias, fused=cfg.fused_proj),
        "mlp_norm": _norm_init(cfg, d, dtype, device, stack),
    }
    if moe:
        p["moe"] = M.init_moe(gen, _moe_dims(cfg), dtype, device, stack)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dtype, device, stack,
                              act=cfg.act, fused=cfg.fused_proj)
    return p


def _init_mamba_block(gen: Optional[torch.Generator], cfg: ArchConfig,
                      dtype: torch.dtype, device: torch.device,
                      stack: tuple[int, ...]) -> dict:
    s, d = cfg.ssm, cfg.d_model
    return {
        "norm": L.init_norm(d, dtype, device, stack),
        "mixer": S.init_mamba2(gen, d, s.d_state, s.n_heads(d), s.headdim,
                               s.n_groups, s.d_conv, dtype, device, stack),
    }


def _init_cross_block(gen: Optional[torch.Generator], cfg: ArchConfig,
                      dtype: torch.dtype, device: torch.device,
                      stack: tuple[int, ...]) -> dict:
    """[gated cross-attention + MLP] blocks: K/V projected from the
    vision width (vlm) or d_model (audio), `gate` zero-initialised."""
    d = cfg.d_model
    kv_in = cfg.vlm.d_vision if cfg.vlm else d
    return {
        "attn_norm": _norm_init(cfg, d, dtype, device, stack),
        "attn": L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd, dtype, device, stack,
                                 kv_input_dim=kv_in),
        "mlp_norm": _norm_init(cfg, d, dtype, device, stack),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, dtype, device, stack,
                          act=cfg.act),
        "gate": torch.zeros((*stack, 1), dtype=dtype, device=device),
    }


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> dict:
    """The parameter tree, drawn from `gen` on `device` (the card by
    default; `gen` must live there).  On `device="meta"` nothing is drawn
    and `gen` may be None: shapes only.

    The reference's initialisers (N(0, 0.02) embedding, dense layers and
    experts N(0, 1)/sqrt(fan_in), conv taps N(0, 0.1), a_log =
    log(linspace(1, 16, H)), unit norms, zero biases), each layer its own
    draws; the numbers differ from `jax.random`'s for any seed.  The MoE
    router is float32 whatever `dtype`, as the reference's.
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
    at = cfg.arch_type
    if at == "dense":
        p["blocks"] = _init_self_block(gen, cfg, dtype, dev, (cfg.n_layers,))
    elif at == "moe":
        n_moe = cfg.n_layers // cfg.moe.every
        p["moe_blocks"] = _init_self_block(gen, cfg, dtype, dev, (n_moe,),
                                           moe=True)
        if cfg.n_layers > n_moe:
            p["blocks"] = _init_self_block(gen, cfg, dtype, dev,
                                           (cfg.n_layers - n_moe,))
    elif at == "vlm":
        n_groups, n_self = _vlm_layout(cfg)
        p["blocks"] = _init_self_block(gen, cfg, dtype, dev,
                                       (n_groups * n_self,))
        p["cross_blocks"] = _init_cross_block(gen, cfg, dtype, dev,
                                              (n_groups,))
    elif at == "audio":
        p["enc_blocks"] = _init_self_block(gen, cfg, dtype, dev,
                                           (cfg.encdec.n_enc_layers,))
        p["enc_norm"] = _norm_init(cfg, d, dtype, dev)
        p["blocks"] = _init_self_block(gen, cfg, dtype, dev, (cfg.n_layers,))
        p["cross_blocks"] = _init_cross_block(gen, cfg, dtype, dev,
                                              (cfg.n_layers,))
    else:
        p["blocks"] = _init_mamba_block(gen, cfg, dtype, dev,
                                        (cfg.n_layers,))
        if at == "hybrid":
            p["shared_attn"] = _init_self_block(gen, cfg, dtype, dev)
    return p


def _softmax_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.softmax_dtype == "bf16" else torch.float32


def _vlm_layout(cfg: ArchConfig) -> tuple[int, int]:
    """(n_groups, self layers per group): groups of (cross_every - 1)
    self layers followed by one cross layer; n_layers // cross_every
    groups, as the reference (a remainder of layers is not built)."""
    ce = cfg.vlm.cross_every
    return cfg.n_layers // ce, ce - 1


def _cross_layout(cfg: ArchConfig) -> tuple[int, int]:
    """(cross blocks, self blocks before each) of the vlm and audio
    families: the vlm's groups, or one self block per audio layer."""
    return _vlm_layout(cfg) if cfg.vlm else (cfg.n_layers, 1)


def _cross_groups(cfg: ArchConfig, params: dict) -> list:
    """[(the group's self blocks, its cross block)] in layer order; self
    block j of group g is stacked layer (and self-cache row)
    g * n_self + j."""
    n_groups, n_self = _cross_layout(cfg)
    selfs = _unstack(params["blocks"], n_groups * n_self)
    crosses = _unstack(params["cross_blocks"], n_groups)
    return [(selfs[g * n_self:(g + 1) * n_self], crosses[g])
            for g in range(n_groups)]


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


def _attn_layers(cfg: ArchConfig, params: dict) -> list[dict]:
    """The blocks of a dense or moe model in layer order: for the moe
    family (every - 1) dense blocks, then one MoE block, repeated."""
    if cfg.arch_type == "dense":
        return _unstack(params["blocks"], cfg.n_layers)
    every = cfg.moe.every
    n_moe = cfg.n_layers // every
    moe = _unstack(params["moe_blocks"], n_moe)
    dense = (_unstack(params["blocks"], cfg.n_layers - n_moe)
             if every > 1 else [])
    out: list[dict] = []
    for g in range(n_moe):
        out += dense[g * (every - 1):(g + 1) * (every - 1)] + [moe[g]]
    return out


def _shared_use(cfg: ArchConfig, i: int) -> Optional[int]:
    """The use (attention-cache row) of the hybrid family's shared block
    after Mamba2 layer i, or None where it does not run (and for the ssm
    family)."""
    if cfg.arch_type != "hybrid":
        return None
    ae = cfg.hybrid.attn_every
    return (i + 1) // ae - 1 if (i + 1) % ae == 0 else None


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
# blocks over the full sequence
# ---------------------------------------------------------------------------

def _moe_dims(cfg: ArchConfig, decode: bool = False) -> M.MoEDims:
    """The MoE FFN's dims.  Decode groups hold only B tokens, so the
    training-time capacity int(cf * k * group / E) can round below the
    tokens one expert may receive and drop a token's FFN output; decode
    takes cf = E, a capacity of k * group, which drops nothing (each
    token sends an expert at most one copy), as the reference's decode."""
    m = cfg.moe
    cf = float(m.n_experts) if decode else m.capacity_factor
    return M.MoEDims(m.n_experts, m.top_k, cfg.d_model, cfg.d_ff,
                     m.group_size, cf)


def _ffn(cfg: ArchConfig, bp: dict, h: torch.Tensor, decode: bool = False):
    """The block's FFN: its MLP, or its MoE FFN where it has one.
    Returns (y, the MoE aux dict or None)."""
    if "moe" not in bp:
        return L.mlp(bp["mlp"], h, act=cfg.act), None
    return M.moe_ffn(bp["moe"], h, _moe_dims(cfg, decode))


def _self_block(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                positions: torch.Tensor, use_kernel: bool,
                return_kv: bool = False, causal: bool = True):
    """One [attention + MLP or MoE FFN] block over the full sequence
    (unmasked with `causal=False`: the audio encoder's).  Returns (x, the
    MoE aux dict or None, and with return_kv the post-rope (k, v) for the
    decode cache, else None).  return_kv is the prefill's block, which
    takes the softmax in float32, as the reference's
    `_self_block_prefill`."""
    h = L.apply_norm(bp["attn_norm"], x, cfg.norm)
    attn = L.self_attention(
        bp["attn"], h, positions, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta,
        causal=causal, window=cfg.sliding_window if causal else None,
        return_kv=return_kv, use_kernel=use_kernel, impl=cfg.attn_impl,
        softmax_dtype=torch.float32 if return_kv else _softmax_dtype(cfg))
    kv = None
    if return_kv:
        attn, kv = attn
    x = x + attn
    h = L.apply_norm(bp["mlp_norm"], x, cfg.norm)
    y, aux = _ffn(cfg, bp, h)
    return x + y, aux, kv


def _gated(bp: dict, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    return x + torch.tanh(bp["gate"].to(x.dtype)) * attn


def _cross_block(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                 memory: torch.Tensor) -> torch.Tensor:
    """One [gated cross-attention + MLP] block over a memory sequence."""
    h = L.apply_norm(bp["attn_norm"], x, cfg.norm)
    x = _gated(bp, x, L.cross_attention(
        bp["attn"], h, memory, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, impl=cfg.attn_impl))
    h = L.apply_norm(bp["mlp_norm"], x, cfg.norm)
    return x + L.mlp(bp["mlp"], h, act=cfg.act)


def _cross_block_decode(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                        ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """`_cross_block` against the memory's precomputed K/V."""
    h = L.apply_norm(bp["attn_norm"], x, cfg.norm)
    x = _gated(bp, x, L.cross_attention_cached(
        bp["attn"], h, ck, cv, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, impl=cfg.attn_impl))
    h = L.apply_norm(bp["mlp_norm"], x, cfg.norm)
    return x + L.mlp(bp["mlp"], h, act=cfg.act)


def _mamba_block(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                 use_kernel: bool) -> torch.Tensor:
    s = cfg.ssm
    h = L.rmsnorm(bp["norm"], x)
    return x + S.mamba2_block(
        bp["mixer"], h, d_state=s.d_state, n_heads=s.n_heads(cfg.d_model),
        headdim=s.headdim, n_groups=s.n_groups, chunk=s.chunk,
        use_kernel=use_kernel, head_shard=s.head_shard)


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


def _encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, *,
            remat=False) -> torch.Tensor:
    """The audio encoder: unmasked self blocks over the frames, roped at
    frame positions 0..F-1, then enc_norm."""
    B, F = frames.shape[:2]
    enc_pos = torch.arange(F, device=frames.device)[None, :].expand(B, F)
    block = _remat(lambda h, bp: _self_block(cfg, bp, h, enc_pos, False,
                                             causal=False)[0], remat)
    x = frames
    for bp in _unstack(params["enc_blocks"], cfg.encdec.n_enc_layers):
        x = block(x, bp)
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


def _memory(cfg: ArchConfig, batch: dict, dtype: torch.dtype):
    """The stub modality input the cross blocks attend, cast to `dtype`:
    patches (vlm) or frames (audio)."""
    return batch["patches" if cfg.arch_type == "vlm" else "frames"].to(dtype)


def _run_backbone(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  positions: torch.Tensor, batch: dict, *, remat=False,
                  use_kernel: bool = False):
    """Apply the full layer stack of a ported family. Returns (x, aux);
    the moe family's aux holds "moe_aux_loss", the mean over its MoE
    layers of their load-balancing losses."""
    aux: dict[str, torch.Tensor] = {}
    block = _remat(lambda h, bp: _self_block(cfg, bp, h, positions,
                                             use_kernel)[:2], remat)
    at = cfg.arch_type
    if at in ("vlm", "audio"):
        memory = _memory(cfg, batch, x.dtype)
        if at == "audio":
            memory = _encode(cfg, params, memory, remat=remat)
        cross = _remat(lambda h, bp, m: _cross_block(cfg, bp, h, m), remat)
        for selfs, cb in _cross_groups(cfg, params):
            for bp in selfs:
                x, _ = block(x, bp)
            x = cross(x, cb, memory)
        return x, aux
    if at in ("dense", "moe"):
        losses = []
        for bp in _attn_layers(cfg, params):
            x, a = block(x, bp)
            if a is not None:
                losses.append(a["aux_loss"])
        if losses:
            aux["moe_aux_loss"] = torch.mean(torch.stack(losses))
        return x, aux
    mamba = _remat(lambda h, bp: _mamba_block(cfg, bp, h, use_kernel), remat)
    for i, bp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        x = mamba(x, bp)
        if _shared_use(cfg, i) is not None:
            x, _ = block(x, params["shared_attn"])
    return x, aux


def forward_train(cfg: ArchConfig, params: dict, batch: dict, *,
                  compute_dtype: torch.dtype = torch.float32, remat=False,
                  use_kernel: bool = False):
    """Full-sequence forward in `compute_dtype`. Returns (logits fp32
    (B, S, V), aux).  batch: {"tokens": (B, S) int64}, plus "patches"
    (vlm) or "frames" (audio)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    x = _embed(cfg, params, tokens, compute_dtype)
    positions = torch.arange(Sq, device=x.device)[None, :].expand(B, Sq)
    x, aux = _run_backbone(cfg, params, x, positions, batch, remat=remat,
                           use_kernel=use_kernel)
    return _unembed(cfg, params, x), aux


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, S) next-token negative log-likelihoods of fp32 logits."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            compute_dtype: torch.dtype = torch.float32, remat=False,
            use_kernel: bool = False):
    """Next-token cross-entropy, plus 0.01 x the MoE aux loss where the
    model has one. Returns (loss, aux)."""
    logits, aux = forward_train(cfg, params, batch,
                                compute_dtype=compute_dtype, remat=remat,
                                use_kernel=use_kernel)
    loss = torch.mean(token_nll(logits, batch["targets"]))
    if "moe_aux_loss" in aux:
        loss = loss + 0.01 * aux["moe_aux_loss"]
    return loss, aux


# ---------------------------------------------------------------------------
# serving: cache init, prefill, single-token decode
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """Rolling-window caches only keep `window` slots (sub-quadratic decode)."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def _n_attn(cfg: ArchConfig) -> int:
    """Rows of the self-attention cache: one per layer, for the hybrid
    family one per use of the shared block, for the vlm family one per
    self layer of its groups."""
    if cfg.arch_type == "hybrid":
        return cfg.n_layers // cfg.hybrid.attn_every
    if cfg.arch_type == "vlm":
        n_groups, n_self = _vlm_layout(cfg)
        return n_groups * n_self
    return cfg.n_layers


def _cross_cache(cfg: ArchConfig, B: int, dtype: torch.dtype,
                 device: torch.device) -> dict:
    """Zero cross-attention K/V, (n_groups | n_layers, B, n_patches |
    n_frames, Hkv, hd), which the prefill fills."""
    T_mem = cfg.vlm.n_patches if cfg.vlm else cfg.encdec.n_frames
    return L.init_kv_cache(B, T_mem, cfg.n_kv_heads, cfg.hd, dtype, device,
                           (_cross_layout(cfg)[0],))


def init_cache(cfg: ArchConfig, batch_size: int, seq_len: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None) -> dict:
    """Zero-initialized decode cache for `seq_len` positions: "attn" K/V
    for the attention families, "mamba" conv and SSM states (which do not
    grow with the sequence) for ssm, both for hybrid, and "cross" K/V
    over the patches or frames for vlm and audio (zero here: the prefill
    fills them; the reference's `batch=` argument, which fails for a vlm
    config, is not ported)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    cache = {}
    if cfg.arch_type != "ssm":
        cache["attn"] = L.init_kv_cache(
            batch_size, _attn_cache_len(cfg, seq_len), cfg.n_kv_heads,
            cfg.hd, dtype, dev, (_n_attn(cfg),))
    if cfg.arch_type in ("ssm", "hybrid"):
        cache["mamba"] = _mamba_cache_stack(cfg, cfg.n_layers, batch_size,
                                            dtype, dev)
    if cfg.arch_type in ("vlm", "audio"):
        cache["cross"] = _cross_cache(cfg, batch_size, dtype, dev)
    return cache


def cache_specs(cfg: ArchConfig, batch_size: int, seq_len: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode cache's tree of shapes and dtypes: `init_cache` on the
    meta device, which allocates nothing (the reference's `cache_specs`,
    a `jax.eval_shape` of its `init_cache`)."""
    return init_cache(cfg, batch_size, seq_len, dtype=dtype, device="meta")


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
        window=cfg.sliding_window, impl=cfg.attn_impl)
    x = x + attn
    h = L.apply_norm(bp["mlp_norm"], x, cfg.norm)
    y, _ = _ffn(cfg, bp, h, decode=True)
    return x + y, new_cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, batch: dict, cache: dict):
    """One new token against the cache, computed in the parameters' dtype.

    batch: {"token": (B, 1) int64, "pos": absolute position of the new
    token, an int for every row or a (B,) tensor, one per row (unused by
    the ssm family)}.  Returns (logits fp32 (B, 1, V), new cache); the
    attention layers write the new K/V into `cache`'s tensors in place
    (the cross blocks read the prefill's cross K/V),
    the Mamba2 states come back as new tensors.  The MoE FFN decodes at a
    capacity that drops no token (`_moe_dims`), so every row is decoded
    as it would be alone."""
    _require_ported(cfg)
    x = _embed(cfg, params, batch["token"])
    new_cache = dict(cache)
    at = cfg.arch_type
    if at != "ssm":
        pos = torch.as_tensor(batch["pos"], device=x.device)
        kv = _unstack(cache["attn"], _n_attn(cfg))
    if at in ("dense", "moe"):
        for bp, kv_l in zip(_attn_layers(cfg, params), kv):
            x, _ = _self_block_decode(cfg, bp, x, kv_l, pos)
        return _unembed(cfg, params, x), new_cache
    if at in ("vlm", "audio"):
        kv = iter(kv)
        cross = cache["cross"]
        for g, (selfs, cb) in enumerate(_cross_groups(cfg, params)):
            for bp in selfs:
                x, _ = _self_block_decode(cfg, bp, x, next(kv), pos)
            x = _cross_block_decode(cfg, cb, x, cross["k"][g], cross["v"][g])
        return _unembed(cfg, params, x), new_cache
    s = cfg.ssm
    convs, ssms = [], []
    for i, (bp, mc_l) in enumerate(zip(
            _unstack(params["blocks"], cfg.n_layers),
            _unstack(cache["mamba"], cfg.n_layers))):
        hn = L.rmsnorm(bp["norm"], x)
        y, nc = S.mamba2_decode(bp["mixer"], hn, mc_l,
                                d_state=s.d_state,
                                n_heads=s.n_heads(cfg.d_model),
                                headdim=s.headdim, n_groups=s.n_groups)
        x = x + y
        convs.append(nc["conv"])
        ssms.append(nc["ssm"])
        use = _shared_use(cfg, i)
        if use is not None:
            x, _ = _self_block_decode(cfg, params["shared_attn"], x, kv[use],
                                      pos)
    new_cache["mamba"] = {"conv": torch.stack(convs),
                          "ssm": torch.stack(ssms)}
    return _unembed(cfg, params, x), new_cache


def _prefill_attn(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                  positions: torch.Tensor, use_kernel: bool, kv: dict,
                  row: int, cache_len: Optional[int]) -> torch.Tensor:
    """One attention block of the prefill, its K/V written into row `row`
    of the stacked cache `kv`."""
    x, _, (k, v) = _self_block(cfg, bp, x, positions, use_kernel,
                               return_kv=True)
    window = cfg.sliding_window
    if window is None:  # slot == position; the rest stays zero
        Sq = k.shape[1]
        kv["k"][row, :, :Sq] = k
        kv["v"][row, :, :Sq] = v
    else:
        kv_i = L.kv_to_cache(k, v, window, cache_len)
        kv["k"][row].copy_(kv_i["k"])
        kv["v"][row].copy_(kv_i["v"])
    return x


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: dict, batch: dict, *,
            use_kernel: bool = True, cache_len: Optional[int] = None):
    """Process the prompt and build the decode cache, computed in the
    parameters' dtype.

    batch: {"tokens": (B, S) int64}, plus "patches" (vlm) or "frames"
    (audio), cast to the parameters' dtype.  `cache_len` reserves KV slots
    beyond the prompt for the decode steps (default: the prompt length;
    the ssm family's state does not grow, so it ignores it).  Returns
    (last-position logits fp32 (B, 1, V), cache).  `use_kernel` defaults
    to True (the reference's to False): each attention block's causal
    attention goes to `kernels.flash_attn.ops.causal_attention` (kernel
    8 for tensors on the card, its plain version on the CPU), each
    Mamba2 layer's intra-chunk SSD step to `kernels.ssd.ops.ssd_chunk`
    (kernel 7); `use_kernel=False` keeps the plain expressions.  The MoE
    FFN, the audio encoder's unmasked attention and every
    cross-attention are plain expressions either way.  The vlm and audio
    families project each cross block's K/V once, write them into the
    cross cache and attend them there (`_cross_block_decode`)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    x = _embed(cfg, params, tokens)
    at = cfg.arch_type
    positions = torch.arange(Sq, device=x.device)[None, :].expand(B, Sq)
    cache: dict[str, Any] = {}
    if at != "ssm":
        cache["attn"] = L.init_kv_cache(
            B, L.kv_cache_len(Sq, cfg.sliding_window, cache_len),
            cfg.n_kv_heads, cfg.hd, x.dtype, x.device, (_n_attn(cfg),))
    if at in ("dense", "moe"):
        for i, bp in enumerate(_attn_layers(cfg, params)):
            x = _prefill_attn(cfg, bp, x, positions, use_kernel,
                              cache["attn"], i, cache_len)
        return _unembed(cfg, params, x[:, -1:, :]), cache
    if at in ("vlm", "audio"):
        memory = _memory(cfg, batch, x.dtype)
        if at == "audio":
            memory = _encode(cfg, params, memory)
        cross = cache["cross"] = _cross_cache(cfg, B, x.dtype, x.device)
        row = 0
        for g, (selfs, cb) in enumerate(_cross_groups(cfg, params)):
            for bp in selfs:
                x = _prefill_attn(cfg, bp, x, positions, use_kernel,
                                  cache["attn"], row, cache_len)
                row += 1
            cross["k"][g], cross["v"][g] = L.project_cross_kv(
                cb["attn"], memory, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd)
            x = _cross_block_decode(cfg, cb, x, cross["k"][g],
                                    cross["v"][g])
        return _unembed(cfg, params, x[:, -1:, :]), cache
    s = cfg.ssm
    convs, ssms = [], []
    for i, bp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        h = L.rmsnorm(bp["norm"], x)
        y, mc = S.mamba2_prefill(
            bp["mixer"], h, d_state=s.d_state,
            n_heads=s.n_heads(cfg.d_model), headdim=s.headdim,
            n_groups=s.n_groups, chunk=s.chunk, use_kernel=use_kernel,
            head_shard=s.head_shard)
        x = x + y
        convs.append(mc["conv"])
        ssms.append(mc["ssm"])
        use = _shared_use(cfg, i)
        if use is not None:
            x = _prefill_attn(cfg, params["shared_attn"], x, positions,
                              use_kernel, cache["attn"], use, cache_len)
    cache["mamba"] = {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
    return _unembed(cfg, params, x[:, -1:, :]), cache
