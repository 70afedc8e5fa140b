"""Decoder LM over the reference's parameter tree (counterpart of
`repro/models/transformer.py`), four of its six families:

  dense   — uniform [attention + MLP] blocks
  moe     — [attention + (MoE FFN every k-th | dense MLP)] blocks,
            k = cfg.moe.every: (k - 1) dense blocks, then one MoE block
  ssm     — uniform Mamba2 blocks (attention-free)
  hybrid  — Mamba2 backbone; ONE weight-shared [attention + MLP] block
            applied after every cfg.hybrid.attn_every-th layer (Zamba2)

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
cache one row per use of the shared block.  Serving runs under
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

The vlm and audio families raise `NotImplementedError`: they wait for
ROADMAP.md §1 item 4.  So do the attention knobs no config sets and the
launch layer's dry-run would (`attn_impl="repeat"`, a bf16 softmax,
`fused_proj`, `attn_seq_shard`; ROADMAP.md §1 item 5).
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

PORTED_FAMILIES = ("dense", "ssm", "hybrid", "moe")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.arch_type not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) is not ported; only "
            f"the {', '.join(PORTED_FAMILIES)} families are (the vlm and "
            "audio families: ROADMAP.md §1 item 4)")
    for knob, ported in (("attn_impl", "grouped"), ("softmax_dtype", "f32"),
                         ("fused_proj", False), ("attn_seq_shard", False)):
        if getattr(cfg, knob) != ported:
            raise NotImplementedError(
                f"{knob}={getattr(cfg, knob)!r} ({cfg.name}) is not ported "
                "(ROADMAP.md §1 item 5)")
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
                                 bias=cfg.attn_bias),
        "mlp_norm": _norm_init(cfg, d, dtype, device, stack),
    }
    if moe:
        p["moe"] = M.init_moe(gen, _moe_dims(cfg), dtype, device, stack)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dtype, device, stack,
                              act=cfg.act)
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
    else:
        p["blocks"] = _init_mamba_block(gen, cfg, dtype, dev,
                                        (cfg.n_layers,))
        if at == "hybrid":
            p["shared_attn"] = _init_self_block(gen, cfg, dtype, dev)
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
                return_kv: bool = False):
    """One [attention + MLP or MoE FFN] block over the full sequence.
    Returns (x, the MoE aux dict or None, and with return_kv the
    post-rope (k, v) for the decode cache, else None)."""
    h = L.apply_norm(bp["attn_norm"], x, cfg.norm)
    attn = L.self_attention(
        bp["attn"], h, positions, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta,
        window=cfg.sliding_window, return_kv=return_kv,
        use_kernel=use_kernel)
    kv = None
    if return_kv:
        attn, kv = attn
    x = x + attn
    h = L.apply_norm(bp["mlp_norm"], x, cfg.norm)
    y, aux = _ffn(cfg, bp, h)
    return x + y, aux, kv


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


def _run_backbone(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, remat=False,
                  use_kernel: bool = False):
    """Apply the full layer stack of a ported family. Returns (x, aux);
    the moe family's aux holds "moe_aux_loss", the mean over its MoE
    layers of their load-balancing losses."""
    aux: dict[str, torch.Tensor] = {}
    block = _remat(lambda h, bp: _self_block(cfg, bp, h, positions,
                                             use_kernel)[:2], remat)
    if cfg.arch_type in ("dense", "moe"):
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
    """Rows of the attention cache: one per layer, or for the hybrid
    family one per use of the shared block."""
    if cfg.arch_type == "hybrid":
        return cfg.n_layers // cfg.hybrid.attn_every
    return cfg.n_layers


def init_cache(cfg: ArchConfig, batch_size: int, seq_len: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None) -> dict:
    """Zero-initialized decode cache for `seq_len` positions: "attn" K/V
    for the attention families, "mamba" conv and SSM states (which do not
    grow with the sequence) for ssm, both for hybrid."""
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
    return cache


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
    y, _ = _ffn(cfg, bp, h, decode=True)
    return x + y, new_cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, batch: dict, cache: dict):
    """One new token against the cache, computed in the parameters' dtype.

    batch: {"token": (B, 1) int64, "pos": absolute position of the new
    token, an int for every row or a (B,) tensor, one per row (unused by
    the ssm family)}.  Returns (logits fp32 (B, 1, V), new cache); the
    attention layers write the new K/V into `cache`'s tensors in place,
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

    batch: {"tokens": (B, S) int64}.  `cache_len` reserves KV slots
    beyond the prompt for the decode steps (default: the prompt length;
    the ssm family's state does not grow, so it ignores it).  Returns
    (last-position logits fp32 (B, 1, V), cache).  `use_kernel` defaults
    to True (the reference's to False): each attention block's causal
    attention goes to `kernels.flash_attn.ops.causal_attention` (kernel
    8 for tensors on the card, its plain version on the CPU), each
    Mamba2 layer's intra-chunk SSD step to `kernels.ssd.ops.ssd_chunk`
    (kernel 7); `use_kernel=False` keeps the plain expressions.  The MoE
    FFN is a plain expression either way."""
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
