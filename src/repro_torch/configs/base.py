"""Architecture config schema and registry (counterpart of
`repro/configs/base.py`).

Every ported architecture registers an `ArchConfig` via `register()`;
`get_config(name)` / `list_archs()` drive `--arch <id>` selection in the
launchers.  `reduced()` returns the family-preserving smoke-test variant
(<= 2 layers, d_model <= 512, <= 4 experts) used by the CPU tests.  The
dataclasses are plain copies of the reference's, field for field, so a
config crosses between the two packages by its fields.  `input_specs`
gives every model input of an assigned shape as a tensor on the meta
device (the reference's ShapeDtypeStruct stand-ins): shapes and dtypes,
no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------

INPUT_SHAPES: dict[str, dict] = {
    "train_4k": {"seq_len": 4_096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32_768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32_768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524_288, "global_batch": 1, "kind": "decode"},
}


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    every: int = 1          # MoE FFN on every `every`-th layer (1 = all)
    group_size: int = 2048
    capacity_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int
    headdim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256
    head_shard: bool = False   # shard SSD heads over the model mesh axis

    def n_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.headdim


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    """Zamba2-style: Mamba2 backbone with a weight-shared attention+MLP
    block applied every `attn_every` layers."""
    attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class VLMSpec:
    """Llama-3.2-Vision-style: cross-attention layers interleaved every
    `cross_every` decoder layers; the vision tower is a stub that provides
    (n_patches, d_vision) precomputed patch embeddings."""
    cross_every: int = 5
    n_patches: int = 1601
    d_vision: int = 4096


@dataclasses.dataclass(frozen=True)
class EncDecSpec:
    """Whisper-style encoder-decoder; the audio frontend is a stub that
    provides (n_frames, d_model) precomputed frame embeddings."""
    n_enc_layers: int = 4
    n_frames: int = 1500
    max_decode_len: int = 448


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    rope_theta: float = 1e6
    norm: str = "rms"                 # rms | ln
    act: str = "swiglu"               # swiglu | gelu
    attn_bias: bool = False           # qwen-style qkv bias
    attn_impl: str = "grouped"        # grouped | repeat
    softmax_dtype: str = "f32"        # f32 | bf16 attention-score dtype
    fused_proj: bool = False          # pack wk+wv and w_gate+w_up
    attn_seq_shard: bool = False      # shard scores' query-seq dim on model
    sliding_window: Optional[int] = None   # sub-quadratic attention variant
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    hybrid: Optional[HybridSpec] = None
    vlm: Optional[VLMSpec] = None
    encdec: Optional[EncDecSpec] = None
    tie_embeddings: bool = False
    source: str = ""                  # citation bracket from the assignment

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def supports_shape(self, shape_name: str) -> bool:
        """long_500k needs sub-quadratic attention (SSM/hybrid natively, or
        a sliding-window variant)."""
        if shape_name == "long_500k":
            return (self.arch_type in ("ssm", "hybrid")
                    or self.sliding_window is not None)
        return True

    def with_sliding_window(self, window: int = 8192) -> "ArchConfig":
        """The sub-quadratic variant used for long_500k on full-attention
        archs (rolling KV cache of `window` slots)."""
        return dataclasses.replace(
            self, name=f"{self.name}-sw{window}", sliding_window=window)

    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke variant: <=2 layers, d_model<=512,
        <=4 experts, small vocab."""
        d_model = min(self.d_model, 256)
        n_kv = min(self.n_kv_heads, 2) if self.n_kv_heads else 0
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        if n_heads:
            n_heads = (n_heads // n_kv) * n_kv or n_kv
        repl = {
            "n_layers": min(self.n_layers, 2),
            "d_model": d_model,
            "n_heads": n_heads,
            "n_kv_heads": n_kv,
            "d_ff": min(self.d_ff, 512) if self.d_ff else 0,
            "vocab": min(self.vocab, 512),
            "head_dim": 64,
            "sliding_window": 64 if self.sliding_window else None,
        }
        if self.moe:
            repl["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), group_size=64,
                every=min(self.moe.every, 2))
        if self.ssm:
            repl["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 16), headdim=32,
                chunk=16)
        if self.hybrid:
            repl["hybrid"] = dataclasses.replace(self.hybrid, attn_every=2)
        if self.vlm:
            repl["vlm"] = dataclasses.replace(
                self.vlm, cross_every=2, n_patches=16, d_vision=d_model)
        if self.encdec:
            repl["encdec"] = dataclasses.replace(
                self.encdec, n_enc_layers=2, n_frames=24, max_decode_len=64)
        return dataclasses.replace(self, name=self.name + "-reduced", **repl)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config: {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import the config modules for their registration side effects
    from repro_torch import configs as _c  # noqa: F401
    _c.load_all()


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins; never allocate)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape_name: str,
                token_dtype: torch.dtype = torch.int32) -> dict:
    """Meta-device tensors for every model input of the given shape.

    train:   {tokens (B, S), targets (B, S)}  [+ modality stubs]
    prefill: {tokens (B, S)}                  [+ modality stubs]
    decode:  {token (B, 1), pos ()}; the cache's come from the model via
             `repro_torch.models.transformer.cache_specs`.
    The stubs are bf16: patches (B, n_patches, d_vision) for the vlm
    family, frames (B, n_frames, d_model) for the audio family.
    """
    spec = INPUT_SHAPES[shape_name]
    B, S = spec["global_batch"], spec["seq_len"]
    kind = spec["kind"]

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: dict = {}
    if kind == "train":
        out["tokens"] = sds((B, S), token_dtype)
        out["targets"] = sds((B, S), token_dtype)
    elif kind == "prefill":
        out["tokens"] = sds((B, S), token_dtype)
    else:  # decode
        out["token"] = sds((B, 1), token_dtype)
        out["pos"] = sds((), torch.int32)
    if cfg.vlm is not None:
        out["patches"] = sds((B, cfg.vlm.n_patches, cfg.vlm.d_vision),
                             torch.bfloat16)
    if cfg.encdec is not None:
        out["frames"] = sds((B, cfg.encdec.n_frames, cfg.d_model),
                            torch.bfloat16)
    return out
