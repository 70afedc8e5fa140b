"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]

32L, d_model 4096, 32 heads (GQA kv=8), per-expert d_ff 6400, vocab 32064,
16 experts top-2 on every layer.  ~42B total params, ~6.6B active.
"""
from .base import ArchConfig, MoESpec, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    rope_theta=1e4,
    moe=MoESpec(n_experts=16, top_k=2, every=1),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
