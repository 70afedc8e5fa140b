"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Scout-17B-16E family]

48L, d_model 5120, 40 heads (GQA kv=8), per-expert d_ff 8192,
vocab 202048, 128 experts top-1.  MoE on every other layer (the Llama-4
interleave) puts the total at ~400B with ~17B active per token.
"""
from .base import ArchConfig, MoESpec, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    rope_theta=5e5,
    moe=MoESpec(n_experts=128, top_k=1, every=2),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
