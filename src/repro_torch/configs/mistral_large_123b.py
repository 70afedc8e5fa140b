"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]

88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-large-123b",
    arch_type="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    rope_theta=1e6,
    head_dim=128,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
))
