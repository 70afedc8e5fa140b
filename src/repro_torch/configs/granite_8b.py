"""granite-8b (code) [arXiv:2405.04324]

36L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 49152.
Llama-style architecture for code.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    rope_theta=1e4,
    source="arXiv:2405.04324",
))
