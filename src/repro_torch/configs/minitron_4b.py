"""minitron-4b (pruned nemotron) [arXiv:2407.14679]

32L, d_model 3072, 24 heads (GQA kv=8), d_ff 9216, vocab 256000.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-4b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    rope_theta=1e4,
    head_dim=128,
    source="arXiv:2407.14679",
))
