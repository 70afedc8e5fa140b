"""mamba2-1.3b [arXiv:2405.21060]

48 Mamba2 (SSD) layers, d_model 2048, attention-free, ssm_state 128,
vocab 50280.  d_ff = 0: no separate MLP (the mixer has expand=2).
"""
from .base import ArchConfig, SSMSpec, register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMSpec(d_state=128, headdim=64, n_groups=1, expand=2),
    source="arXiv:2405.21060",
))
