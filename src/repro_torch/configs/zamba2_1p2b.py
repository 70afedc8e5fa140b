"""zamba2-1.2b [arXiv:2411.15242]

38 Mamba2 layers, d_model 2048, ssm_state 64, plus ONE weight-shared
attention+MLP block (32 heads, MHA kv=32, d_ff 8192) applied every 6 layers,
vocab 32000.
"""
from .base import ArchConfig, HybridSpec, SSMSpec, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    rope_theta=1e4,
    ssm=SSMSpec(d_state=64, headdim=64, n_groups=1, expand=2),
    hybrid=HybridSpec(attn_every=6),
    source="arXiv:2411.15242",
))
