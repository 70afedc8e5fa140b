"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]

32L, d_model 4096, 32 heads (GQA kv=32 — i.e. MHA), d_ff 13440,
vocab 92416.  Qwen1.5 flavor: QKV bias enabled.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    rope_theta=1e6,
    attn_bias=True,
    source="hf:Qwen/CodeQwen1.5-7B",
))
