"""lm-100m: the ~100M-param end-to-end training example config (not part of
the assigned pool; the default `--arch` of `launch.train`).
12L, d_model 768, 12 heads (GQA kv=4), d_ff 3072, vocab 32768 => ~135M total
(~85M non-embedding)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="lm-100m",
    arch_type="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=3072,
    vocab=32768,
    head_dim=64,
    rope_theta=1e4,
    source="examples",
))
