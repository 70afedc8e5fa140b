"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision]

40 decoder layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 128256, with gated cross-attention blocks over vision patch
embeddings every 5th layer.  The ViT tower is a stub: the caller passes
precomputed (n_patches, d_vision) embeddings.
"""
from .base import ArchConfig, VLMSpec, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=5e5,
    vlm=VLMSpec(cross_every=5, n_patches=1601, d_vision=4096),
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
