"""whisper-tiny [arXiv:2212.04356]

Encoder-decoder, 4 layers each, d_model 384, 6 heads (MHA kv=6),
d_ff 1536, vocab 51865.  LayerNorm + GELU (Whisper flavor).  The
mel-spectrogram + conv frontend is a stub: the caller passes
precomputed (n_frames=1500, d_model) frame embeddings.  The real decoder
caps at 448 positions.
"""
from .base import ArchConfig, EncDecSpec, register

CONFIG = register(ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="ln",
    act="gelu",
    rope_theta=1e4,
    encdec=EncDecSpec(n_enc_layers=4, n_frames=1500, max_decode_len=448),
    source="arXiv:2212.04356",
))
