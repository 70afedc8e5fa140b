"""Causal flash attention (counterpart of `repro.kernels.flash_attn`):
`ops.causal_attention` (the wrapper of `csrc/flash_attn.cu`) and `ref`
(its plain version, the reference's `ref.py` expression)."""
