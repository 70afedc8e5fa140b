"""The Mamba2 SSD intra-chunk kernel (counterpart of `repro.kernels.ssd`):
`ops.ssd_chunk` (the wrapper of `csrc/ssd.cu`) and `ref` (its plain
version, the model's own `ssd_chunk_reference`)."""
