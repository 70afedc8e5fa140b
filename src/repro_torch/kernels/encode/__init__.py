"""The weighted parity-encoding kernel (counterpart of
`repro.kernels.encode`, `encode_parity` only)."""
