"""The masked round-gradient kernel (counterpart of
`repro.kernels.round_grad`, masked variant only)."""
