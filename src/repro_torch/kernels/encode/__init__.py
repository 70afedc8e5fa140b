"""The weighted parity-encoding kernels (counterpart of
`repro.kernels.encode`): `encode_parity` (G an input) and
`encode_parity_prng` (G regenerated inside the kernel from a threefry
key, `prng.py`), with the fleet encoders over the latter."""
