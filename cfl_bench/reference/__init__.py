"""The plain reference: PyTorch and NumPy only, written from the
published descriptions, importing nothing of the port, `jax` or `repro`.
It takes the inputs the benchmark hands both sides and works out again
whatever the port derived from them."""
