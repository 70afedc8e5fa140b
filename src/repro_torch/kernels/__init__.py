"""Hand-written Hopper kernels and their plain PyTorch versions.

Each family (`round_grad`, `encode`, `coded_grad`, `ssd`) holds `ref.py`
(the plain version) and `ops.py` (the wrapper: checks, launch on the
current stream, launch counter); `encode/prng.py` is the threefry
generator of the in-kernel-generator encode.  The CUDA sources live in
`csrc/` and are built at first use by `build.py`; nothing is compiled or
loaded when a module is imported.
"""
