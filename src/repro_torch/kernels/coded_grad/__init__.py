"""The least-squares gradient kernel (counterpart of
`repro.kernels.coded_grad`): A^T (A beta - y), the server's parity
gradient on the legacy per-epoch path."""
