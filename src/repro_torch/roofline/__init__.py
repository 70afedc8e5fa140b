"""Roofline terms of the port's kernels (`kernel_terms`) and the LM zoo's
model FLOPs, with the H100's peak rates (counterpart of `repro.roofline`;
`roofline.hlo_graph` and `roofline_terms(hlo_text)` have no counterpart:
the port compiles no XLA module)."""
from .analysis import (FP32_FLOPS_PER_S, HASH_INT_OPS, HBM_BYTES_PER_S,
                       INT32_OPS_PER_S, TF32_FLOPS_PER_S, active_params,
                       dominant_term, kernel_terms, model_flops)

__all__ = ["FP32_FLOPS_PER_S", "HASH_INT_OPS", "HBM_BYTES_PER_S",
           "INT32_OPS_PER_S", "TF32_FLOPS_PER_S", "active_params",
           "dominant_term", "kernel_terms", "model_flops"]
