"""The LM zoo's models and the paper's linear model (counterpart of
`repro.models`): `layers` (init, norms, MLPs, rope, grouped-query
attention with kernel 8 on the prefill's causal core, cross-attention,
the KV-cache decode), `ssm` (Mamba2 via SSD, with kernel 7 on the
intra-chunk step), `moe` (the top-k MoE FFN), `transformer` (parameter
tree, training forward, prefill and decode for all six families) and
`linear` (`linreg_predict`, `linreg_loss`)."""
from . import layers, moe, ssm, transformer
from .linear import linreg_loss, linreg_predict

__all__ = ["layers", "moe", "ssm", "transformer", "linreg_predict",
           "linreg_loss"]
