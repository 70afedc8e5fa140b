"""The LM zoo's models (counterpart of `repro.models`), the `ssm` family
so far: `layers` (init, RMSNorm), `ssm` (Mamba2 via SSD, with kernel 7 on
the intra-chunk step) and `transformer` (parameter tree, prefill and
decode for `arch_type == "ssm"`)."""
