"""The LM zoo's models (counterpart of `repro.models`), the `dense` and
`ssm` families so far: `layers` (init, norms, MLPs, rope, grouped-query
attention with kernel 8 on the prefill's causal core, the KV-cache
decode), `ssm` (Mamba2 via SSD, with kernel 7 on the intra-chunk step)
and `transformer` (parameter tree, prefill and decode for `arch_type`
"dense" and "ssm")."""
