"""PyTorch/CUDA port of the Coded Federated Learning system.

A second package beside `repro` (the JAX reference, which it never
imports).  It mirrors `repro`'s layout module for module and runs the
paper's §IV experiment end to end on an NVIDIA H100: plan
(`core.redundancy`, `plan.solver`), encode (`core.encoding`, kernel
`kernels.encode`), train (`api.Session` over `api.UncodedFL` /
`api.CodedFL`, per-epoch kernel `kernels.round_grad`) and report
(`api.report`).  It also serves the LM zoo's `dense` and `ssm` families:
`configs`, `models` (prefill kernels `kernels.flash_attn` and
`kernels.ssd`), `launch.serve` and `serving.ServeEngine`, and trains
them (`optim`, `checkpoint`, `launch.train`, the federated LM trainer
`fed.trainer`) through the plain expressions.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no CUDA device and no device asked for they raise instead of falling
back.  `python -m repro_torch.quickstart` is the counterpart of
`examples/quickstart.py`.
"""
