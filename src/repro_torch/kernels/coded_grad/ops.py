"""The least-squares gradient kernel under the reference's family name.

The TPU kernel's function, A^T (A beta - y) in one pass over A, is the
flat masked round gradient at w = 1, so it has no source of its own: its
wrapper lives in `kernels.round_grad.ops` beside the flat one and
launches `csrc/round_grad.cu`'s one-tier instance with no weights
through the C entry point `rg_lsq_gradient`.  `COUNTER` is that
wrapper's own launch counter (`round_grad.ops.LSQ_COUNTER`).
"""
from repro_torch.kernels.round_grad.ops import LSQ_COUNTER as COUNTER
from repro_torch.kernels.round_grad.ops import lsq_gradient

from . import ref

__all__ = ["COUNTER", "lsq_gradient", "reference"]

reference = ref.lsq_gradient  # the plain oracle, the reference's name
