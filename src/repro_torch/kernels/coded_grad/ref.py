"""Plain PyTorch version of the least-squares gradient
(`kernels.round_grad.ref.lsq_gradient`)."""
from repro_torch.kernels.round_grad.ref import lsq_gradient

__all__ = ["lsq_gradient"]
