"""Optimizers and schedules (counterpart of `repro.optim`): SGD
(+momentum), AdamW with float32 or bf16 moment states, learning-rate
schedules and global-norm clipping, in the reference's own formulas."""
from .optimizers import (OptState, Optimizer, adamw, apply_updates,
                         init_opt_state, make_optimizer, sgd)

__all__ = ["OptState", "Optimizer", "adamw", "sgd", "init_opt_state",
           "apply_updates", "make_optimizer"]
