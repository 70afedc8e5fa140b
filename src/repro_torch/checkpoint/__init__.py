"""Checkpoints of trees of tensors (counterpart of `repro.checkpoint`), in
the reference's file layout, so either package restores the other's."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
