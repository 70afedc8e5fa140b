"""Synthetic datasets (counterpart of `repro.data`)."""
from .synthetic import linreg_dataset

__all__ = ["linreg_dataset"]
