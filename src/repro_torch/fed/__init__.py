"""Federated training of a model's linear readout head (counterpart of
`repro.fed`): `coded_head` trains it with CFL, or with CodedFedL over a
random-Fourier-feature map."""
from .coded_head import (extract_features, head_accuracy, reference_head,
                         train_coded_head)

__all__ = ["extract_features", "head_accuracy", "reference_head",
           "train_coded_head"]
