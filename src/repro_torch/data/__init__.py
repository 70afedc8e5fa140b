"""Synthetic datasets, the LM token stream with client partitioning for
federated runs, and the CodedFedL random-Fourier-feature map
(counterpart of `repro.data`)."""
from .partition import partition_iid, partition_noniid
from .rff import rff_features, rff_map, rff_map_reference, rff_weights
from .synthetic import (classification_dataset, linreg_dataset,
                        one_vs_rest_targets, teacher_labels, token_batches)

__all__ = ["classification_dataset", "linreg_dataset", "one_vs_rest_targets",
           "partition_iid", "partition_noniid", "rff_features", "rff_map",
           "rff_map_reference", "rff_weights", "teacher_labels",
           "token_batches"]
