"""Federated training (counterpart of `repro.fed`): the straggler-aware
trainer for arbitrary models (`trainer`: the Eq. 14-16 load allocation
over sequences and deadline-masked, 1/p-weighted aggregation) and the
coded head (`coded_head`: a model's linear readout trained with CFL, or
with CodedFedL over a random-Fourier-feature map)."""
from .coded_head import (extract_features, head_accuracy, reference_head,
                         train_coded_head)
from .trainer import (FedConfig, FedState, fed_round, fed_setup, fed_train,
                      presample_round_weights, round_weights)

__all__ = ["FedConfig", "FedState", "fed_setup", "fed_round", "fed_train",
           "round_weights", "presample_round_weights", "extract_features",
           "head_accuracy", "reference_head", "train_coded_head"]
