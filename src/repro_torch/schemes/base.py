"""Shared machinery for the coded follow-up schemes (counterpart of
`repro/schemes/base.py`).

The accounting the schemes share with `CodedFL` — parity-upload bits,
upload-time sampling, uplink totals, the device layouts — lives in one
place, `repro_torch.core.cfl` (re-exported here); this module adds only
the shared state dataclass.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cfl import (coded_device_state, coded_uplink_bits,
                                  fused_coded_device_state,
                                  parity_upload_bits,
                                  sample_parity_upload_time)
from repro_torch.core.delay_model import DeviceDelayParams
from repro_torch.core.redundancy import RedundancyPlan

__all__ = ["CodedSchemeState", "coded_device_state", "coded_uplink_bits",
           "fused_coded_device_state", "sample_parity_upload_time"]


@dataclasses.dataclass
class CodedSchemeState:
    """Protocol state shared by the coded follow-up schemes after `plan`.

    plan:      the redundancy solve's output (loads, c, t*, return probs)
    load_mask: (n, ell) 1.0 on each client's systematic points
    x_parity:  (c, d) composite parity features resident at the server
    y_parity:  (c,)   composite parity labels
    """

    plan: RedundancyPlan
    load_mask: torch.Tensor
    x_parity: torch.Tensor
    y_parity: torch.Tensor
    edge: DeviceDelayParams
    server: DeviceDelayParams

    @property
    def c(self) -> int:
        return int(self.x_parity.shape[0])

    def parity_upload_bits(self, bits_per_value: int = 32,
                           header_overhead: float = 0.10) -> np.ndarray:
        """Bits each client uploads for its parity shard (one-time cost)."""
        return parity_upload_bits(self.edge.n, self.c,
                                  int(self.x_parity.shape[1]),
                                  bits_per_value, header_overhead)
