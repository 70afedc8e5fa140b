"""Random Fourier features (Rahimi & Recht), the CodedFedL transform
(counterpart of `repro/data/rff.py`).

CodedFedL (arXiv:2007.03273) maps raw inputs through a random Fourier
feature map and runs least-squares regression in the feature space: the
model stays linear in its parameters, so the parity-gradient identity and
the coded linear machinery apply unchanged.  For the Gaussian kernel
`k(u, v) = exp(-gamma * ||u - v||^2)`:

    W      ~ sqrt(2 * gamma) * N(0, I)      of shape (d, d_feat // 2)
    z(x)   = sqrt(2 / d_feat) * [cos(x W), sin(x W)]

so that `E[z(u) . z(v)] = k(u, v)`, with an error decaying as
`1/sqrt(d_feat)`.  The map is deterministic in its generator: clients and
server draw the same W from the shared seed.

The weights come from an explicit `torch.Generator` (`rff_weights`) and
the map itself is `rff_features`, so a caller may hand in weights drawn
elsewhere (the parity tests hand over the reference's `jax.random`
draw).  A generator on the card gives another stream than one on the CPU
for the same seed.  `x @ W` is a plain `torch.matmul` (the reference has
no kernel there); it runs in full float32 (`device.full_fp32`), since
TF32 would move every feature.  `rff_map_reference` is the float64 oracle.
"""
from __future__ import annotations

import numpy as np
import torch


def rff_weights(generator: torch.Generator, d: int, d_feat: int,
                gamma: float = 1.0) -> torch.Tensor:
    """`sqrt(2 gamma) * N(0, 1)` of shape (d, d_feat // 2), float32, on the
    generator's device.  Raises ValueError unless d_feat is even and
    >= 2."""
    if d_feat < 2 or d_feat % 2:
        raise ValueError(
            f"d_feat must be a positive even number (cos/sin pairs), "
            f"got {d_feat}")
    dev = generator.device
    scale = torch.sqrt(torch.tensor(2.0 * gamma, dtype=torch.float32,
                                    device=dev))
    return scale * torch.randn((d, d_feat // 2), generator=generator,
                               device=dev, dtype=torch.float32)


def rff_features(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`sqrt(2/d_feat) * [cos(x W), sin(x W)]`: x (..., d), w (d, d_feat/2)
    on one device -> (..., d_feat) in x's dtype."""
    proj = torch.matmul(x, w.to(x.dtype))
    d_feat = 2 * int(w.shape[-1])
    scale = torch.sqrt(torch.tensor(2.0 / d_feat, dtype=proj.dtype,
                                    device=proj.device))
    return scale * torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)


def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def rff_map(x: torch.Tensor, d_feat: int, key, gamma: float = 1.0
            ) -> torch.Tensor:
    """Map `x (..., d)` to `(..., d_feat)` random Fourier features.

    key: an int seed of a `torch.Generator` on x's device, or a generator.
    Approximates the Gaussian kernel `exp(-gamma * ||u - v||^2)`;
    deterministic in (key, device, d_feat, gamma) and the input width."""
    w = rff_weights(_generator(key, x.device), int(x.shape[-1]), d_feat,
                    gamma)
    return rff_features(x, w)


def rff_map_reference(x, d_feat: int, key, gamma: float = 1.0,
                      device="cpu") -> np.ndarray:
    """Float64 NumPy oracle for `rff_map`: the same weight draw (a
    generator of seed `key` on `device`, the device the map ran on),
    float64 product and trig."""
    x = np.asarray(x, dtype=np.float64)
    w = rff_weights(_generator(key, torch.device(device)), int(x.shape[-1]),
                    d_feat, gamma).cpu().numpy().astype(np.float64)
    proj = x @ w
    return np.sqrt(2.0 / d_feat) * np.concatenate(
        [np.cos(proj), np.sin(proj)], axis=-1)
