"""Batched redundancy planning (paper §III-B) on the device.

`solve_redundancy_batched` evaluates the `(t_grid, n, L)` expected-return
tensor in torch and plans a batch of fleets per call; `PlanRequest`
describes one fleet and parity budget, with the stochastic-CFL server
discount `srv_weight` (`effective_srv_weight`, or `srv_weight_for_epsilon`
from an (epsilon, delta)-DP budget) and the low-latency partial-return
objective `edge_chunks`.  Single-fleet callers use the shim
`core.redundancy.solve_redundancy`.
"""
import numpy as np

from repro_torch.privacy import calibrate_noise

from .solver import (GRID_POINTS, MAX_DOUBLINGS, MAX_ROUNDS, PlanRequest,
                     solve_redundancy_batched)

__all__ = ["PlanRequest", "solve_redundancy_batched", "GRID_POINTS",
           "MAX_ROUNDS", "MAX_DOUBLINGS", "effective_srv_weight",
           "srv_weight_for_epsilon"]


def effective_srv_weight(noise_multiplier, sample_frac):
    """The stochastic-CFL server discount rho / (1 + sigma^2), float64 and
    vectorized: a parity row sampled with probability rho whose gradient
    carries noise power sigma^2 relative to signal is worth that many
    clean rows of expected-return value (`PlanRequest.srv_weight`)."""
    nm = np.asarray(noise_multiplier, dtype=np.float64)
    return np.asarray(sample_frac, dtype=np.float64) / (1.0 + nm * nm)


def srv_weight_for_epsilon(epsilon_target, delta=1e-5, rounds=1,
                           sample_frac=1.0, device=None):
    """epsilon-parameterized `PlanRequest.srv_weight`, vectorized: the
    smallest noise multiplier meeting each (epsilon, delta, rounds) budget
    (one batched `privacy.calibrate_noise` solve on `device`, None: the
    card), then its server weight."""
    sigma = calibrate_noise(epsilon_target, delta=delta, rounds=rounds,
                            sample_frac=sample_frac, device=device)
    return effective_srv_weight(sigma, sample_frac)
