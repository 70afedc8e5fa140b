"""(epsilon, delta)-DP accounting for the stochastic coded-FL noise knob
(counterpart of `repro.privacy`), in float64 torch.

`accountant.epsilon_spent` / `epsilon_schedule` price `rounds` releases
of the subsampled Gaussian mechanism at `(noise_multiplier,
sample_frac)`; `calibrate.calibrate_noise` inverts that map for a batch
of epsilon targets.  The reference's float64 NumPy oracle
(`repro.privacy.reference`) is what the tests hold both to.
"""
from .accountant import DEFAULT_ORDERS, epsilon_schedule, epsilon_spent
from .calibrate import calibrate_noise

__all__ = ["DEFAULT_ORDERS", "calibrate_noise", "epsilon_schedule",
           "epsilon_spent"]
