"""Two-stage tier aggregation, numerically equal to flat aggregation.

The flat round gradient is one masked contraction g = (contrib * w) @ x
over the client-major row axis.  The hierarchical one computes the same
contraction per tier with one-hot row masks, then combines the tiers:

    g_t = (contrib * w * mask_t) @ x           # tier partial, full width
    g   = sum_t g_t                            # cross-tier combine

Every masked-out row adds an exact 0, so each tier partial is the flat
contraction with the other tiers' terms zeroed, and the only
reassociation is the final T-term sum: a single-tier topology is
bit-equal to the flat path.  The implementations live in
`repro_torch.core.aggregation`; this is the fleet-facing surface.
"""
from repro_torch.core.aggregation import cross_tier_combine, tier_reduce

__all__ = ["tier_reduce", "cross_tier_combine"]
