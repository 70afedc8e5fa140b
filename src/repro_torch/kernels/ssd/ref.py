"""Plain PyTorch version of the SSD intra-chunk step: re-exports the
model-side reference so the kernel's checks and the model stay in
lockstep (as `repro/kernels/ssd/ref.py` does), and adds the float64
value of the same function with a bound on the float32 rounding of any
implementation that takes the prefix sums of da in float64 and rounds
them once (the kernel and the plain version both do).
"""
from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_chunk_reference

__all__ = ["ssd_chunk_reference", "float64_reference_and_bound"]

U32 = 2.0 ** -24  # unit roundoff of float32


def float64_reference_and_bound(xc, dtc, da, bc, cc):
    """The intra-chunk step in float64 and a bound on each output's error.

    Operands as `ops.ssd_chunk` takes them (bc/cc per group, G dividing
    H, or per head).  Returns (y, states, y_bound, states_bound), all
    float64 on the operands' device.

    The bound, to first order in u = 2^-24 (times 1.01 for the rest):
    with c the exact prefix sums, the float32 cum is within u|c_k| of
    c_k, the difference cum_q - cum_t adds u|c_q - c_t|, so the decay
    exp(cum_q - cum_t) is within d_qt = u (|c_q| + |c_t| + |c_q - c_t|)
    relative, plus 2u for expf and one rounding per product (C.B over N
    terms: gamma_N; scores x decay, dt x: u each; the sum over t:
    gamma_Q), so
      |y - y64|[q,p]  <= sum_t (|C_q|.|B_t|) L_qt |dt_t x_t[p]|
                         (d_qt + (N + Q + 5) u),
      |s - s64|[p,n]  <= sum_q dec_q |dt_q x_q[p]| |B_q[n]|
                         (u (|c_end| + |c_q| + |c_end - c_q|) + (Q + 5) u),
    whatever the order of the float32 sums.  At the model's own decay
    logs (|c| up to ~3e3 in a chunk of 256) d_qt reaches ~6e-4, so the
    element-wise rtol 1e-4 of the synthetic checks does not hold against
    float64 there; this bound does.
    """
    H, G = xc.shape[3], bc.shape[3]
    f64 = torch.float64
    b = bc.repeat_interleave(H // G, dim=3).to(f64)
    c = cc.repeat_interleave(H // G, dim=3).to(f64)
    Q, N = xc.shape[2], b.shape[-1]
    xw = xc.to(f64) * dtc.to(f64)[..., None]             # (B,nc,Q,H,P)
    cum = torch.cumsum(da.to(f64), dim=2)                # (B,nc,Q,H)
    cq = torch.movedim(cum, 2, -1)                       # (B,nc,H,Q)
    diff = cq[..., :, None] - cq[..., None, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    lmat = torch.exp(diff.masked_fill(~causal, -torch.inf))
    scores = torch.einsum("bnqhs,bnths->bnhqt", c, b)
    y = torch.einsum("bnhqt,bnthp->bnqhp", scores * lmat, xw)
    absdot = torch.einsum("bnqhs,bnths->bnhqt", c.abs(), b.abs())
    eta = U32 * (cq.abs()[..., :, None] + cq.abs()[..., None, :]
                 + diff.abs()) + (N + Q + 5) * U32
    y_bound = 1.01 * torch.einsum("bnhqt,bnthp->bnqhp",
                                  absdot * lmat * eta, xw.abs())
    last = cum[:, :, -1:, :]
    dec = torch.exp(last - cum)                          # (B,nc,Q,H)
    states = torch.einsum("bnqhs,bnqhp->bnhps", b, dec[..., None] * xw)
    eta_s = U32 * (last.abs() + cum.abs() + (last - cum).abs()) \
        + (Q + 5) * U32
    s_bound = 1.01 * torch.einsum("bnqhs,bnqhp->bnhps", b.abs(),
                                  (dec * eta_s)[..., None] * xw.abs())
    return y, states, y_bound, s_bound
