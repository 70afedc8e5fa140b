"""Plain PyTorch version of causal softmax attention (counterpart of
`repro/kernels/flash_attn/ref.py`): scores materialised, float32 softmax,
key/value heads repeated per query-head group.  Beside it, the float64
value of the same function with a bound on the float32 rounding of any
implementation of it (the kernel, this version, the model's grouped
expression).
"""
from __future__ import annotations

import torch

__all__ = ["causal_attention", "float64_reference_and_bound"]

U32 = 2.0 ** -24  # unit roundoff of float32


def _repeat_kv(q, k, v):
    """k and v with each key/value head repeated for its query heads."""
    B, Hkv, S, D = k.shape
    rep = q.shape[1] // Hkv
    if rep == 1:
        return k, v
    return tuple(t[:, :, None].expand(B, Hkv, rep, S, D)
                 .reshape(B, Hkv * rep, S, D) for t in (k, v))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D), Hkv dividing Hq ->
    (B, Hq, S, D), causal, float32 softmax; query head h reads key/value
    head h // (Hq / Hkv)."""
    k, v = _repeat_kv(q, k, v)
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
    s = s / float(torch.sqrt(torch.tensor(float(d))))  # float32 sqrt(d)
    S = q.shape[2]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, -torch.inf)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def float64_reference_and_bound(q, k, v):
    """Causal attention in float64 and a bound on each output's float32
    rounding error.  Operands as `causal_attention` takes them.  Returns
    (o, bound), both float64 (B, Hq, S, D) on the operands' device.

    The bound, to first order in u = 2^-24 (times 1.01 for the rest),
    whatever the order of the float32 sums and whether the scale 1/sqrt(D)
    multiplies q or divides the scores:
      * a score s_ij = c q_i.k_j is within e_ij = (D + 4) u c |q_i|.|k_j|
        (the D-term dot product, the scale's rounding and its own);
      * a weight w_ij = softmax_j(s_ij) is within relative
        eta_ij = e_ij + E_i + u (|s_ij - m_i| + M_i) + (T_i + 4 n + 8) u,
        with E_i and M_i the largest e_ik and |s_ik - m_i| over the row's
        keys, m_i its max, T_i its key count (the normaliser's sum) and
        n = ceil(S / 64) online-softmax rescales of 3 u each;
      * the output, a sum of T_i terms, adds T_i u:
          |o - o64|[i, d] <= sum_j w_ij |v_jd| (eta_ij + T_i u).

    The kernel (`csrc/flash_attn.cu`) forms both products on TF32 tensor
    cores in three parts (3xTF32: x = big + small, each rounded to TF32,
    and a.b ~ a_small b_big + a_big b_small + a_big b_big).  The split
    leaves out at most about 12 u |a||b| a product; each tensor-core
    product adds to its float32 accumulator with an error of at most
    about 2 u of the partial sum's magnitude (tensor cores truncate
    inside an MMA: Fasi, Higham, Mikaitis and Pranesh, "Numerical
    behavior of NVIDIA tensor cores", PeerJ CS 2021), three of them per
    8 of the D terms.  A score's first-order worst case on that route is
    (12 + 0.75 D + 2) u c |q_i|.|k_j|, inside the (D + 4) u above for
    D >= 40; for D = 8, 16 and 32 this bound is tighter than the split's
    own worst case, and the kernel stays inside it only because those
    errors do not all align (an emulation of its arithmetic sits at a few
    hundredths of the bound, `tests/test_torch_flash_attn.py`).  The
    bound itself is the same for every route.
    """
    k, v = _repeat_kv(q, k, v)
    f64 = torch.float64
    q64, k64, v64 = q.to(f64), k.to(f64), v.to(f64)
    B, H, S, D = q.shape
    c = 1.0 / D ** 0.5
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.einsum("bhqd,bhkd->bhqk", q64, k64) * c
    s = s.masked_fill(~causal, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", w, v64)
    e = torch.einsum("bhqd,bhkd->bhqk", q64.abs(), k64.abs()) * (c * (D + 4)
                                                                  * U32)
    e = e.masked_fill(~causal, 0.0)
    gap = (s - m).abs().masked_fill(~causal, 0.0) * U32
    n_keys = torch.arange(1, S + 1, dtype=f64, device=q.device)[:, None]
    n_tiles = -(-S // 64)
    eta = (e + e.amax(dim=-1, keepdim=True) + gap
           + gap.amax(dim=-1, keepdim=True) + (2 * n_keys + 4 * n_tiles + 8)
           * U32)
    bound = 1.01 * torch.einsum("bhqk,bhkd->bhqd", w * eta, v64.abs())
    return o, bound
