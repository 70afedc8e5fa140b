"""Mixture-of-Experts FFN with top-k routing and capacity-bounded grouped
dispatch, GShard/Mesh-TF style (counterpart of `repro/models/moe.py`).

Tokens are processed in groups of `group_size`; within each group, each
expert accepts at most `capacity` tokens (overflow is dropped — its residual
passes through).  Dispatch and combine are one-hot products
(`torch.einsum`), plain expressions as in the reference, which has no
kernel for them.

Shapes: x (B, S, D) -> flattened (n_groups, group, D);
dispatch/combine (n_groups, group, E, C); expert buffers (n_groups, E, C, D).

As the reference, where it is easy to get wrong:
  * a token whose queue position is past the capacity has an all-zero
    slot row (`jax.nn.one_hot` of an index >= C), so it is dropped;
  * `_top_k_mask` selects every expert whose probability reaches the
    k-th largest, so ties select more than k experts;
  * the group halves until it divides B * S (1537 tokens: one group of
    1537; 3000: groups of 8).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .layers import dense_init, normal


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    group_size: int = 2048
    capacity_factor: float = 2.0

    def capacity(self, group: int) -> int:
        cap = int(self.capacity_factor * self.top_k * group / self.n_experts)
        return max(cap, self.top_k)


def init_moe(gen: torch.Generator | None, dims: MoEDims, dtype: torch.dtype,
             device: torch.device, stack: tuple[int, ...] = ()) -> dict:
    """One layer's router and experts, or `stack` of them stacked on
    leading dims; the router is float32 whatever `dtype` (its math stays
    float32)."""
    e, d, f = dims.n_experts, dims.d_model, dims.d_ff
    return {
        "router": dense_init(gen, d, e, torch.float32, device, stack),
        "w_gate": normal(gen, (*stack, e, d, f), 1.0 / math.sqrt(d), dtype,
                         device),
        "w_up": normal(gen, (*stack, e, d, f), 1.0 / math.sqrt(d), dtype,
                       device),
        "w_down": normal(gen, (*stack, e, f, d), 1.0 / math.sqrt(f), dtype,
                         device),
    }


def _top_k_mask(router_probs: torch.Tensor, k: int):
    """Per-token top-k expert selection.

    router_probs: (..., E).  Returns (mask (..., E) in {0,1},
    gates (..., E) with renormalized probs on the selected experts); every
    expert at or above the k-th largest probability is selected."""
    thresh = torch.topk(router_probs, k, dim=-1).values[..., -1:]
    mask = (router_probs >= thresh).to(router_probs.dtype)
    gates = router_probs * mask
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True),
                                min=1e-9)
    return mask, gates


def group_size(dims: MoEDims, n_tokens: int) -> int:
    """The dispatch group: group_size, or the token count if smaller,
    halved until it divides the token count."""
    group = min(dims.group_size, n_tokens)
    while n_tokens % group != 0:
        group //= 2
    return group


def moe_ffn(p: dict, x: torch.Tensor, dims: MoEDims):
    """Apply the MoE FFN. x: (B, S, D). Returns (y, aux) where aux carries
    the load-balancing loss (Switch/GShard auxiliary loss), the router
    z-loss and the share of (token, choice) pairs dropped."""
    B, S, D = x.shape
    T = B * S
    group = group_size(dims, T)
    n_groups = T // group
    e = dims.n_experts
    cap = dims.capacity(group)

    xg = x.reshape(n_groups, group, D)
    logits = xg.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                # (n, g, E)
    mask, gates = _top_k_mask(probs, dims.top_k)

    # position of each token within its expert's queue: the count of
    # earlier tokens of the group routed to that expert
    pos_in_expert = torch.cumsum(mask, dim=1) - mask
    keep = mask * (pos_in_expert < cap)                  # drop overflow
    slots = torch.arange(cap, device=x.device)
    slot_onehot = (pos_in_expert.to(torch.int64)[..., None]
                   == slots).to(torch.float32)           # (n, g, E, C)
    dispatch = keep[..., None] * slot_onehot
    combine = (gates * keep)[..., None] * slot_onehot

    xd = x.dtype
    expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(xd), xg)
    h = F.silu(torch.einsum("necd,edf->necf", expert_in,
                            p["w_gate"].to(xd)))
    h = h * torch.einsum("necd,edf->necf", expert_in, p["w_up"].to(xd))
    expert_out = torch.einsum("necf,efd->necd", h, p["w_down"].to(xd))

    y = torch.einsum("ngec,necd->ngd", combine.to(xd), expert_out)
    y = y.reshape(B, S, D)

    # auxiliary load-balance loss (Switch): E * sum_e f_e * P_e
    frac_tokens = torch.mean(mask, dim=1)                # (n, E)
    frac_probs = torch.mean(probs, dim=1)
    aux_loss = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    # router z-loss (stabilizes logits)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - torch.mean(torch.sum(keep, dim=-1) / dims.top_k)
    return y, {"aux_loss": aux_loss, "z_loss": z_loss,
               "dropped_frac": dropped}
