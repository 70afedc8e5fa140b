"""Plain Mamba2 (arXiv:2405.21060): the block of the paper's Figure 6
with the chunked SSD of its Listing 1, in float32.

Departures from the listing: the decay exponents (the segment sums of
dt A) are summed in float64 and rounded once, since a float32 cumulative
sum over a 256-token chunk carries an error that depends on the order of
its additions; B and C are shared by the heads of a group by index
rather than repeated.  The block keeps the last d_conv - 1 conv inputs
(zero on the left of a short prompt) and the final SSM state, the state
a decode would continue from.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F64 = torch.float64


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = a[..., j+1] + ... + a[..., i] for j <= i, -inf
    above the diagonal (the listing's stable segment sum)."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device),
                       -1)
    x = x.masked_fill(~below, 0).cumsum(-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, -torch.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, chunk: int):
    """y_t = C_t^T h_t, h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T.

    x (B, L, H, P), dt (B, L, H), a (H,), b and c (B, L, G, N).
    Returns y (B, L, H, P) and the final state (B, H, P, N)."""
    bsz, length, heads, p = x.shape
    groups, n = b.shape[2], b.shape[3]
    rep = heads // groups
    pad = -length % chunk
    if pad:  # dt = 0: decay 1 and no input, the state passes unchanged
        x, dt, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, b, c))
    nc = (length + pad) // chunk
    xd = (x * dt[..., None]).reshape(bsz, nc, chunk, groups, rep, p)
    b = b.reshape(bsz, nc, chunk, groups, n)
    c = c.reshape(bsz, nc, chunk, groups, n)
    da = (dt.to(F64) * a.to(F64)).reshape(bsz, nc, chunk, heads)
    da = da.permute(0, 3, 1, 2)                          # (B, H, nc, Q)
    cum = da.cumsum(-1)
    # 1. within each chunk
    decay = torch.exp(segsum(da).to(x.dtype))            # (B, H, nc, Q, Q)
    decay = decay.reshape(bsz, groups, rep, nc, chunk, chunk)
    scores = torch.einsum("bcqgn,bcsgn->bcgqs", c, b)
    w = scores[:, :, :, None] * decay.permute(0, 3, 1, 2, 4, 5)
    y = torch.einsum("bcgrqs,bcsgrp->bcqgrp", w, xd)
    # 2. each chunk's own state
    out_decay = torch.exp((cum[..., -1:] - cum).to(x.dtype))  # (B, H, nc, Q)
    out_decay = out_decay.reshape(bsz, groups, rep, nc, chunk)
    states = torch.einsum("bcqgn,bcqgrp->bcgrpn", b,
                          xd * out_decay.permute(0, 3, 4, 1, 2)[..., None])
    # 3. across chunks
    states = states.reshape(bsz, nc, heads, p, n)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    last = F.pad(cum[..., -1], (1, 0))                   # (B, H, nc + 1)
    carry = torch.exp(segsum(last).to(x.dtype))          # (B, H, nc+1, nc+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)
    prev, final = states[:, :-1], states[:, -1]
    # 4. the carried-in state's part of each output
    in_decay = torch.exp(cum.to(x.dtype)).reshape(bsz, groups, rep, nc,
                                                  chunk)
    prev = prev.reshape(bsz, nc, groups, rep, p, n)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", c, prev)
    y = y + y_off * in_decay.permute(0, 3, 4, 1, 2)[..., None]
    y = y.reshape(bsz, nc * chunk, heads, p)[:, :length]
    return y, final


def mixer(p: dict, h: torch.Tensor, model: dict):
    """One Mamba2 mixer over h (B, L, D); returns (out, conv state
    (B, d_conv - 1, conv_dim), SSM state (B, H, P, N))."""
    s, d = model["ssm"], model["d_model"]
    heads = s["expand"] * d // s["headdim"]
    inner = heads * s["headdim"]
    gn = s["n_groups"] * s["d_state"]
    bsz, length, _ = h.shape
    z, xbc, dt = torch.split(h @ p["w_in"], [inner, inner + 2 * gn, heads],
                             dim=-1)
    k = p["conv_w"].shape[0]
    hist = F.pad(xbc, (0, 0, max(k - 1 - length, 0), 0))[:, -(k - 1):]
    conv = F.conv1d(xbc.transpose(1, 2), p["conv_w"].T[:, None, :],
                    p["conv_b"], padding=k - 1, groups=xbc.shape[-1])
    xbc = F.silu(conv[..., :length].transpose(1, 2))
    xs, b, c = torch.split(xbc, [inner, gn, gn], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xs = xs.reshape(bsz, length, heads, s["headdim"])
    y, state = ssd(xs, dt, a,
                   b.reshape(bsz, length, s["n_groups"], s["d_state"]),
                   c.reshape(bsz, length, s["n_groups"], s["d_state"]),
                   s["chunk"])
    y = y + xs * p["d_skip"][:, None]
    y = y.reshape(bsz, length, inner) * F.silu(z)
    y = rmsnorm(y, p["norm_scale"])
    return y @ p["w_out"], hist, state


def layers(params: dict) -> list[dict]:
    """Each layer's leaves, every stacked leaf split once (so a backward
    assembles each leaf's gradient once)."""
    blocks = params["blocks"]
    parts = {k: v.unbind(0) for k, v in blocks["mixer"].items()}
    norms = blocks["norm"]["scale"].unbind(0)
    return [({k: v[i] for k, v in parts.items()}, norms[i])
            for i in range(len(norms))]


def forward(model: dict, params: dict, tokens: torch.Tensor, *,
            last_only: bool = False, keep_states: bool = False):
    """Logits (float32) of every position, or of the last with
    `last_only`; with `keep_states` also the per-layer conv and SSM
    states, stacked (layers, B, ...)."""
    x = params["embed"][tokens]
    convs, ssms = [], []
    for p, norm in layers(params):
        y, hist, state = mixer(p, rmsnorm(x, norm), model)
        x = x + y
        if keep_states:
            convs.append(hist)
            ssms.append(state)
    if last_only:
        x = x[:, -1:]
    head = params.get("lm_head")
    logits = rmsnorm(x, params["final_norm"]["scale"]) @ (
        head if head is not None else params["embed"].T)
    if keep_states:
        return logits, torch.stack(convs), torch.stack(ssms)
    return logits


def prefill(model: dict, params: dict, tokens: torch.Tensor):
    """A one-sequence prompt (1, L): the last position's logits (V,) and
    the state a decode continues from, by the paths of the port's
    one-slot cache: {"mamba/conv": (layers, d_conv - 1, conv_dim),
    "mamba/ssm": (layers, H, P, N)}."""
    logits, conv, ssm = forward(model, params, tokens, last_only=True,
                                keep_states=True)
    return logits[0, -1], {"mamba/conv": conv[:, 0], "mamba/ssm": ssm[:, 0]}
