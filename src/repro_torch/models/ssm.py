"""Mamba2 blocks via the State Space Duality (SSD) algorithm
[arXiv:2405.21060] (counterpart of `repro/models/ssm.py`).

The selective state-space recurrence

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t,      y_t = C_t^T h_t

is evaluated with the chunked SSD decomposition: split the sequence into
chunks of Q tokens; within a chunk the output is a masked (C B^T)-weighted
quadratic form; across chunks a small recurrence carries the (H, P, N)
state.  A per head is a scalar (Mamba2's "scalar-identity" A).

Shapes: x (B, S, H, P) with H heads of headdim P; B/C (B, S, G, N) with G
state groups (G divides H) and state size N; dt (B, S, H).

Differences from the reference:
  * `use_kernel` defaults to True: the intra-chunk step goes to the
    wrapper `kernels.ssd.ops.ssd_chunk`, which launches the CUDA kernel
    for a tensor on the card and computes the plain version for one on
    the CPU; `use_kernel=False` keeps the plain expression on any device.
  * The prefix sums of the decay logs (`cumsum_f64`) are accumulated in
    float64 and rounded once to float32, so their value does not depend
    on the order of the additions: the kernel, the plain version on the
    card and the plain version on the CPU agree to rounding of the
    decays, where a float32 cumsum at the model's own |cum| ~ 3e3 carries
    ~1e-3 relative error that depends on the order.
  * `mamba2_prefill` keeps the last d_conv - 1 conv inputs with zero
    left-padding for prompts shorter than that (the reference keeps
    fewer rows there; ROADMAP.md, R4).
  * `head_shard` is accepted and changes nothing: the reference's
    `_shard_heads` is a `with_sharding_constraint`, a hint to XLA's SPMD
    partitioner that is a no-op off a mesh, and eager PyTorch on one
    card has no partitioner to hint.
  * The inter-chunk recurrence is a Python loop over the chunks in order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import dense_init, normal

DEFAULT_CHUNK = 256


def cumsum_f64(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sums of `a` along `dim`, accumulated in float64
    and rounded once to `a`'s dtype."""
    return torch.cumsum(a, dim=dim, dtype=torch.float64).to(a.dtype)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable "segment sum": out[..., i, j] = sum_{k=j+1..i} a[..., k]
    for j < i, 0 on the diagonal, -inf above it. a: (..., Q)."""
    q = a.shape[-1]
    cs = cumsum_f64(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]           # i, j -> cs_i - cs_j
    causal = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~causal, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int = DEFAULT_CHUNK,
                h0: Optional[torch.Tensor] = None, use_kernel: bool = True,
                head_shard: bool = False):
    """Chunked SSD scan.

    x: (B, S, H, P), dt: (B, S, H), a: (H,) negative decay rates,
    b, c: (B, S, G, N) with H % G == 0.
    Returns (y (B, S, H, P), h_final (B, H, P, N) float32).
    """
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    orig_s = S
    if S % chunk != 0:
        # zero-pad the tail: dt=0 gives decay exp(0)=1 and zero input, so
        # padded steps leave the state untouched
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // chunk
    rep = H // G

    xc = x.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    bg = b.reshape(B, nc, chunk, G, N)
    cg = c.reshape(B, nc, chunk, G, N)

    da = (dtc * a).to(torch.float32)                     # (B, nc, Q, H)

    if use_kernel:
        from repro_torch.kernels.ssd import ops as ssd_ops
        # the wrapper takes B and C per group; the kernel indexes h // rep
        y_diag, states = ssd_ops.ssd_chunk(xc, dtc, da, bg, cg)
    else:
        y_diag, states = ssd_chunk_reference(
            xc, dtc, da, bg.repeat_interleave(rep, dim=3),
            cg.repeat_interleave(rep, dim=3))

    # ---- inter-chunk recurrence over the carried states ------------------
    chunk_decay = torch.exp(torch.sum(da, dim=2))         # (B, nc, H)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prev = []
    for i in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prev = torch.stack(h_prev, dim=1)                  # (B, nc, H, P, N)

    # ---- contribution of the carried-in state to each chunk --------------
    # C per group against the heads of that group: no per-head copy of C
    decay_in = torch.exp(cumsum_f64(da, 2))              # (B, nc, Q, H)
    y_off = torch.einsum("bnqgs,bngrps->bnqgrp", cg.to(torch.float32),
                         h_prev.reshape(B, nc, G, rep, P, N))
    y_off = y_off.reshape(B, nc, chunk, H, P) * decay_in[..., None]

    y = (y_diag + y_off).to(x.dtype).reshape(B, S, H, P)
    return y[:, :orig_s], h


def ssd_chunk_reference(xc, dtc, da, bc, cc):
    """Intra-chunk quadratic part + per-chunk carried state (the plain
    version of kernel 7).

    xc (B,nc,Q,H,P), dtc (B,nc,Q,H), da (B,nc,Q,H) fp32, bc/cc (B,nc,Q,H,N).
    Returns y_diag (B,nc,Q,H,P) fp32, states (B,nc,H,P,N) fp32.
    """
    f32 = torch.float32
    xw = (xc * dtc[..., None]).to(f32)                   # dt-weighted inputs
    # attention-like intra-chunk matrix: L[t, s] = exp(sum_{s<k<=t} da_k)
    lmat = torch.exp(segsum(torch.movedim(da, 2, -1)))   # (B,nc,H,Q,Q)
    scores = torch.einsum("bnqhs,bnths->bnhqt", cc.to(f32), bc.to(f32))
    y_diag = torch.einsum("bnhqt,bnthp->bnqhp", scores * lmat, xw)
    # carried state: decay from each position to the chunk end
    cum = cumsum_f64(da, 2)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,Q,H)
    states = torch.einsum("bnqhs,bnqhp->bnhps", bc.to(f32),
                          decay_out[..., None] * xw)
    return y_diag, states


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Single-token recurrence. h (B,H,P,N), x (B,H,P), dt (B,H),
    b,c (B,G,N). Returns (y (B,H,P), h_new)."""
    H = x.shape[1]
    rep = H // b.shape[1]
    bh = b.repeat_interleave(rep, dim=1).to(torch.float32)   # (B,H,N)
    ch = c.repeat_interleave(rep, dim=1).to(torch.float32)
    da = (dt * a[None, :]).to(torch.float32)
    dec = torch.exp(da)[..., None, None]                     # (B,H,1,1)
    xw = (x * dt[..., None]).to(torch.float32)
    h_new = h * dec + xw[..., :, None] * bh[..., None, :]
    y = torch.einsum("bhps,bhs->bhp", h_new, ch)
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# full Mamba2 block (projections + causal conv + SSD + gate)
# ---------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator | None, d_model: int, d_state: int,
                n_heads: int, headdim: int, n_groups: int, d_conv: int,
                dtype: torch.dtype, device: torch.device,
                stack: tuple[int, ...] = ()) -> dict:
    """One mixer's parameters, or `stack` of them stacked on leading dims;
    the reference's keys and shapes."""
    d_inner = n_heads * headdim
    conv_dim = d_inner + 2 * n_groups * d_state

    def const(values: torch.Tensor) -> torch.Tensor:
        return values.to(dtype).expand(*stack, *values.shape).clone()

    ones = torch.ones((n_heads,), device=device)
    return {
        # order: [z (gate), x, B, C, dt]
        "w_in": dense_init(gen, d_model,
                           2 * d_inner + 2 * n_groups * d_state + n_heads,
                           dtype, device, stack),
        "conv_w": normal(gen, (*stack, d_conv, conv_dim), 0.1, dtype,
                         device),
        "conv_b": torch.zeros((*stack, conv_dim), dtype=dtype,
                              device=device),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, n_heads,
                                                device=device))),
        "dt_bias": const(torch.zeros_like(ones)),
        "d_skip": const(ones),
        "norm_scale": torch.ones((*stack, d_inner), dtype=dtype,
                                 device=device),
        "w_out": dense_init(gen, d_inner, d_model, dtype, device, stack),
    }


def _split_in(proj, d_inner, n_groups, d_state, n_heads):
    gs = n_groups * d_state
    z, xr, b, c, dt = torch.split(proj, [d_inner, d_inner, gs, gs, n_heads],
                                  dim=-1)
    return z, xr, b, c, dt


def causal_conv(w: torch.Tensor, bias: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x (B, S, C), w (K, C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    # windowed sum: sum_j w[j] * x[t - (k-1) + j], j in order
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + pad[:, j:j + x.shape[1], :] * w[j][None, None, :]
    return out + bias[None, None, :]


def conv_history(conv_in: torch.Tensor, d_conv: int) -> torch.Tensor:
    """The decode conv cache of a prompt: its last d_conv - 1 conv inputs,
    zero-padded on the left when the prompt is shorter."""
    keep = d_conv - 1
    S = conv_in.shape[1]
    hist = conv_in[:, max(S - keep, 0):, :]
    if hist.shape[1] < keep:
        hist = F.pad(hist, (0, 0, keep - hist.shape[1], 0))
    return hist


def mamba2_block(p: dict, x: torch.Tensor, *, d_state: int, n_heads: int,
                 headdim: int, n_groups: int, chunk: int = DEFAULT_CHUNK,
                 use_kernel: bool = True,
                 head_shard: bool = False) -> torch.Tensor:
    """Full-sequence Mamba2 mixer. x: (B, S, D) -> (B, S, D)."""
    y, _ = mamba2_prefill(p, x, d_state=d_state, n_heads=n_heads,
                          headdim=headdim, n_groups=n_groups, chunk=chunk,
                          use_kernel=use_kernel, head_shard=head_shard)
    return y


def mamba2_prefill(p: dict, x: torch.Tensor, *, d_state: int, n_heads: int,
                   headdim: int, n_groups: int, chunk: int = DEFAULT_CHUNK,
                   use_kernel: bool = True,
                   head_shard: bool = False) -> tuple[torch.Tensor, dict]:
    """Full-sequence Mamba2 that also returns the decode cache (final SSM
    state + last d_conv-1 conv inputs)."""
    B, S, _ = x.shape
    d_inner = n_heads * headdim
    gs = n_groups * d_state
    proj = x @ p["w_in"].to(x.dtype)
    z, xr, b, c, dt = _split_in(proj, d_inner, n_groups, d_state, n_heads)
    conv_in = torch.cat([xr, b, c], dim=-1)
    conv_hist = conv_history(conv_in, p["conv_w"].shape[0])
    conv_out = F.silu(causal_conv(p["conv_w"].to(x.dtype),
                                  p["conv_b"].to(x.dtype), conv_in))
    xr, b, c = torch.split(conv_out, [d_inner, gs, gs], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))
    xh = xr.reshape(B, S, n_heads, headdim)
    bg = b.reshape(B, S, n_groups, d_state)
    cg = c.reshape(B, S, n_groups, d_state)
    y, h_final = ssd_chunked(xh, dt, a, bg, cg, chunk=chunk,
                             use_kernel=use_kernel, head_shard=head_shard)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_inner)
    y = y * F.silu(z)
    var = torch.mean(torch.square(y), dim=-1, keepdim=True,
                     dtype=torch.float32)
    y = (y * torch.rsqrt(var + 1e-6).to(x.dtype)
         * p["norm_scale"].to(x.dtype))
    out = y @ p["w_out"].to(x.dtype)
    return out, {"conv": conv_hist, "ssm": h_final}


def init_mamba2_cache(batch: int, d_state: int, n_heads: int, headdim: int,
                      n_groups: int, d_conv: int, dtype: torch.dtype,
                      device: torch.device) -> dict:
    conv_dim = n_heads * headdim + 2 * n_groups * d_state
    return {
        "conv": torch.zeros((batch, d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, n_heads, headdim, d_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(p: dict, x: torch.Tensor, cache: dict, *, d_state: int,
                  n_heads: int, headdim: int,
                  n_groups: int) -> tuple[torch.Tensor, dict]:
    """Single-token Mamba2 step. x: (B, 1, D)."""
    B = x.shape[0]
    d_inner = n_heads * headdim
    gs = n_groups * d_state
    proj = x[:, 0] @ p["w_in"].to(x.dtype)                 # (B, ...)
    z, xr, b, c, dt = _split_in(proj, d_inner, n_groups, d_state, n_heads)
    conv_in = torch.cat([xr, b, c], dim=-1)                # (B, C)
    hist = torch.cat([cache["conv"].to(x.dtype), conv_in[:, None, :]],
                     dim=1)
    w = p["conv_w"].to(x.dtype)                            # (K, C)
    # the taps in the order of `causal_conv`
    conv_out = torch.zeros_like(conv_in)
    for j in range(w.shape[0]):
        conv_out = conv_out + hist[:, j, :] * w[j][None, :]
    conv_out = F.silu(conv_out + p["conv_b"].to(x.dtype))
    xr, b, c = torch.split(conv_out, [d_inner, gs, gs], dim=-1)
    dt = F.softplus(dt.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))      # (B, H)
    a = -torch.exp(p["a_log"].to(torch.float32))
    xh = xr.reshape(B, n_heads, headdim)
    bg = b.reshape(B, n_groups, d_state)
    cg = c.reshape(B, n_groups, d_state)
    y, h_new = ssd_decode_step(cache["ssm"], xh, dt, a, bg, cg)
    y = y + xh * p["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(B, d_inner)
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.to(torch.float32)), dim=-1,
                     keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6).to(x.dtype)
         * p["norm_scale"].to(x.dtype))
    out = (y @ p["w_out"].to(x.dtype))[:, None, :]
    return out, {"conv": hist[:, 1:, :], "ssm": h_new}
