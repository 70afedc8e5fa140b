"""Kernel 7's 3xTF32 arithmetic, emulated on the CPU and held to its
float64 bound.

`csrc/ssd.cu` forms the SSD intra-chunk step on the tensor cores in this
order of work, which `_emulate_kernel` repeats with the TF32 helpers of
`tests/test_torch_tf32.py` (each operand element split once into (big,
small) TF32 words, the three products small.big, big.small, big.big of
each k-step of 8 added to one float32 accumulator, each tensor-core sum
truncated):

  * the scores C B^T once per group, 3xTF32 over N;
  * the decay exp(cum_q - cum_t) in float32 from the prefix sums of da
    taken in float64 and rounded once, times the score (rounded once),
    the causal mask;
  * y: the decayed scores split in registers, 3xTF32 with dt x (rounded
    once), the k-steps of 8 keys of even and of odd parity summed apart
    (two warps) and then added, even plus odd;
  * the state: (dt x) times the decay to the chunk end (each rounded
    once), 3xTF32 with B over Q.

The emulation is held to the unchanged float64 bound of
`kernels.ssd.ref.float64_reference_and_bound` at the model's own decays
(dt = softplus(N(0, 1)), a = -linspace(1, 16, H)) at mamba2-1.3b's
chunk (Q, P, N) = (256, 64, 128) with a few heads and one group, at the
reduced mamba2's shape and at the small and ragged shapes the card tests
check; `-s` prints its share beside the plain float32 version's.  Plain
TF32 (big.big alone) is shown to fall outside the bound, and the
emulation stays within the reference's rtol 1e-4 / atol 1e-4 *
max(1, max|ref|) of the plain version (`tests/test_kernels.py`).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import ref as ssd_ref
from test_torch_tf32 import product3


def _operands(seed, B, nc, Q, H, P, N, G):
    """x ~ N(0, 1), dt = softplus(N(0, 1)), the model's da = dt * a with
    a = -linspace(1, 16, H), and B, C ~ N(0, 1) per group, made with
    numpy."""
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((B, nc, Q, H, P))
    v = rng.standard_normal((B, nc, Q, H))
    dtc = np.log1p(np.exp(-np.abs(v))) + np.maximum(v, 0.0)
    da = dtc * -np.linspace(1.0, 16.0, H)
    bc = rng.standard_normal((B, nc, Q, G, N))
    cc = rng.standard_normal((B, nc, Q, G, N))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (xc, dtc, da, bc, cc)]


def _emulate_kernel(xc, dtc, da, bc, cc, split=True):
    """`ssd_chunk_kernel`'s arithmetic (split=False: plain TF32, big.big
    alone, in every product).  Returns (y, states) as the kernel lays
    them out."""
    B, nc, Q, H, P = xc.shape
    G = bc.shape[3]
    rep = H // G
    cum = torch.cumsum(da.double(), dim=2).float()       # rounded once
    # the scores once per (chunk, group), 3xTF32 over N
    c_g = cc.movedim(3, 2)                               # (B,nc,G,Q,N)
    bt_g = bc.movedim(3, 2).transpose(-1, -2)            # (B,nc,G,N,Q)
    scores = product3(c_g, bt_g, torch.zeros((B, nc, G, Q, Q)), split)
    # each head's decay and the causal mask, one rounding each
    ch = cum.movedim(2, -1)                              # (B,nc,H,Q)
    lmat = torch.exp(ch[..., :, None] - ch[..., None, :])
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    decayed = torch.where(causal, scores.repeat_interleave(rep, 2) * lmat,
                          torch.zeros(()))               # (B,nc,H,Q,Q)
    xw = (xc * dtc[..., None]).movedim(3, 2)             # (B,nc,H,Q,P)
    # y: the k-steps of 8 keys of even and of odd parity apart, then added
    even = (torch.arange(Q) // 8) % 2 == 0
    zero_y = torch.zeros((B, nc, H, Q, P))
    acc = [product3(decayed[..., keys], xw[..., keys, :], zero_y, split)
           for keys in (even, ~even)]
    y = (acc[0] + acc[1]).movedim(2, 3)                  # (B,nc,Q,H,P)
    # the state: (dt x) dec, 3xTF32 with B over Q
    dec = torch.exp(cum[:, :, -1:, :] - cum).movedim(2, -1)  # (B,nc,H,Q)
    w = xw * dec[..., None]
    b_h = bc.repeat_interleave(rep, 3).movedim(3, 2)     # (B,nc,H,Q,N)
    states = product3(w.transpose(-1, -2), b_h,
                      torch.zeros((B, nc, H, P, bc.shape[4])), split)
    return y, states


def _share(got, exact, bound):
    return max(float(((g.double() - e).abs() / b).max())
               for g, e, b in zip(got, exact, bound))


# (B, nc, Q, H, P, N, G): mamba2-1.3b's chunk with four of its heads, the
# reduced mamba2's shape, and the card tests' small and ragged shapes
SHAPES = [(1, 2, 256, 4, 64, 128, 1), (1, 3, 16, 16, 32, 16, 1),
          (1, 1, 8, 1, 4, 4, 1), (2, 3, 32, 4, 16, 8, 4),
          (1, 2, 97, 4, 64, 128, 2), (1, 1, 200, 2, 64, 128, 1),
          (1, 1, 72, 2, 80, 96, 1), (1, 2, 64, 6, 16, 32, 2),
          (1, 1, 45, 3, 7, 9, 1)]


@pytest.mark.parametrize("B,nc,Q,H,P,N,G", SHAPES)
def test_kernel_arithmetic_within_the_float64_bound(B, nc, Q, H, P, N, G):
    ops = _operands(B + Q + H + N, B, nc, Q, H, P, N, G)
    y64, s64, yb, sb = ssd_ref.float64_reference_and_bound(*ops)
    got = _emulate_kernel(*ops)
    rep = H // G
    plain = ssd_ref.ssd_chunk_reference(
        *ops[:3], ops[3].repeat_interleave(rep, 3),
        ops[4].repeat_interleave(rep, 3))
    shares = {name: _share(out, (y64, s64), (yb, sb))
              for name, out in (("kernel", got), ("plain", plain))}
    print(f"emulated 3xTF32 kernel 7 at (B, nc, Q, H, P, N, G) = "
          f"{(B, nc, Q, H, P, N, G)}: worst element at "
          f"{shares['kernel']:.4f} (kernel) and {shares['plain']:.4f} "
          f"(plain float32) of the float64 bound")
    assert shares["kernel"] <= 1.0 and shares["plain"] <= 1.0
    for g, p in zip(got, plain):
        atol = 1e-4 * max(1.0, float(p.abs().max()))
        torch.testing.assert_close(g, p, rtol=1e-4, atol=atol)


def test_plain_tf32_is_outside_the_float64_bound():
    """The bound tells the split from plain TF32 at mamba2-1.3b's chunk:
    one TF32 product per float32 product lands outside it, 3xTF32
    inside."""
    ops = _operands(5, 1, 1, 256, 2, 64, 128, 1)
    y64, s64, yb, sb = ssd_ref.float64_reference_and_bound(*ops)
    shares = [_share(_emulate_kernel(*ops, split=split), (y64, s64),
                     (yb, sb)) for split in (False, True)]
    assert shares[0] > 1.0 > shares[1]

