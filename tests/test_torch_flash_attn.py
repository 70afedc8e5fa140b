"""Kernel 8's plain version and the attention layers of the dense serve
path against the JAX package, on the CPU.

  * `kernels.flash_attn` (the wrapper on CPU tensors computes the plain
    version) against the Pallas kernel in interpret mode at
    `tests/test_kernels.py`'s shapes and blocks, within that file's
    rtol 2e-4 / atol 2e-4; against JAX `ref.causal_attention` at ragged
    S and with grouped key/value heads (repeated on the JAX side) within
    the same bound; both within the derived float32 rounding bound of
    `ref.float64_reference_and_bound`;
  * `models.layers` (norms, MLPs, rope, `causal_mask`, `kv_to_cache`,
    `gqa_scores_apply`, `self_attention` with and without the kernel
    route, `decode_self_attention` with one position or one per row)
    against `repro.models.layers` in float32: rtol 1e-5 and atol
    1e-5 * max(1, max|ref|) (float32 products over 64- to 256-wide rows
    taken in another order; seen: ~1e-6), masks and cache layouts equal;
  * kernel 8's 3xTF32 arithmetic (`csrc/flash_attn.cu`: the TF32 split by
    `cvt.rna`, the three products of `mma_tf32.cuh` in their order with
    each tensor-core sum truncated, the online softmax over 64-key tiles)
    emulated in plain torch (the helpers of `test_torch_tf32.py`) and held to the unchanged float64 bound at
    D = 8, 16, 40 and 64, operands scaled x1 and x6 (`-s` prints the
    share, the proxy of the card's), with the rounding helper's own
    properties, and plain TF32 shown to fall outside the bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ops as j_fa_ops
from repro.kernels.flash_attn import ref as j_fa_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn import ref as fa_ref
from repro_torch.models import layers as L
from test_torch_tf32 import product3 as _product3
from test_torch_tf32 import rna_tf32 as _rna_tf32
from test_torch_tf32 import split_tf32 as _split


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=rtol * max(1.0, float(np.abs(want).max())))


def _within_float64_bound(out, q, k, v):
    o64, bound = fa_ref.float64_reference_and_bound(q, k, v)
    assert bool(((out.double() - o64).abs() <= bound).all())


@pytest.mark.parametrize("B,H,S,D,bq,bk", [
    (1, 2, 64, 16, 16, 16), (2, 4, 128, 32, 32, 64), (1, 1, 256, 64, 64, 64),
    (1, 2, 96, 16, 32, 48),
])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(B, H, S, D, bq,
                                                           bk):
    q, k, v = _normal(B + H + S, *[(B, H, S, D)] * 3)
    want = j_fa_ops.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), block_q=bq, block_k=bk,
                                     force_interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fa_ops.causal_attention(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(got, fa_ref.causal_attention(tq, tk, tv))
    _within_float64_bound(got, tq, tk, tv)


# (B, Hq, Hkv, S, D): ragged S, the reduced granite's groups (R = 2),
# R = 3 and 4, one token, a D that is no multiple of 16
GQA_SHAPES = [(1, 4, 2, 37, 64), (2, 6, 2, 100, 16), (1, 8, 2, 1, 64),
              (1, 4, 1, 53, 128), (2, 3, 1, 70, 40)]


@pytest.mark.parametrize("B,Hq,Hkv,S,D", GQA_SHAPES)
def test_plain_matches_the_jax_reference_with_groups(B, Hq, Hkv, S, D):
    q, k, v = _normal(S + D, (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))
    rep = Hq // Hkv
    want = j_fa_ref.causal_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=1),
        jnp.repeat(jnp.asarray(v), rep, axis=1))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fa_ops.causal_attention(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    _within_float64_bound(got, tq, tk, tv)


def test_plain_bf16_against_the_float32_reference():
    """`tests/test_kernels.py::test_flash_attn_bf16`'s check: bf16
    operands within 5e-2 of the float32 reference, output in bf16."""
    q, k, v = _normal(9, *[(1, 2, 64, 32)] * 3)
    want = j_fa_ref.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    got = fa_ops.causal_attention(*(torch.from_numpy(t).bfloat16()
                                    for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=5e-2, atol=5e-2)


def test_wrapper_checks_operands():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="do not divide"):
        fa_ops.causal_attention(q, torch.zeros((1, 3, 8, 16)),
                                torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError, match="expected"):
        fa_ops.causal_attention(q, torch.zeros((1, 2, 8, 16)),
                                torch.zeros((1, 2, 9, 16)))
    big = torch.zeros((1, 1, 4, 136))
    with pytest.raises(ValueError, match="exceeds"):
        fa_ops.causal_attention(big, big, big)
    assert fa_ops.scale(128) == float(np.float32(1.0) /
                                      np.sqrt(np.float32(128)))


# ---------------------------------------------------------------------------
# kernel 8's 3xTF32 arithmetic, emulated in plain torch
# ---------------------------------------------------------------------------

def _emulate_kernel(q, k, v, split=True):
    """`csrc/flash_attn.cu`'s arithmetic on float32 CPU tensors: q scaled
    on load, D padded with zeros to a multiple of 8, 64-key tiles, 3xTF32
    products, -1e30 masks with p = 0 outright, the online softmax with
    one partial sum per lane of a quad (keys 8 j + 2 t + e, summed as the
    kernel's tree: the pair e = 0, 1 of each j, then j with j + 4, j + 2,
    j + 1; the lane's update l * alpha + sum fused, as nvcc contracts it),
    the quad's sums added (l0 + l1) + (l2 + l3) at the end."""
    B, Hq, S, D = q.shape
    rep = Hq // k.shape[1]
    k, v = (t.repeat_interleave(rep, 1) for t in (k, v))
    pad = -D % 8
    qs = torch.nn.functional.pad(q * fa_ops.scale(D), (0, pad))
    k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (k, v))
    rows = torch.arange(S)[:, None]
    m = torch.full((B, Hq, S), -1e30)
    lanes = torch.zeros((B, Hq, S, 4))
    acc = torch.zeros((B, Hq, S, D + pad))
    for t0 in range(0, S, 64):
        tail = (0, 0, 0, 64 - min(64, S - t0))
        kt, vt = (torch.nn.functional.pad(t[:, :, t0:t0 + 64], tail)
                  for t in (k, v))
        keep = (t0 + torch.arange(64) <= rows) & (t0 + torch.arange(64) < S)
        s = _product3(qs, kt.transpose(-1, -2), torch.zeros((B, Hq, S, 64)),
                      split)
        s = torch.where(keep, s, -1e30)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        m = mx
        p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
        by_lane = p.view(B, Hq, S, 8, 4, 2)
        sums = by_lane[..., 0] + by_lane[..., 1]  # (..., j, lane)
        for w in (4, 2, 1):
            sums = sums[..., :w, :] + sums[..., w:2 * w, :]
        sums = sums[..., 0, :]
        lanes = (lanes.double() * alpha[..., None].double()
                 + sums.double()).float()
        acc = _product3(p, vt, acc * alpha[..., None], split)
    den = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
    return (acc / torch.clamp(den, min=1e-30)[..., None])[..., :D]


def test_tf32_rounding_helper():
    """Low 13 bits zero, |x - rna(x)| <= 2^-11 |x|, ties away from zero,
    and the split x = big + small to within 2^-22 |x|."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(100_000) * 10.0 ** rng.integers(-30, 30, 100_000),
        [1.0, -1.0, 0.0, 3.0e38]]).astype(np.float32))
    big = _rna_tf32(x)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((x - big).abs() <= 2.0 ** -11 * x.abs()).all())
    half = torch.tensor([0x3F801000, -0x407FF000], dtype=torch.int32)
    assert _rna_tf32(half.view(torch.float32)).tolist() == [
        1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    big, small = _split(x)
    resid = x.double() - big.double() - small.double()
    assert bool((resid.abs() <= 2.0 ** -22 * x.double().abs()).all())


# (B, Hq, Hkv, S, D, operand scale): D = 8, 16, 40, 64; ragged S up to
# 300; one, three and four query heads per key/value head; q and k scaled
# x6, scores of magnitude ~100
EMULATED = [(1, 2, 2, 300, 8, 1.0), (1, 3, 1, 200, 8, 6.0),
            (1, 4, 1, 257, 16, 1.0), (1, 3, 3, 129, 16, 6.0),
            (1, 6, 2, 300, 40, 1.0), (1, 4, 4, 150, 40, 6.0),
            (2, 4, 1, 200, 64, 1.0), (1, 3, 1, 300, 64, 6.0)]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,mult", EMULATED)
def test_kernel_arithmetic_within_the_float64_bound(B, Hq, Hkv, S, D, mult):
    """The emulated 3xTF32 kernel within the unchanged float32 rounding
    bound of `ref.float64_reference_and_bound` (a proxy of the card's
    share; `-s` prints it)."""
    q, k, v = (torch.from_numpy(a) for a in _normal(
        S + D + Hq, (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    q, k = q * mult, k * mult
    got = _emulate_kernel(q, k, v)
    o64, bound = fa_ref.float64_reference_and_bound(q, k, v)
    share = float(((got.double() - o64).abs() / bound).max())
    print(f"emulated 3xTF32 kernel 8 at (B, Hq, Hkv, S, D) = "
          f"{(B, Hq, Hkv, S, D)}, q and k x{mult:g}: worst element at "
          f"{share:.4f} of the float64 bound")
    assert share <= 1.0
    np.testing.assert_allclose(got.numpy(),
                               fa_ref.causal_attention(q, k, v).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_plain_tf32_is_outside_the_float64_bound():
    """The bound tells the split from plain TF32: one TF32 product per
    float32 product lands far outside it (seen: 20-150x at the shapes of
    EMULATED) where 3xTF32 stays far inside."""
    q, k, v = (torch.from_numpy(a) for a in _normal(
        5, (1, 4, 200, 64), (1, 1, 200, 64), (1, 1, 200, 64)))
    o64, bound = fa_ref.float64_reference_and_bound(q, k, v)
    shares = [float(((_emulate_kernel(q, k, v, split).double() - o64).abs()
                     / bound).max()) for split in (False, True)]
    assert shares[0] > 1.0 > shares[1]


# ---------------------------------------------------------------------------
# models.layers against repro.models.layers
# ---------------------------------------------------------------------------

def test_norms_and_mlps_match_jax():
    x, scale, bias, wg, wu, wd = _normal(
        1, (2, 5, 64), (64,), (64,), (64, 96), (64, 96), (96, 64))
    p = {"scale": scale, "bias": bias}
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    tx = torch.from_numpy(x)
    _close(L.layernorm(tp, tx), JL.layernorm(p, x))
    _close(L.apply_norm(tp, tx, "rms"), JL.apply_norm(p, x, "rms"))
    _close(L.apply_norm(tp, tx, "ln"), JL.apply_norm(p, x, "ln"))
    m = {"w_gate": wg, "w_up": wu, "w_down": wd}
    tm = {k: torch.from_numpy(a) for k, a in m.items()}
    _close(L.mlp(tm, tx, "swiglu"), JL.mlp(m, x, "swiglu"))
    _close(L.mlp(tm, tx, "gelu"), JL.mlp(m, x, "gelu"))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    (x,) = _normal(2, (3, 7, 4, 64))
    pos = np.random.default_rng(3).integers(0, 2100, (3, 7))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           want)
    _close(L.rope_freqs(64, theta), JL.rope_freqs(64, theta), rtol=1e-6)


@pytest.mark.parametrize("S,T,window,offset",
                         [(5, 5, None, 0), (7, 7, 3, 0), (1, 9, None, 8),
                          (4, 12, 5, 8)])
def test_causal_mask_equals_jax(S, T, window, offset):
    want = np.asarray(JL.causal_mask(S, T, window, offset))
    assert L.causal_mask(S, T, window, offset).numpy().tolist() == \
        want.tolist()


@pytest.mark.parametrize("S,window,cache_len", [
    (5, None, None), (5, None, 9), (5, 8, 20), (13, 8, 20), (16, 8, None),
    (6, 8, 4)])
def test_kv_to_cache_equals_jax(S, window, cache_len):
    k, v = _normal(S, (2, S, 2, 8), (2, S, 2, 8))
    want = JL.kv_to_cache(jnp.asarray(k), jnp.asarray(v), window, cache_len)
    got = L.kv_to_cache(torch.from_numpy(k), torch.from_numpy(v), window,
                        cache_len)
    for name in ("k", "v"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
    with pytest.raises(ValueError, match="exceeds"):
        L.kv_to_cache(torch.from_numpy(k), torch.from_numpy(v), None, S - 1)


@pytest.mark.parametrize("mask_kind", ["causal", "window", "none", "rows"])
def test_gqa_scores_apply_matches_jax(mask_kind):
    B, S, T, Hq, Hkv, D = 2, 9, 9, 4, 2, 64
    q, k, v = _normal(4, (B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    if mask_kind == "causal":
        mask = np.array(JL.causal_mask(S, T))
    elif mask_kind == "window":
        mask = np.array(JL.causal_mask(S, T, 4))
    elif mask_kind == "rows":  # one row of keys per batch row, as decode
        mask = (np.arange(T)[None, :] <= np.array([[3], [7]]))[
            :, None, None, None, :]
    else:
        mask = None
    want = JL.gqa_scores_apply(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v),
                               None if mask is None else jnp.asarray(mask))
    got = L.gqa_scores_apply(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             None if mask is None else torch.from_numpy(mask))
    _close(got, want)


def _attn_params(seed, d, hq, hkv, hd, bias):
    jp = JL.init_attention(jax.random.PRNGKey(seed), d, hq, hkv, hd,
                           jnp.float32, bias=bias)
    if bias:  # non-zero biases, so that they are exercised
        rng = np.random.default_rng(seed)
        jp = {k: (rng.standard_normal(a.shape).astype(np.float32)
                  if k.startswith("b") else a) for k, a in jp.items()}
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    return jp, tp


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_self_attention_matches_jax(window, bias, use_kernel):
    B, S, d, hq, hkv, hd = 2, 13, 256, 4, 2, 64
    jp, tp = _attn_params(7, d, hq, hkv, hd, bias)
    (x,) = _normal(8, (B, S, d))
    pos = np.broadcast_to(np.arange(S)[None, :], (B, S))
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, theta=1e4,
              window=window, return_kv=True)
    want, (jk, jv) = JL.self_attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                       **kw)
    got, (k, v) = L.self_attention(tp, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()),
                                   use_kernel=use_kernel, **kw)
    _close(got, want)
    _close(k, jk)
    _close(v, jv)


def test_self_attention_kernel_route_takes_the_wrapper(monkeypatch):
    """Causal attention with no window goes to the kernel wrapper with
    (B, H, S, D) views of the projections; a window or use_kernel=False
    does not."""
    calls = []
    real = fa_ops.causal_attention

    def spy(q, k, v):
        calls.append((tuple(q.shape), tuple(k.shape), q.is_contiguous()))
        return real(q, k, v)

    monkeypatch.setattr(fa_ops, "causal_attention", spy)
    _, tp = _attn_params(1, 256, 4, 2, 64, False)
    x = torch.from_numpy(_normal(2, (1, 6, 256))[0])
    pos = torch.arange(6)[None, :]
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=64, theta=1e4)
    L.self_attention(tp, x, pos, **kw)
    assert calls == [((1, 4, 6, 64), (1, 2, 6, 64), False)]
    L.self_attention(tp, x, pos, window=3, **kw)
    L.self_attention(tp, x, pos, use_kernel=False, **kw)
    assert len(calls) == 1


@pytest.mark.parametrize("window", [None, 8])
def test_decode_self_attention_matches_jax(window):
    """One position for the batch against JAX; one position per row
    against JAX's one-row decode at that row's position (the engine's
    vmap), the rolling cache past its window included."""
    B, T, d, hq, hkv, hd = 3, 8 if window else 12, 256, 4, 2, 64
    jp, tp = _attn_params(3, d, hq, hkv, hd, False)
    x, ck, cv = _normal(5, (B, 1, d), (B, T, hkv, hd), (B, T, hkv, hd))
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, theta=1e4,
              window=window)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got, new = L.decode_self_attention(tp, torch.from_numpy(x), cache, 5,
                                       **kw)
    want, jnew = JL.decode_self_attention(
        jp, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.asarray(5, jnp.int32), **kw)
    _close(got, want)
    for name in ("k", "v"):
        assert new[name] is cache[name]  # written in place
        _close(new[name], jnew[name])
    pos = np.array([2, 11, 5]) if window else np.array([0, 11, 6])
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got, new = L.decode_self_attention(tp, torch.from_numpy(x), cache,
                                       torch.from_numpy(pos), **kw)
    for b in range(B):
        want, jnew = JL.decode_self_attention(
            jp, jnp.asarray(x[b:b + 1]),
            {"k": jnp.asarray(ck[b:b + 1]), "v": jnp.asarray(cv[b:b + 1])},
            jnp.asarray(pos[b], jnp.int32), **kw)
        _close(got[b:b + 1], want)
        for name in ("k", "v"):
            _close(new[name][b:b + 1], jnew[name])
