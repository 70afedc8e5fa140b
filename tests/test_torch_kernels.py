"""Plain paths of the port's kernels against the JAX package's Pallas
kernels (interpret mode) and their jnp oracles, on the CPU: the flat,
coded and tier-masked round gradients and the parity encode.

On a CPU tensor each kernel wrapper computes its plain PyTorch version,
so these tests hold the arithmetic the CUDA kernels are checked against
on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).

Bounds are the reference's own:
  * round gradients (flat, coded, each tier partial): rtol 1e-3 /
    atol 1e-6, the round-gradient bound of the reference's fleet-layer
    contract — float32 sums over up to ~1000 rows taken in another order
    than the interpreted Pallas grid;
  * the tier-masked plain path at T = 1 with an all-ones mask:
    bit-equal to the flat plain path (the single-tier contract);
  * encode: rtol 2e-4 and atol 2e-4 * max|ref| (`tests/test_kernels.py`)
    — a float32 contraction over L, tiled differently.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.encode import ops as j_enc_ops
from repro.kernels.encode import ref as j_enc_ref
from repro.kernels.round_grad import ops as j_rg_ops
from repro.kernels.round_grad import ref as j_rg_ref
from repro_torch.core import aggregation, encoding
from repro_torch.kernels.encode import ops as t_enc_ops
from repro_torch.kernels.encode import ref as t_enc_ref
from repro_torch.kernels.round_grad import ops as t_rg_ops
from repro_torch.kernels.round_grad import ref as t_rg_ref

RG_TOL = dict(rtol=1e-3, atol=1e-6)


def _rg_inputs(m, d, weights, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    if weights == "none":
        return x, y, None, beta
    w = rng.uniform(0.0, 1.0, m).astype(np.float32)
    if weights == "zero_rows":
        w[rng.uniform(size=m) < 0.4] = 0.0
        w[m // 2:] = 0.0
    return x, y, w, beta


# ragged M: not a multiple of the CUDA kernel's 8-row tiles or 32-row CTAs,
# and 1030 overruns the Pallas kernel's 1024-row default tile
@pytest.mark.parametrize("m,d", [(1, 1), (7, 5), (130, 33), (300, 41),
                                 (1030, 24)])
@pytest.mark.parametrize("weights", ["random", "zero_rows", "none"])
def test_round_grad_plain_matches_pallas(m, d, weights):
    x, y, w, beta = _rg_inputs(m, d, weights, seed=m * 100 + d)
    jw = jnp.ones(m, jnp.float32) if w is None else jnp.asarray(w)
    want_kernel = np.asarray(j_rg_ops.masked_round_gradient(
        jnp.asarray(x), jnp.asarray(y), None if w is None else jw,
        jnp.asarray(beta), force_interpret=True))
    want_ref = np.asarray(j_rg_ref.masked_round_gradient(
        jnp.asarray(x), jnp.asarray(y), jw, jnp.asarray(beta)))
    tx, ty, tb = (torch.from_numpy(a) for a in (x, y, beta))
    tw = None if w is None else torch.from_numpy(w)
    got = {
        "ref": t_rg_ref.masked_round_gradient(tx, ty, tw, tb),
        "ops": t_rg_ops.masked_round_gradient(tx, ty, tw, tb),
        "fused": aggregation.round_gradient(tx, ty, tb, w=tw,
                                            path=aggregation.FUSED),
        "reference": aggregation.round_gradient(
            tx, ty, tb, w=tw, path=aggregation.REFERENCE),
    }
    for name, g in got.items():
        assert g.shape == (d,) and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want_kernel, **RG_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), want_ref, **RG_TOL,
                                   err_msg=name)


# ragged m and c, an empty parity block (the flat kernel runs), scalar and
# per-row parity weights, and w = None on the systematic rows
@pytest.mark.parametrize("m,c,d", [(1, 1, 1), (7, 3, 5), (130, 0, 33),
                                   (300, 77, 41), (1030, 250, 24)])
@pytest.mark.parametrize("w_par", ["rows", "scalar"])
@pytest.mark.parametrize("weights", ["zero_rows", "none"])
def test_coded_round_grad_plain_matches_pallas(m, c, d, w_par, weights):
    x, y, w, beta = _rg_inputs(m, d, weights, seed=m + 7 * c + d)
    xp, yp, wp, _ = _rg_inputs(c, d, "zero_rows", seed=c + 11 * d)
    if w_par == "scalar":
        wp = np.float32(0.37)
    jw = jnp.ones(m, jnp.float32) if w is None else jnp.asarray(w)
    jargs = (jnp.asarray(x), jnp.asarray(y), jw, jnp.asarray(xp),
             jnp.asarray(yp), jnp.asarray(wp), jnp.asarray(beta))
    want_kernel = np.asarray(j_rg_ops.coded_round_gradient(
        *jargs, force_interpret=True))
    want_ref = np.asarray(j_rg_ref.coded_round_gradient(*jargs))
    tx, ty, txp, typ, tb = (torch.from_numpy(a) for a in (x, y, xp, yp,
                                                          beta))
    tw = None if w is None else torch.from_numpy(w)
    twp = torch.tensor(wp) if w_par == "scalar" else torch.from_numpy(wp)
    got = {
        "ref": t_rg_ref.coded_round_gradient(tx, ty, tw, txp, typ, twp, tb),
        "ops": t_rg_ops.coded_round_gradient(tx, ty, tw, txp, typ, twp, tb),
        "fused": aggregation.coded_round_gradient(
            tx, ty, tw, txp, typ, twp, tb, path=aggregation.FUSED),
        "reference": aggregation.coded_round_gradient(
            tx, ty, tw, txp, typ, twp, tb, path=aggregation.REFERENCE),
    }
    for name, g in got.items():
        assert g.shape == (d,) and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want_kernel, **RG_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), want_ref, **RG_TOL,
                                   err_msg=name)


def _tier_masks(m, t, seed, gated):
    rng = np.random.default_rng(seed)
    tier_of = rng.integers(0, t, m)
    masks = (np.arange(t)[:, None] == tier_of[None, :]).astype(np.float32)
    if gated:  # inverse-probability participation gates
        masks = masks * (rng.uniform(size=m) < 0.6) / np.float32(0.6)
    return masks.astype(np.float32)


@pytest.mark.parametrize("m,d", [(7, 5), (130, 33), (1030, 24)])
@pytest.mark.parametrize("t,gated", [(1, False), (3, False), (3, True)])
@pytest.mark.parametrize("weights", ["random", "none"])
def test_tier_round_grad_plain_matches_pallas(m, d, t, gated, weights):
    x, y, w, beta = _rg_inputs(m, d, weights, seed=3 * m + d + t)
    masks = _tier_masks(m, t, seed=m + t, gated=gated)
    jw = None if w is None else jnp.asarray(w)
    jx, jy, jm, jb = (jnp.asarray(a) for a in (x, y, masks, beta))
    want_kernel = np.asarray(j_rg_ops.tier_masked_round_gradient(
        jx, jy, jw, jm, jb, force_interpret=True))
    want_ref = np.asarray(j_rg_ref.tier_masked_round_gradient(
        jx, jy, jnp.ones(m, jnp.float32) if w is None else jw, jm, jb))
    tx, ty, tm, tb = (torch.from_numpy(a) for a in (x, y, masks, beta))
    tw = None if w is None else torch.from_numpy(w)
    got = {
        "ref": t_rg_ref.tier_masked_round_gradient(tx, ty, tw, tm, tb),
        "ops": t_rg_ops.tier_masked_round_gradient(tx, ty, tw, tm, tb),
        "fused": aggregation.tiered_round_gradient(
            tx, ty, tb, tw, tm, path=aggregation.FUSED),
        "reference": aggregation.tiered_round_gradient(
            tx, ty, tb, tw, tm, path=aggregation.REFERENCE),
    }
    for name, g in got.items():
        assert g.shape == (t, d) and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want_kernel, **RG_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), want_ref, **RG_TOL,
                                   err_msg=name)
    # the cloud stage: the tiers summed in order, the reference's combine
    from repro.core import aggregation as j_agg
    np.testing.assert_allclose(
        aggregation.cross_tier_combine(got["ops"]).numpy(),
        np.asarray(j_agg.cross_tier_combine(jnp.asarray(want_kernel))),
        **RG_TOL)


@pytest.mark.parametrize("weights", ["random", "none"])
def test_single_tier_plain_path_is_the_flat_one(weights):
    x, y, w, beta = (None if a is None else torch.from_numpy(a)
                     for a in _rg_inputs(130, 33, weights, seed=9))
    ones = torch.ones((1, 130))
    tiered = t_rg_ops.tier_masked_round_gradient(x, y, w, ones, beta)
    assert torch.equal(tiered[0], t_rg_ops.masked_round_gradient(x, y, w,
                                                                 beta))
    assert torch.equal(aggregation.cross_tier_combine(tiered), tiered[0])


def test_round_grad_zero_weight_rows_drop_out():
    """Rows at weight 0 contribute nothing: the packed layout's padding
    contract.  Equal to the same gradient over the kept rows alone."""
    x, y, _, beta = _rg_inputs(64, 9, "none", seed=5)
    w = np.zeros(64, np.float32)
    w[:21] = 1.0
    tx, ty, tb = (torch.from_numpy(a) for a in (x, y, beta))
    full = t_rg_ops.masked_round_gradient(tx, ty, torch.from_numpy(w), tb)
    kept = t_rg_ops.masked_round_gradient(tx[:21].contiguous(),
                                          ty[:21].contiguous(), None, tb)
    np.testing.assert_allclose(full.numpy(), kept.numpy(), **RG_TOL)


def test_plain_paths_launch_no_kernel():
    """CPU tensors never touch the launch counters."""
    counters = (t_rg_ops.COUNTER, t_rg_ops.CODED_COUNTER,
                t_rg_ops.TIER_COUNTER, t_enc_ops.COUNTER)
    before = [k.launches for k in counters]
    x, y, w, beta = (torch.from_numpy(a) for a in
                     _rg_inputs(16, 4, "random", seed=1))
    t_rg_ops.masked_round_gradient(x, y, w, beta)
    t_rg_ops.coded_round_gradient(x, y, w, x[:5], y[:5], 0.5, beta)
    t_rg_ops.tier_masked_round_gradient(x, y, w, torch.ones(2, 16), beta)
    t_enc_ops.encode_parity(torch.ones(3, 16), w, x)
    assert [k.launches for k in counters] == before


def _encode_bound(want):
    return dict(rtol=2e-4, atol=2e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("c,ell,d", [(5, 7, 3), (64, 33, 17),
                                     (130, 60, 65)])
def test_encode_plain_matches_pallas(c, ell, d):
    rng = np.random.default_rng(c * ell + d)
    g = rng.standard_normal((c, ell)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, ell).astype(np.float32)
    x = rng.standard_normal((ell, d)).astype(np.float32)
    want_kernel = np.asarray(j_enc_ops.encode_parity(
        jnp.asarray(g), jnp.asarray(w), jnp.asarray(x),
        force_interpret=True))
    want_ref = np.asarray(j_enc_ref.encode_parity(
        jnp.asarray(g), jnp.asarray(w), jnp.asarray(x)))
    tg, tw, tx = (torch.from_numpy(a) for a in (g, w, x))
    for name, fn in (("ref", t_enc_ref.encode_parity),
                     ("ops", t_enc_ops.encode_parity)):
        got = fn(tg, tw, tx).numpy()
        assert got.shape == (c, d), name
        np.testing.assert_allclose(got, want_kernel,
                                   **_encode_bound(want_kernel),
                                   err_msg=name)
        np.testing.assert_allclose(got, want_ref, **_encode_bound(want_ref),
                                   err_msg=name)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_encode_fleet_streamed_matches_explicit_oracle(use_kernel):
    """The streamed fleet encoder, fed the same G_i stack, equals the
    reference's explicit-generator oracle `ref.encode_fleet`."""
    rng = np.random.default_rng(42)
    n, c, ell, d = 5, 24, 40, 12
    gs = rng.standard_normal((n, c, ell)).astype(np.float32)
    ws = rng.uniform(0.0, 1.0, (n, ell)).astype(np.float32)
    xs = rng.standard_normal((n, ell, d)).astype(np.float32)
    ys = rng.standard_normal((n, ell)).astype(np.float32)
    want_x, want_y = (np.asarray(a) for a in j_enc_ref.encode_fleet(
        jnp.asarray(gs), jnp.asarray(ws), jnp.asarray(xs), jnp.asarray(ys)))
    client = t_enc_ops.encode_parity if use_kernel \
        else t_enc_ref.encode_parity
    got_x, got_y = encoding.encode_fleet_streamed(
        lambda i: torch.from_numpy(gs[i]), torch.from_numpy(xs),
        torch.from_numpy(ys), torch.from_numpy(ws), c, client)
    np.testing.assert_allclose(got_x.numpy(), want_x, **_encode_bound(want_x))
    np.testing.assert_allclose(got_y.numpy(), want_y, **_encode_bound(want_y))
    one = encoding.encode_client(torch.from_numpy(gs[0]),
                                 torch.from_numpy(ws[0]),
                                 torch.from_numpy(xs[0]),
                                 torch.from_numpy(ys[0]),
                                 use_kernel=use_kernel)
    want_one = gs[0] @ (ws[0][:, None] * xs[0])
    np.testing.assert_allclose(one.x_parity.numpy(), want_one,
                               **_encode_bound(want_one))


@pytest.mark.parametrize("kind", ["normal", "bernoulli"])
def test_generator_matrix(kind):
    c, ell = 200, 300
    g = encoding.generator_matrix(torch.Generator().manual_seed(3), c, ell,
                                  kind=kind)
    assert g.shape == (c, ell) and g.dtype == torch.float32
    again = encoding.generator_matrix(torch.Generator().manual_seed(3), c,
                                      ell, kind=kind)
    assert torch.equal(g, again)  # same generator seed, same draw
    vals = g.double().numpy().ravel()
    if kind == "bernoulli":
        assert set(np.unique(vals)) == {-1.0, 1.0}
    # mean 0 and variance 1 within 5 standard errors of their estimates
    n = vals.size
    assert abs(vals.mean()) < 5.0 / np.sqrt(n)
    assert abs(vals.var() - 1.0) < 5.0 * np.sqrt(2.0 / n)
    with pytest.raises(ValueError):
        encoding.generator_matrix(torch.Generator(), 2, 2, kind="uniform")


def test_encode_fleet_draws_clients_in_order():
    """`encode_fleet` draws client i's G_i as the i-th draw of its
    generator: equal to the streamed encoder fed those draws."""
    rng = np.random.default_rng(8)
    n, c, ell, d = 3, 10, 16, 5
    xs = torch.from_numpy(rng.standard_normal((n, ell, d)).astype(np.float32))
    ys = torch.from_numpy(rng.standard_normal((n, ell)).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(size=(n, ell)).astype(np.float32))
    got = encoding.encode_fleet(torch.Generator().manual_seed(4), xs, ys, ws,
                                c)
    gen = torch.Generator().manual_seed(4)
    gs = [encoding.generator_matrix(gen, c, ell) for _ in range(n)]
    want = encoding.encode_fleet_streamed(lambda i: gs[i], xs, ys, ws, c,
                                          t_enc_ref.encode_parity)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_aggregation_helpers_match_reference():
    """The plain aggregation helpers against `repro.core.aggregation` on
    the same inputs (float32 sums in another order: the round-gradient
    bound; the Eq.-3 update and NMSE within float32 rounding)."""
    from repro.core import aggregation as j_agg
    rng = np.random.default_rng(12)
    xs = rng.standard_normal((3, 20, 6)).astype(np.float32)
    ys = rng.standard_normal((3, 20)).astype(np.float32)
    beta = rng.standard_normal(6).astype(np.float32)
    xp = rng.standard_normal((9, 6)).astype(np.float32)
    yp = rng.standard_normal(9).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(xs=xs, ys=ys, beta=beta, xp=xp, yp=yp).items()}
    j = {k: jnp.asarray(v) for k, v in
         dict(xs=xs, ys=ys, beta=beta, xp=xp, yp=yp).items()}
    np.testing.assert_allclose(
        aggregation.uncoded_full_gradient(t["xs"], t["ys"], t["beta"]),
        j_agg.uncoded_full_gradient(j["xs"], j["ys"], j["beta"]), **RG_TOL)
    np.testing.assert_allclose(
        aggregation.parity_gradient(t["xp"], t["yp"], t["beta"]),
        j_agg.parity_gradient(j["xp"], j["yp"], j["beta"]), **RG_TOL)
    gram, gramy = aggregation.parity_gram(t["xp"], t["yp"])
    jgram, jgramy = j_agg.parity_gram(j["xp"], j["yp"])
    np.testing.assert_allclose(gram, jgram, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        aggregation.gram_parity_gradient(gram, gramy, t["beta"], 9.0),
        j_agg.gram_parity_gradient(jgram, jgramy, j["beta"], 9.0), **RG_TOL)
    lr = torch.tensor(0.05, dtype=torch.float32)
    got = aggregation.gd_update(t["beta"], t["yp"][:6], lr, 60)
    want = j_agg.gd_update(j["beta"], j["yp"][:6], jnp.float32(0.05),
                           jnp.int32(60))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(aggregation.nmse(t["beta"], t["yp"][:6]),
                               j_agg.nmse(j["beta"], j["yp"][:6]), rtol=1e-6)
