"""The port's tile autotuner (`repro_torch.tune`) and the keyed fleet
encode against the JAX package's, on the CPU.

The cache: bucketing and keys equal to `repro.tune.cache`'s, round
trips, merges, version mismatches, the user cache before the committed
defaults, and one file format (a file the port writes, the reference
reads, and back).  The tuner: `prune` equal to the reference's, and
`autotune` with injected terms and times giving the reference's
survivors and winner over the same candidates.  No test here times
anything or lowers a Pallas kernel: every measurement is injected.
Both packages' user caches point into `tmp_path` wherever a cache is
read.  The keyed `kernels.encode.ops.encode_fleet` is held against the
reference's `encode_fleet` (its Pallas kernel in interpret mode) with
the JAX G_i handed over, within rtol 2e-4 / atol 1e-3
(`tests/test_kernels.py`'s bound for it).
"""
from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.kernels.encode import ops as ref_enc_ops
from repro.tune import cache as ref_cache
from repro.tune import tuner as ref_tuner
from repro.tune.families import FAMILIES as REF_FAMILIES
from repro_torch.core import encoding
from repro_torch.fleet import FleetTopology, encode_fleet_tiered
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.round_grad import ops as rg_ops
from repro_torch.roofline import kernel_terms
from repro_torch.tune import cache as tc
from repro_torch.tune import tuner
from repro_torch.tune.families import CI_SHAPES, FAMILIES


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' user caches in fresh directories of their own;
    returns the port's user cache."""
    monkeypatch.setenv(tc.CACHE_ENV, str(tmp_path / "torch"))
    monkeypatch.setenv(ref_cache.CACHE_ENV, str(tmp_path / "jax"))
    return tc.TileCache(tc.user_cache_path())


SHAPES = [(936, 300, 500), (1024,), (1, 3), (0, 7), (2016, 300, 501),
          (5632, 500), (128, 8, 33), (2, 2**20 + 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_bucket_and_key_equal_the_reference(shape):
    assert tc.bucket_shape(shape) == ref_cache.bucket_shape(shape)
    for family in ("encode", "encode_prng", "coded_grad", "round_grad"):
        for backend in ("cpu", "cuda-sm90", "tpu"):
            assert tc.cache_key(family, shape, backend) == \
                ref_cache.cache_key(family, shape, backend)
    assert tc.CACHE_VERSION == ref_cache.CACHE_VERSION


def test_cache_key_separates_family_backend_bucket():
    k1 = tc.cache_key("encode", (2016, 300, 501), "cuda-sm90")
    assert k1 == "encode|cuda-sm90|2048x512x512"
    assert tc.cache_key("encode", (2000, 400, 510), "cuda-sm90") == k1
    assert tc.cache_key("encode", (2016, 300, 501), "cpu") != k1
    assert tc.cache_key("encode_prng", (2016, 300, 501), "cuda-sm90") != k1


def test_user_caches_live_apart(tmp_path, monkeypatch):
    """The port never reads the JAX package's cache: its own directory by
    default and its own environment variable."""
    monkeypatch.delenv(tc.CACHE_ENV, raising=False)
    monkeypatch.delenv(ref_cache.CACHE_ENV, raising=False)
    assert tc.user_cache_path() != ref_cache.user_cache_path()
    assert tc.user_cache_path().endswith(
        os.path.join("repro-torch-tune", "tiles.json"))
    monkeypatch.setenv(ref_cache.CACHE_ENV, str(tmp_path))
    assert not tc.user_cache_path().startswith(str(tmp_path))
    assert tc.defaults_path() != ref_cache.defaults_path()


def test_cache_round_trip_and_merge(caches):
    caches.store("encode", (64, 48, 32), "cuda-sm90", (64, 64, 32),
                 {"us": 12.5})
    ent = caches.lookup("encode", (64, 48, 32), "cuda-sm90")
    assert ent["block"] == [64, 64, 32] and ent["us"] == 12.5
    assert caches.lookup("encode", (50, 40, 30), "cuda-sm90") == ent
    assert tc.lookup_block("encode", (64, 48, 32), "cuda-sm90") == \
        (64, 64, 32)
    caches.store("coded_grad", (96, 12), "cuda-sm90", (32,))
    assert tc.lookup_block("encode", (64, 48, 32), "cuda-sm90") == \
        (64, 64, 32)
    assert tc.lookup_block("coded_grad", (96, 12), "cuda-sm90") == (32,)
    assert tc.lookup_block("coded_grad", (96, 12), "cpu") is None


def test_cache_version_mismatch_invalidates(caches):
    key = tc.cache_key("encode", (64, 48, 32), "cuda-sm90")
    os.makedirs(os.path.dirname(caches.path), exist_ok=True)
    with open(caches.path, "w") as f:
        json.dump({"version": tc.CACHE_VERSION + 1,
                   "entries": {key: {"block": [8, 8, 8]}}}, f)
    assert tc.lookup_block("encode", (64, 48, 32), "cuda-sm90") is None
    caches.store("coded_grad", (96, 12), "cuda-sm90", (64,))
    with open(caches.path) as f:
        payload = json.load(f)
    assert payload["version"] == tc.CACHE_VERSION
    assert key not in payload["entries"]


def test_user_cache_wins_over_defaults(caches):
    shape = CI_SHAPES["encode"][0]
    committed = tc.lookup_block("encode", shape, "cuda-sm90")
    assert committed is not None
    mine = next(t for t in enc_ops.TILES if t != committed)
    caches.store("encode", shape, "cuda-sm90", mine)
    assert tc.lookup_block("encode", shape, "cuda-sm90") == mine
    os.remove(caches.path)
    assert tc.lookup_block("encode", shape, "cuda-sm90") == committed


def test_a_cache_file_crosses_between_packages(tmp_path):
    """One schema: entries the port's TileCache writes read back through
    the reference's, and the other way round."""
    path = str(tmp_path / "tiles.json")
    tc.TileCache(path).store("round_grad", (5632, 500), "cuda-sm90", (48,),
                             {"us": 7.0})
    ent = ref_cache.TileCache(path).lookup("round_grad", (5632, 500),
                                           "cuda-sm90")
    assert ent == {"block": [48], "us": 7.0}
    ref_cache.TileCache(path).store("encode", (936, 300, 500), "cpu",
                                    (256, 512, 512), {"us": 3.0})
    port = tc.TileCache(path)
    assert port.lookup("encode", (936, 300, 500), "cpu") == \
        {"block": [256, 512, 512], "us": 3.0}
    assert port.lookup("round_grad", (5632, 500), "cuda-sm90") == ent


PRUNE_CASES = [
    ([(256,), (512,), (1024,), (2048,)], [10.0, 19.9, 20.1, 100.0], 2.0),
    ([(256,), (512,), (1024,)], [0.0, 5.0, 9.0], 2.0),
    ([(8,), (16,), (24,)], [3.0, 3.0, 3.0], 8.0),
    ([(128, 64, 32), (64, 64, 32)], [4.0, 40.0], 8.0),
    ([(1,)], [7.0], 1.0),
]


@pytest.mark.parametrize("cands,bounds,slack", PRUNE_CASES)
def test_prune_equals_the_reference(cands, bounds, slack):
    assert tuner.prune(cands, bounds, slack=slack) == \
        ref_tuner.prune(cands, bounds, slack=slack)
    assert tuner.DEFAULT_SLACK == ref_tuner.DEFAULT_SLACK == 8.0


def test_roofline_bound_is_the_binding_term():
    assert tuner.roofline_bound({"t_compute": 2.0, "t_memory": 5.0}) == 5.0
    assert tuner.roofline_bound({"t_compute": 7.0, "t_memory": 5.0}) == 7.0


def _injected(family, shape):
    """Terms and times of the candidates: bounds of 2, 21, 41, 61 us in
    turn (all but every fourth candidate pruned at slack 8), and times
    that tie from the fourth candidate on."""
    cands = FAMILIES[family].candidate_blocks(shape, "cuda-sm90")
    rank = {tuple(b): i for i, b in enumerate(cands)}

    def terms_fn(block):
        i = rank[tuple(block)]
        return {"t_compute": 1e-6 * (1 + 20 * (i % 4)), "t_memory": 2e-6}

    def measure_fn(block):
        i = rank[tuple(block)]
        return 100.0 - 10.0 * min(i, 3)  # candidates 3, 4, ... tie

    return cands, terms_fn, measure_fn


@pytest.mark.parametrize("family,shape", [
    ("round_grad", (5632, 500)), ("coded_grad", (2016, 500)),
    ("encode", (2016, 300, 501)), ("encode", (359, 100, 257))])
def test_autotune_matches_the_reference(monkeypatch, family, shape):
    """Over the same candidates with the same injected terms and times,
    the port's autotune prunes, measures and picks (ties to the earliest)
    as the reference's does."""
    cands, terms_fn, measure_fn = _injected(family, shape)
    monkeypatch.setattr(REF_FAMILIES[family], "candidate_blocks",
                        lambda shape, backend: list(cands))
    got = tuner.autotune(family, shape, device="cpu", backend="cuda-sm90",
                         store=False, terms_fn=terms_fn,
                         measure_fn=measure_fn)
    want = ref_tuner.autotune(family, shape, backend="cuda-sm90",
                              store=False, terms_fn=terms_fn,
                              measure_fn=measure_fn)
    assert got.candidates == tuple(want.candidates)
    assert got.pruned == tuple(want.pruned)
    assert got.block == want.block
    assert got.us == want.us and got.bound_us == want.bound_us
    assert [b for b, _ in got.measured] == [tuple(b) for b, _ in
                                            want.measured]
    if len(cands) > 4:  # candidates 0, 4, 8 survive; 4 and 8 tie
        assert got.pruned and got.block == cands[4]


def test_autotune_persists_the_winner(caches):
    cands, terms_fn, measure_fn = _injected("round_grad", (5632, 500))
    res = tuner.autotune("round_grad", (5632, 500), device="cpu",
                         backend="cuda-sm90", terms_fn=terms_fn,
                         measure_fn=measure_fn)
    assert tc.lookup_block("round_grad", (5632, 500), "cuda-sm90") == \
        res.block
    ent = caches.lookup("round_grad", (5632, 500), "cuda-sm90")
    assert ent["n_candidates"] == len(cands)
    assert ent["n_pruned"] == len(res.pruned)
    assert ent["torch"] == torch.__version__ and ent["device"] == "cpu"
    assert ent["source"] == "measured" and ent["shape"] == [5632, 500]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cpu_candidates_are_the_default_alone(family):
    fam = FAMILIES[family]
    for shape in CI_SHAPES[family]:
        assert fam.candidate_blocks(shape, "cpu") == \
            [fam.default_block(shape)]


def test_card_candidates():
    """On the card: the kernel's own partition (0,) first, then row
    tiles that are multiples of the 8 warps; kernel 2's instantiations."""
    for family in ("round_grad", "coded_grad"):
        fam = FAMILIES[family]
        for shape in [*CI_SHAPES[family], (37, 13), (9, 3000)]:
            cands = fam.candidate_blocks(shape, "cuda-sm90")
            assert cands[0] == fam.default_block(shape) == (0,)
            assert all(len(b) == 1 and b[0] % 8 == 0 and b[0] > 0
                       for b in cands[1:])
            assert max(b[0] for b in cands) <= max(8, -(-shape[0] // 8) * 8)
    assert FAMILIES["encode"].candidate_blocks((2016, 300, 501),
                                               "cuda-sm90") == \
        list(enc_ops.TILES)
    assert enc_ops.DEFAULT_BLOCK == enc_ops.TILES[0] == (128, 64, 32)
    assert [rg_ops.rows_per_cta(m) for m in (1, 1024, 1025, 2016, 5632,
                                             7200)] == [8, 8, 16, 16, 48, 64]


def test_kernel_3_has_no_family(caches):
    """Kernel 3 launches one tile, so it has no tune family, no CI
    shapes and no committed entries; its wrapper takes "auto" or that
    tile and reads no cache; its roofline is kernel_terms'."""
    assert "encode_prng" not in FAMILIES and "encode_prng" not in CI_SHAPES
    assert set(FAMILIES) == {"encode", "coded_grad", "round_grad"}
    assert not any(k.startswith("encode_prng|") for k in json.load(
        open(tc.defaults_path()))["entries"])
    assert enc_ops._prng_tile("auto") == enc_ops._prng_tile(
        list(enc_ops.PRNG_BLOCK)) == enc_ops.PRNG_BLOCK == (32, 512, 32)
    with pytest.raises(ValueError, match="one tile"):
        enc_ops._prng_tile((64, 512, 32))
    assert kernel_terms("encode_prng", (2016, 300, 501))["bound_s"] > 0


@pytest.mark.parametrize("family", sorted(CI_SHAPES))
def test_committed_defaults_cover_the_ci_shapes_on_the_card(family):
    """`defaults.json` holds a measured `cuda-sm90` entry for every CI
    shape: a candidate tile, the card it was measured on, and the bound
    `roofline.kernel_terms` gives that tile at the entry's shape."""
    fam = FAMILIES[family]
    for shape in CI_SHAPES[family]:
        ent = tc.TileCache(tc.defaults_path()).lookup(family, shape,
                                                      "cuda-sm90")
        assert ent is not None, (family, shape)
        block = tuple(ent["block"])
        assert block in fam.candidate_blocks(shape, "cuda-sm90")
        assert ent["source"] == "measured" and "H100" in ent["device"]
        assert ent["us"] > 0
        bound = 1e6 * kernel_terms(fam.kernel, ent["shape"], block)[
            "bound_s"]
        assert ent["bound_us"] == pytest.approx(bound, abs=1e-3)


# -- the keyed fleet encode -----------------------------------------------

def _fleet(n=3, ell=20, d=9, seed=21):
    key = jax.random.PRNGKey(seed)
    xs = jax.random.normal(key, (n, ell, d))
    ys = jax.random.normal(jax.random.fold_in(key, 1), (n, ell))
    ws = jax.random.uniform(jax.random.fold_in(key, 2), (n, ell),
                            minval=0.2, maxval=1.0)
    return xs, ys, ws


@pytest.mark.parametrize("kind", ["normal", "bernoulli"])
def test_keyed_encode_fleet_matches_the_reference(kind):
    """`kernels.encode.ops.encode_fleet` with the reference's G_i handed
    over (its generators are `jax.random` draws) against the reference's
    `encode_fleet` at `tests/test_kernels.py`'s sizes."""
    from repro.core.encoding import generator_matrix

    n, ell, d, c = 3, 20, 9, 11
    xs, ys, ws = _fleet(n, ell, d)
    keys = jax.random.split(jax.random.PRNGKey(33), n)
    want_x, want_y = ref_enc_ops.encode_fleet(keys, xs, ys, ws, c, kind=kind,
                                              block=(16, 16, 16))
    gs = [np.asarray(generator_matrix(k, c, ell, kind=kind)) for k in keys]
    got_x, got_y = enc_ops.encode_fleet(
        lambda i: torch.tensor(gs[i]), torch.tensor(np.asarray(xs)),
        torch.tensor(np.asarray(ys)), torch.tensor(np.asarray(ws)),
        c, kind=kind, block=enc_ops.DEFAULT_BLOCK)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=2e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=2e-4,
                               atol=1e-3)


def test_keyed_encode_fleet_draws_from_the_client_seeds():
    """With int seeds, client i's G_i is `generator_matrix` of a
    generator seeded with seeds[i]; the result is the plain streamed
    encode of those G_i, bit for bit on the CPU."""
    xs, ys, ws = (torch.tensor(np.asarray(a)) for a in _fleet())
    seeds, c, ell = [5, 9, 2], 11, xs.shape[1]
    got = enc_ops.encode_fleet(seeds, xs, ys, ws, c, kind="bernoulli")

    def g_source(i):
        gen = torch.Generator().manual_seed(seeds[i])
        return encoding.generator_matrix(gen, c, ell, kind="bernoulli")

    want = encoding.encode_fleet_streamed(g_source, xs, ys, ws, c,
                                          lambda g, w, x: g @ (w[:, None] * x))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="seeds"):
        enc_ops.encode_fleet(seeds[:2], xs, ys, ws, c)


def test_block_reaches_the_kernel_wrappers(monkeypatch):
    """`block` goes from `core.encoding.encode_client`/`encode_fleet`,
    `fleet.encode_fleet_tiered` and the keyed `encode_fleet` to the
    wrapper that launches, as the reference forwards it."""
    seen = []
    plain = enc_ops.encode_parity

    def spy(g, w, x, block="auto"):
        seen.append(block)
        return plain(g, w, x, block=block)

    monkeypatch.setattr(enc_ops, "encode_parity", spy)
    xs, ys, ws = (torch.tensor(np.asarray(a)) for a in _fleet())
    tile = (64, 128, 32)
    encoding.encode_client(torch.ones(4, 20), ws[0], xs[0], ys[0],
                           use_kernel=True, block=tile)
    encoding.encode_fleet(torch.Generator().manual_seed(0), xs, ys, ws, 6,
                          use_kernel=True, block=tile)
    enc_ops.encode_fleet([1, 2, 3], xs, ys, ws, 6, block=tile)
    assert seen == [tile] * 7
    prng_seen = []
    prng_plain = enc_ops.encode_fleet_prng_keys

    def prng_spy(*args, block="auto", **kw):
        prng_seen.append(block)
        return prng_plain(*args, block=block, **kw)

    monkeypatch.setattr(enc_ops, "encode_fleet_prng_keys", prng_spy)
    encode_fleet_tiered(np.array([0, 7], dtype=np.uint32), xs, ys, ws, 6,
                        FleetTopology.uniform(3, 2), block=enc_ops.PRNG_BLOCK)
    assert prng_seen == [enc_ops.PRNG_BLOCK] * 2



def test_tune_shapes_takes_the_least_summed_time_of_a_bucket(caches,
                                                             monkeypatch):
    """Shapes of one bucket share one entry: the candidate with the least
    time summed over them (ties to the earlier), not the last shape's
    winner; a shape alone in its bucket keeps its own winner."""
    times = {(5632, 500): {(0,): 15.0, (24,): 14.0, (64,): 17.0},
             (7200, 500): {(0,): 17.0, (24,): 21.0, (64,): 17.0},
             (1200, 256): {(0,): 9.0, (24,): 8.0, (64,): 9.0}}

    def fake_autotune(family, shape, **kw):
        measured = tuple(times[shape].items())
        best = min(measured, key=lambda bu: bu[1])
        return tuner.TuneResult(
            family=family, shape=shape, bucket=tc.bucket_shape(shape),
            backend="cuda-sm90", block=best[0], us=best[1], bound_us=1.0,
            candidates=tuple(times[shape]), bounds_us=(1.0, 2.0, 3.0),
            pruned=(), measured=measured, device="card")

    monkeypatch.setattr(tuner, "autotune", fake_autotune)
    tuner.tune_shapes({"round_grad": list(times)}, verbose=False)
    ent = caches.lookup("round_grad", (7200, 500), "cuda-sm90")
    assert ent["block"] == [0] and ent["shape"] == [7200, 500]
    assert ent["us"] == 17.0 and ent["bound_us"] == 1.0
    assert ent["bucket_us"] == [[[5632, 500], 15.0], [[7200, 500], 17.0]]
    assert tc.lookup_block("round_grad", (1200, 256), "cuda-sm90") == (24,)
