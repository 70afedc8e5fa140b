"""The port's roofline (`repro_torch.roofline`) on the CPU.

`active_params`, `model_flops` and `dominant_term` against the JAX
package's for every config it registers, crossed to the port's
`ArchConfig` by its fields, at every `INPUT_SHAPES` entry (exact: the
same integer and float arithmetic).  `kernel_terms` without a tile
against the formulas `chip_smoke.py` computed each kernel's bound with
before the roofline held them (exact), and with a tile that pads above
the tile-free count.  Nothing here runs a kernel.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro.configs import base as ref_base
from repro.configs.base import list_archs as ref_list_archs
from repro.roofline import analysis as ref_analysis
from repro_torch.configs import base
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.round_grad import ops as rg_ops
from repro_torch.roofline import analysis
from repro_torch.tune.families import FAMILIES

HBM, FP32, TF32 = 3.35e12, 67e12, 495e12
INT32 = 64 * 132 * 1.98e9


def _cross(value):
    """A reference config (or spec) as the port's dataclass of the same
    name, field for field."""
    if not dataclasses.is_dataclass(value):
        return value
    cls = getattr(base, type(value).__name__)
    return cls(**{f.name: _cross(getattr(value, f.name))
                  for f in dataclasses.fields(value)})


@pytest.mark.parametrize("arch", ref_list_archs())
def test_model_flops_equal_the_reference(arch):
    ref_cfg = ref_base.get_config(arch)
    for cfg_ref in (ref_cfg, ref_cfg.reduced()):
        cfg = _cross(cfg_ref)
        assert analysis.active_params(cfg) == \
            ref_analysis.active_params(cfg_ref)
        for shape in ref_base.INPUT_SHAPES:
            assert analysis.model_flops(cfg, shape) == \
                ref_analysis.model_flops(cfg_ref, shape), (arch, shape)
    assert base.INPUT_SHAPES == ref_base.INPUT_SHAPES


@pytest.mark.parametrize("terms", [
    {"t_compute": 3.0, "t_memory": 1.0, "t_collective": 2.0},
    {"t_compute": 0.0, "t_memory": 1.0, "t_collective": 2.0},
    {"t_compute": 1.0, "t_memory": 4.0, "t_collective": 0.0}])
def test_dominant_term_equals_the_reference(terms):
    assert analysis.dominant_term(terms) == ref_analysis.dominant_term(terms)


def test_the_h100_rates():
    assert (analysis.HBM_BYTES_PER_S, analysis.FP32_FLOPS_PER_S,
            analysis.TF32_FLOPS_PER_S, analysis.INT32_OPS_PER_S) == \
        (HBM, FP32, TF32, INT32)


def _before(family, shape, weighted=True):
    """(bytes, float32 flops, bound seconds) of one kernel by the formulas
    chip_smoke.py held inline before `kernel_terms`."""
    if family == "round_grad":
        m, d = shape
        n_bytes = 4 * (m * d + m * (2 if weighted else 1) + 2 * d)
        flops = 4 * m * d + 3 * m
        return n_bytes, flops, max(n_bytes / HBM, flops / FP32)
    if family == "coded_round_grad":
        m, c, d = shape
        n_bytes = 4 * ((m + c) * d + 2 * (m + c) + 2 * d)
        flops = 4 * (m + c) * d + 3 * (m + c)
        return n_bytes, flops, max(n_bytes / HBM, flops / FP32)
    if family == "tier_round_grad":
        m, d, nt = shape
        n_bytes = 4 * (m * d + 2 * m + nt * m + d + nt * d)
        flops = 2 * m * d + 2 * nt * m * d + 2 * m + nt * m
        return n_bytes, flops, max(n_bytes / HBM, flops / FP32)
    if family == "coded_grad":
        m, d = shape
        n_bytes = 4 * (m * d + m + 2 * d)
        flops = 4 * m * d + m
        return n_bytes, flops, max(n_bytes / HBM, flops / FP32)
    if family == "encode":
        c, ell, d1 = shape
        flops = 2 * c * ell * d1 + ell * d1
        n_bytes = 4 * (c * ell + ell + ell * d1 + c * d1)
        return n_bytes, flops, max(n_bytes / HBM,
                                   3 * 2 * c * ell * d1 / TF32)
    if family == "encode_prng":
        c, ell, d1 = shape
        flops = 2 * c * ell * d1 + ell * d1
        n_bytes = 4 * (ell + ell * d1 + c * d1)
        return n_bytes, flops, max(n_bytes / HBM,
                                   max(3 * 2 * c * ell * d1 / TF32,
                                       80 * c * ell / INT32))
    if family == "ssd_chunk":
        B, nc, Q, H, P, N, G = shape
        tri = Q * (Q + 1) // 2
        flops = B * nc * (G * tri * 2 * N + H * (tri * 2 * P + 2 * Q * P * N))
        n_bytes = 4 * (B * nc * Q * H * (2 * P + 2) + 2 * B * nc * Q * G * N
                       + B * nc * H * P * N)
        return n_bytes, flops, max(n_bytes / HBM, 3 * flops / TF32)
    B, Hq, Hkv, S, D = shape
    flops = 4 * B * Hq * D * S * (S + 1) // 2
    n_bytes = 4 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    return n_bytes, flops, max(n_bytes / HBM, 3 * flops / TF32)


# the shapes chip_smoke.py times each kernel at
DRIVEN = [("round_grad", (5632, 500), True),
          ("round_grad", (7200, 500), False),
          ("coded_round_grad", (7200, 2016, 500), True),
          ("tier_round_grad", (5632, 500, 3), True),
          ("coded_grad", (2016, 500), True),
          ("encode", (2016, 300, 501), True),
          ("encode_prng", (2016, 300, 501), True),
          ("ssd_chunk", (1, 8, 256, 64, 64, 128, 1), True),
          ("causal_attention", (1, 32, 8, 2048, 128), True)]


@pytest.mark.parametrize("family,shape,weighted", DRIVEN)
def test_kernel_terms_read_the_figures_of_before(family, shape, weighted):
    terms = analysis.kernel_terms(family, shape, weighted=weighted)
    n_bytes, flops, bound = _before(family, shape, weighted)
    assert terms["bytes"] == n_bytes and terms["flops"] == flops
    assert terms["bound_s"] == bound
    assert terms["bound_s"] == max(terms["t_compute"], terms["t_memory"])
    assert terms["t_collective"] == 0.0
    assert terms["bound_by"] == ("bytes" if family.endswith("grad")
                                 else "operations")
    assert analysis.dominant_term(terms) == (
        "memory" if terms["bound_by"] == "bytes" else "compute")


@pytest.mark.parametrize("family,shape", [
    ("round_grad", (5632, 500)), ("coded_grad", (2016, 500)),
    ("encode", (2016, 300, 501)), ("encode", (359, 100, 257)),
    ("encode", (2160, 300, 513)), ("encode", (3600, 300, 501))])
def test_a_tile_bounds_at_least_the_least_work(family, shape):
    """Every candidate's tile grid issues at least the least work, and
    the row tiles' float64 partials grow as the tiles shrink."""
    free = analysis.kernel_terms(family, shape)["bound_s"]
    bounds = {b: analysis.kernel_terms(family, shape, b)["bound_s"]
              for b in FAMILIES[family].candidate_blocks(shape, "cuda-sm90")}
    assert all(b >= free for b in bounds.values())
    if family in ("round_grad", "coded_grad"):  # past the own partition
        tiles = sorted(bounds)[1:]
        assert all(bounds[a] > bounds[b] for a, b in zip(tiles, tiles[1:]))
        own = analysis.kernel_terms(family, shape, (0,))["bound_s"]
        rpc = (rg_ops.rows_per_cta(shape[0]),)
        assert own == analysis.kernel_terms(family, shape, rpc)["bound_s"]


def test_a_tile_that_pads_computes_its_padding():
    """At c = 359 a 128-row tile computes 384 rows and a 64-row one 384
    too, at d = 257 a 64-column tile 320 columns and a 128-column one 384;
    L pads to the step of 8."""
    shape = (359, 100, 257)
    flops = {b: analysis.kernel_terms("encode", shape, b)["pipes"]["tf32"]
             * TF32 / 3 for b in enc_ops.TILES}
    assert flops[(128, 64, 32)] == 2 * 384 * 104 * 320
    assert flops[(128, 128, 32)] == 2 * 384 * 104 * 384
    assert flops[(64, 32, 32)] == 2 * 384 * 104 * 288
    free = analysis.kernel_terms("encode", shape)
    assert free["pipes"]["tf32"] * TF32 / 3 == 2 * 359 * 100 * 257
    assert analysis.kernel_terms("encode", shape, (128, 128, 32))[
        "bound_s"] > free["bound_s"]


def test_kernel_terms_refuses_what_no_kernel_launches():
    with pytest.raises(ValueError, match="takes no tile"):
        analysis.kernel_terms("encode_prng", (64, 8, 33), (32, 512, 32))
    with pytest.raises(ValueError, match="takes no tile"):
        analysis.kernel_terms("causal_attention", (1, 2, 2, 16, 8), (64,))
    with pytest.raises(ValueError, match="unknown kernel family"):
        analysis.kernel_terms("matmul", (4, 4))
