"""The kernels' pure routing functions, on the CPU.

`repro_torch.kernels.round_grad.ops.route` says which launch a round
gradient of D columns takes on the card (the row-resident instances, one
launch over thread-block clusters along D, or the residual pass and the
column-chunked launch), and `repro_torch.kernels.flash_attn.ops.instance`
which compiled instance of kernel 8 a head size takes.  Both are pure
functions of their arguments, mirrored by the libraries' `rg_route` and
`flash_attn_instance` (held equal to them on the card in
`tests/test_torch_cuda.py`); here they are held to the constants of the
CUDA sources they mirror.  No card and no kernel is needed.
"""
from __future__ import annotations

import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.round_grad import ops as rg_ops


def _constant(source: str, name: str) -> int:
    """The integer literal of `constexpr int name = ...;` in
    csrc/<source>.cu."""
    text = (build.CSRC / f"{source}.cu").read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    assert found, name
    return int(found[1])


def test_route_constants_mirror_the_source():
    """The wrapper's route constants are the CUDA source's: the chunk of
    columns a CTA sums, the cluster sizes, and the widest D whose two-row
    rings of four masks fit the CTA's shared memory (resident_max_d)."""
    assert rg_ops.CHUNK == 32 * _constant("round_grad", "kLaneCols")
    assert rg_ops.MAX_CLUSTER == _constant("round_grad", "kMaxCluster")
    assert rg_ops.PORTABLE_CLUSTER == _constant("round_grad",
                                                "kPortableCluster")
    warps = _constant("round_grad", "kThreads") // 32
    tiers = _constant("round_grad", "kMaxTiers")
    dyn_floats = (232448 - 64) // 4

    def pad4(n):
        return (n + 3) & ~3

    def floats(d):  # smem_floats(d, kMaxTiers, 2): beta, then the rings
        return 2 * pad4(d) + warps * 2 * (pad4(d) + pad4(2 + tiers))

    widest = max(d for d in range(1, 8193) if floats(d) <= dyn_floats)
    assert rg_ops.RESIDENT_MAX_D == widest


@pytest.mark.parametrize("d,coded,want", [
    (1, False, "resident"), (500, False, "resident"),
    (3220, False, "resident"), (3220, True, "resident"),
    (3221, False, "cluster"), (3221, True, "cluster"),
    (3584, False, "cluster"), (4096, False, "cluster"),
    (4096, True, "cluster"), (4097, False, "cluster"),
    (4097, True, "two_launch"), (8192, False, "cluster"),
    (8192, True, "two_launch"), (8193, False, "two_launch"),
    (20000, False, "two_launch")])
def test_round_grad_route(d, coded, want):
    """D up to 3220 the row-resident instances; past it clusters of up to
    16 CTAs of 512 columns (the coded kernel's of up to 8: D <= 4096);
    wider the two-launch route."""
    assert rg_ops.route(d, coded=coded) == want


@pytest.mark.parametrize("d,coded", [(500, False), (4096, False),
                                     (4096, True), (8192, False),
                                     (8192, True), (9000, False)])
def test_only_the_two_launch_route_takes_the_scratch(d, coded):
    """The float64 coefficient scratch is allocated for the two-launch
    route alone (the cluster route forms the coefficients in the launch),
    and never for an empty block."""
    res = rg_ops._residuals(7, d, torch.device("cpu"), coded=coded)
    if rg_ops.route(d, coded=coded) == "two_launch":
        assert res is not None and res.shape == (7,) \
            and res.dtype == torch.float64
    else:
        assert res is None
    assert rg_ops._residuals(0, d, torch.device("cpu"), coded=coded) is None


def test_instance_constants_mirror_the_source():
    assert _constant("flash_attn", "kMaxNd") == 16
    assert _constant("flash_attn", "kNarrowNd") == 8
    assert fa_ops.MAX_D == 8 * _constant("flash_attn", "kMaxNd")


@pytest.mark.parametrize("d,want", [
    (8, "run-time D"), (40, "run-time D"), (56, "run-time D"),
    (57, "D = 64"), (64, "D = 64"), (65, "run-time D"), (70, "run-time D"),
    (72, "run-time D"), (120, "run-time D"), (121, "D = 128"),
    (128, "D = 128")])
def test_flash_instance(d, want):
    """Head sizes 57..64 take the D = 64 instance and 121..128 the D =
    128 one where the copies are 16-byte; every other head size, and any
    view that takes 4-byte copies, the run-time-D instance."""
    assert fa_ops.instance(d) == want
    assert fa_ops.instance(d, aligned=False) == "run-time D"
