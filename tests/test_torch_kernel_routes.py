"""The kernels' pure routing functions, on the CPU.

`repro_torch.kernels.round_grad.ops.route` says which launch a round
gradient of D columns takes on the card (the row-resident instances, one
launch over thread-block clusters along D, or the residual pass and the
column-chunked launch), and `repro_torch.kernels.flash_attn.ops.instance`
which compiled instance of kernel 8 a head size and a sequence length
take, and the kernel-8 wrapper records the instance its library reports
launching.  Both are pure
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
    assert fa_ops.SHORT_MAX_S == _constant("flash_attn", "kShortMaxS")


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


@pytest.mark.parametrize("d,s,want", [
    (128, 1, "short, D = 128, 32 keys"),
    (128, 15, "short, D = 128, 32 keys"),
    (128, 32, "short, D = 128, 32 keys"),
    (124, 32, "short, D = 128, 32 keys"),
    (128, 33, "short, D = 128, 64 keys"),
    (128, 64, "short, D = 128, 64 keys"),
    (128, 65, "D = 128"), (128, 2048, "D = 128"),
    (64, 16, "short, D = 64, 32 keys"),
    (60, 63, "short, D = 64, 64 keys"),
    (64, 100, "D = 64"), (72, 32, "run-time D"),
    (40, 1, "run-time D"), (8, 64, "run-time D")])
def test_flash_short_instance(d, s, want):
    """At S <= 64 the head sizes of the two compile-time instances take
    the short ones (32 keys up to S = 32, else 64); a longer S the D = 128
    / D = 64 instance; any view that takes 4-byte copies the run-time-D
    one; every other head size the run-time-D one whatever S."""
    assert fa_ops.instance(d, s=s) == want
    assert fa_ops.instance(d, aligned=False, s=s) == "run-time D"
    if s > fa_ops.SHORT_MAX_S:
        assert fa_ops.instance(d, s=s) == fa_ops.instance(d)


@pytest.mark.parametrize("code", [0, 3, 6])
def test_flash_counter_records_the_instance_the_library_reports(
        monkeypatch, code):
    """The wrapper records, by its code, the instance `flash_attn_launch`
    writes to its last argument (a stub library here, the kernel route
    forced for CPU tensors), whatever the operands' shape; a failed
    launch records nothing."""
    from unittest import mock

    def launch(*args):
        args[-1]._obj.value = code
        return status

    lib = mock.MagicMock()
    lib.flash_attn_launch.side_effect = launch
    monkeypatch.setattr(fa_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(fa_ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))
    q, k, v = (torch.zeros((1, h, 10, 8)) for h in (4, 2, 2))
    before = dict(fa_ops.FLASH_COUNTER.tiles)
    status = 0
    fa_ops.causal_attention(q, k, v)
    status = 700  # a CUDA error code
    with pytest.raises(RuntimeError, match="launch failed"):
        fa_ops.causal_attention(q, k, v)
    after = dict(fa_ops.FLASH_COUNTER.tiles)
    assert after.pop((code,)) == before.pop((code,), 0) + 1
    assert after == before


def test_flash_instance_names_mirror_the_source():
    """INSTANCES in the order of the library's codes: the dispatch of
    `flash_attn_launch` launches codes 3 to 6 as the short instances of
    D = 128 and D = 64 at 4 and 8 score n-tiles (32 and 64 keys)."""
    text = (build.CSRC / "flash_attn.cu").read_text()
    launched = {code: (nd, int(kt)) for code, nd, kt in re.findall(
        r"inst == (\d)\)\s+e = launch_short<(k\w+), (\d)>", text)}
    assert launched == {"3": ("kMaxNd", 4), "4": ("kMaxNd", 8),
                        "5": ("kNarrowNd", 4), "6": ("kNarrowNd", 8)}
    for code, (nd, kt) in launched.items():
        assert fa_ops.INSTANCES[int(code)] == (
            f"short, D = {128 if nd == 'kMaxNd' else 64}, {8 * kt} keys")
