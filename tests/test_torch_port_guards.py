"""Structural guarantees of the port: it never imports JAX or `repro`, its
entry points default to the CUDA device and raise without one, and a
kernel wrapper handed a CUDA tensor launches its kernel or raises — it
never falls back to the plain version.  No CUDA call is made here: the
dispatch seam is exercised with a stubbed library loader.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import api, device
from repro_torch.core.redundancy import solve_redundancy
from repro_torch.fleet import FleetTopology, HierarchicalCFL
from repro_torch.kernels import build, common
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.round_grad import ops as rg_ops
from repro_torch.kernels.round_grad import ref as rg_ref
from repro_torch.plan import PlanRequest, solve_redundancy_batched
from repro_torch.schemes import StochasticCodedFL
from repro_torch.sim.network import paper_fleet

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_importing_the_port_loads_no_jax():
    """Import every module of the port in a fresh interpreter; neither
    `jax` nor any module of `repro` may end up loaded."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(sum(k.startswith('repro_torch') for k in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25  # every module was imported


def test_no_source_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 25
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not set(roots) & {"jax", "jaxlib", "repro"}, \
                f"{path}:{node.lineno} imports {roots}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    fleet = paper_fleet(seed=0, n=4, d=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Session(api.UncodedFL(), fleet, lr=0.1, epochs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.TrainData.linreg(0, 4, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_redundancy(fleet.edge, fleet.server, np.full(4, 8), fixed_c=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_redundancy_batched([PlanRequest(
            fleet.edge, fleet.server, np.full(4, 8), fixed_c=4,
            srv_weight=0.64)])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Session(StochasticCodedFL(key=0, sample_frac=0.8), fleet,
                    lr=0.1, epochs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Session(HierarchicalCFL(api.UncodedFL(),
                                    FleetTopology.uniform(4, 2)), fleet,
                    lr=0.1, epochs=2)
    # the CPU is used only when asked for
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert api.Session(api.UncodedFL(), fleet, lr=0.1, epochs=2,
                       device="cpu").device == torch.device("cpu")
    assert common.backend() == "cpu"


def test_session_rejects_data_on_another_device():
    fleet = paper_fleet(seed=0, n=4, d=8)
    data = api.TrainData.linreg(0, 4, 8, 8, device="cpu")
    sess = api.Session(api.UncodedFL(), fleet, lr=0.1, epochs=2,
                       device="meta")
    with pytest.raises(ValueError, match="session runs on"):
        sess.run(data)


OPS = [(rg_ops, "round_grad"), (enc_ops, "encode")]


@pytest.mark.parametrize("ops,name", OPS)
def test_dispatch_cuda_takes_the_kernel(monkeypatch, ops, name):
    lib = mock.MagicMock()
    loaded = []
    monkeypatch.setattr(build, "load",
                        lambda n, signatures: loaded.append(n) or lib)
    assert ops._dispatch(torch.device("cuda")) is lib
    assert ops._dispatch(torch.device("cuda", 0)) is lib
    assert loaded == [name, name]
    assert ops._dispatch(torch.device("cpu")) is None


@pytest.mark.parametrize("ops,name", OPS)
def test_dispatch_raises_when_the_build_fails(monkeypatch, tmp_path, ops,
                                              name):
    """A CUDA tensor whose kernel cannot be built raises BuildFailure —
    there is no `try` that falls back to the plain version."""
    def no_nvcc():
        raise build.BuildFailure("nvcc not found")

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "library_path",
                        lambda n: tmp_path / f"lib{n}.so")
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    with pytest.raises(build.BuildFailure):
        ops._dispatch(torch.device("cuda"))
    with pytest.raises(ValueError):
        ops._dispatch(torch.device("meta"))


def _rg_operands(m=20, d=6):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((m, d), generator=g), torch.randn((m,), generator=g),
            torch.rand((m,), generator=g), torch.randn((d,), generator=g))


# each round-gradient wrapper: (call on (x, y, w, beta), its C entry point,
# its launch counter)
RG_WRAPPERS = {
    "masked": (lambda x, y, w, b: rg_ops.masked_round_gradient(x, y, w, b),
               "rg_masked_round_gradient", "COUNTER"),
    "coded": (lambda x, y, w, b: rg_ops.coded_round_gradient(
        x, y, w, x[:5], y[:5], 0.5, b),
        "rg_coded_round_gradient", "CODED_COUNTER"),
    "tier": (lambda x, y, w, b: rg_ops.tier_masked_round_gradient(
        x, y, w, torch.ones((3, x.shape[0])), b),
        "rg_tier_round_gradient", "TIER_COUNTER"),
}
RG_COUNTERS = ("COUNTER", "CODED_COUNTER", "TIER_COUNTER")


@pytest.mark.parametrize("name", sorted(RG_WRAPPERS))
def test_kernel_route_never_computes_the_plain_version(monkeypatch, name):
    """Where `_dispatch` hands back a library (a CUDA tensor), each wrapper
    calls its own C entry point once, bumps only its own counter and
    never reaches a plain version; a failed launch raises and does not
    count."""
    call, entry, counter = RG_WRAPPERS[name]
    lib = mock.MagicMock()
    lib.rg_max_d.return_value = 5810
    lib.rg_num_ctas.side_effect = lambda m: -(-m // 16)
    getattr(lib, entry).return_value = 0
    monkeypatch.setattr(rg_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(rg_ops, "_stream", lambda device: 0)

    def plain(*args):
        raise AssertionError("the plain version ran on the kernel route")

    for fn in ("masked_round_gradient", "coded_round_gradient",
               "tier_masked_round_gradient"):
        monkeypatch.setattr(rg_ref, fn, plain)
    before = {k: getattr(rg_ops, k).launches for k in RG_COUNTERS}
    call(*_rg_operands())
    assert getattr(lib, entry).call_count == 1
    bumped = {k for k in RG_COUNTERS
              if getattr(rg_ops, k).launches != before[k]}
    assert bumped == {counter}
    assert getattr(rg_ops, counter).launches == before[counter] + 1
    getattr(lib, entry).return_value = 700  # a CUDA error code
    with pytest.raises(RuntimeError, match="launch failed"):
        call(*_rg_operands())
    assert getattr(rg_ops, counter).launches == before[counter] + 1


@pytest.mark.parametrize("name", sorted(RG_WRAPPERS))
def test_wrappers_raise_on_other_devices(name):
    """A tensor on neither the CPU nor a CUDA device raises: no wrapper
    computes a plain version for it."""
    call = RG_WRAPPERS[name][0]
    with pytest.raises(ValueError, match="no round_grad kernel"):
        call(*(t.to("meta") for t in _rg_operands()))


def test_library_path_tracks_source_and_flags(monkeypatch):
    base = build.library_path("round_grad")
    assert base.parent == build.BUILD_DIR
    assert base.name.startswith("libround_grad-") and base.suffix == ".so"
    assert build.library_path("round_grad") == base
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("round_grad") != base
    for name in build.SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        assert "sm_90a" in text and "pallas_call" in text


@pytest.mark.parametrize("ops,name", OPS)
def test_load_declares_signatures_once(monkeypatch, tmp_path, ops, name):
    """The first `load` opens the library and declares every C signature
    of the wrapper's table (and the shared error string); a later call
    returns the same handle without reopening it."""
    opened = []

    def fake_cdll(path):
        opened.append(path)
        return mock.MagicMock()

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "library_path",
                        lambda n: tmp_path / f"lib{n}.so")
    (tmp_path / f"lib{name}.so").touch()
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    lib = ops._dispatch(torch.device("cuda"))
    for fn_name, (argtypes, restype) in {**build._COMMON,
                                         **ops._SIGNATURES}.items():
        fn = getattr(lib, fn_name)
        assert fn.argtypes == argtypes and fn.restype is restype
    assert ops._dispatch(torch.device("cuda")) is lib
    assert opened == [str(tmp_path / f"lib{name}.so")]


def test_library_path_tracks_shared_header(monkeypatch, tmp_path):
    """An edit to a shared header renames every library, so it rebuilds."""
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.SOURCES}
    with open(tmp_path / "kernel_api.cuh", "a") as f:
        f.write("// edited\n")
    for name in build.SOURCES:
        assert build.library_path(name) != before[name]


def test_resolve_block_and_counter():
    assert common.resolve_block("round_grad", (8, 8), "auto", 32) == 32
    assert common.resolve_block("round_grad", (8, 8), 16, 32) == 16
    counter = common.LaunchCounter(launches=3)
    counter.reset()
    assert counter.launches == 0
