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
from repro_torch.fleet import encode_fleet_tiered, solve_fleet
from repro_torch.kernels import build, common
from repro_torch.kernels.coded_grad import ops as cg_ops
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import ref as enc_ref
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn import ref as fa_ref
from repro_torch.kernels.round_grad import ops as rg_ops
from repro_torch.kernels.round_grad import ref as rg_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.plan import PlanRequest, solve_redundancy_batched
from repro_torch.schemes import CodedFedL, StochasticCodedFL
from repro_torch.sim.network import mega_fleet, paper_fleet

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
    big = mega_fleet(64, d=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_fleet(PlanRequest(big.edge, big.server, np.full(64, 4),
                                c_up=16))
    # the CPU is used only when asked for
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert api.Session(api.UncodedFL(), fleet, lr=0.1, epochs=2,
                       device="cpu").device == torch.device("cpu")
    assert common.backend() == "cpu"


def test_sweep_and_fedserve_entry_points_default_to_cuda(no_cuda):
    """`run_sweep`'s sessions, `FedServeEngine` and the fedserve command
    line ask for the card unless told otherwise, and raise without one;
    a sweep or an engine refuses data on another device."""
    from repro_torch.launch import fedserve
    from repro_torch.serving import FedServeEngine

    data = api.TrainData.linreg(0, 4, 8, 8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        FedServeEngine(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedserve.main(["--sessions", "2"])
    assert FedServeEngine(data, device="cpu").device == torch.device("cpu")
    fleet = paper_fleet(seed=0, n=4, d=8)
    meta = api.Session(api.UncodedFL(), fleet, lr=0.1, epochs=2,
                       device="meta")
    with pytest.raises(ValueError, match="session runs on"):
        api.run_sweep([meta], data)
    with pytest.raises(ValueError, match="session runs on"):
        FedServeEngine(data, device="cpu").submit(meta)


def test_session_rejects_data_on_another_device():
    fleet = paper_fleet(seed=0, n=4, d=8)
    data = api.TrainData.linreg(0, 4, 8, 8, device="cpu")
    sess = api.Session(api.UncodedFL(), fleet, lr=0.1, epochs=2,
                       device="meta")
    with pytest.raises(ValueError, match="session runs on"):
        sess.run(data)


@pytest.mark.parametrize("scheme,tiers", [("coded", 0), ("coded", 3),
                                          ("scfl", 0), ("scfl", 3),
                                          ("cfedl", 0), ("cfedl", 3)])
def test_reference_path_reaches_no_kernel_wrapper(monkeypatch, scheme,
                                                  tiers):
    """`grad_path="reference"` is the plain two-pass oracle the fused path
    is held against: its epochs call no round-gradient wrapper, the
    parity gradient's included, so on the card they launch nothing."""
    fleet = paper_fleet(seed=0, n=6, d=8)
    data = api.TrainData.linreg(0, 6, 16, 8, device="cpu")
    if scheme == "coded":
        strategy = api.CodedFL(key=1, fixed_c=24, include_upload_delay=False,
                               grad_path="reference")
    elif scheme == "scfl":
        strategy = StochasticCodedFL(key=1, fixed_c=24, sample_frac=0.5,
                                     include_upload_delay=False,
                                     grad_path="reference")
    else:
        strategy = CodedFedL(key=1, d_feat=8, fixed_c=24,
                             include_upload_delay=False,
                             grad_path="reference")
    if tiers:
        strategy = HierarchicalCFL(strategy, FleetTopology.uniform(6, tiers))
    sess = api.Session(strategy, fleet, lr=0.1, epochs=3, device="cpu")
    state = sess.plan(data)  # the one-time encode may take its kernel

    def wrapper(*args, **kwargs):
        raise AssertionError("the reference path called a kernel wrapper")

    for fn in ("masked_round_gradient", "coded_round_gradient",
               "tier_masked_round_gradient", "lsq_gradient"):
        monkeypatch.setattr(rg_ops, fn, wrapper)
    rep = sess.run(data, rng=np.random.default_rng(0), state=state)
    assert rep.nmse.shape == (4,) and np.all(np.isfinite(rep.nmse))


OPS = [(rg_ops, "round_grad"), (enc_ops, "encode"), (ssd_ops, "ssd"),
       (fa_ops, "flash_attn")]


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
    "lsq": (lambda x, y, w, b: rg_ops.lsq_gradient(x, y, b),
            "rg_lsq_gradient", "LSQ_COUNTER"),
}
RG_COUNTERS = ("COUNTER", "CODED_COUNTER", "TIER_COUNTER", "LSQ_COUNTER")


@pytest.mark.parametrize("name", sorted(RG_WRAPPERS))
def test_kernel_route_never_computes_the_plain_version(monkeypatch, name):
    """Where `_dispatch` hands back a library (a CUDA tensor), each wrapper
    calls its own C entry point once, bumps only its own counter and
    never reaches a plain version; a failed launch raises and does not
    count."""
    call, entry, counter = RG_WRAPPERS[name]
    lib = mock.MagicMock()
    lib.rg_residual_rows.return_value = 0
    lib.rg_num_ctas.side_effect = lambda m: -(-m // 16)
    getattr(lib, entry).return_value = 0
    monkeypatch.setattr(rg_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(rg_ops, "_stream", lambda device: 0)

    def plain(*args):
        raise AssertionError("the plain version ran on the kernel route")

    for fn in ("masked_round_gradient", "coded_round_gradient",
               "tier_masked_round_gradient", "lsq_gradient"):
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


@pytest.fixture
def tile_cache(tmp_path, monkeypatch):
    """The port's user tile cache in a fresh directory."""
    from repro_torch.tune import cache as tune_cache

    monkeypatch.setenv(tune_cache.CACHE_ENV, str(tmp_path))
    return tune_cache.TileCache(tune_cache.user_cache_path())


def test_resolve_block_reads_the_cache(tile_cache):
    """"auto" returns a stored tile for the operands' backend (an int for
    a 1-d family), and the default on a cold miss."""
    assert common.resolve_block("coded_grad", (96, 12), "auto", 0) == 0
    tile_cache.store("coded_grad", (96, 12), "cpu", (32,))
    tile_cache.store("encode", (64, 48, 32), "cpu", (64, 64, 32))
    assert common.resolve_block("coded_grad", (96, 12), "auto", 0) == 32
    assert common.resolve_block("coded_grad", (100, 9), "auto", 0,
                                "cpu") == 32  # the same bucket
    assert common.resolve_block("encode", (64, 48, 32), "auto",
                                (128, 64, 32)) == (64, 64, 32)
    assert common.resolve_block("encode", (64, 48, 32), (64, 32, 32),
                                (128, 64, 32)) == (64, 32, 32)
    assert common.resolve_block("round_grad", (96, 12), "auto", 0) == 0
    tile_cache.store("round_grad", (5632, 500), "cuda-sm90", (48,))
    assert common.resolve_block("round_grad", (5632, 500), "auto", 0,
                                "cpu") == 0  # another backend's entry


def test_resolve_block_is_memoized_until_a_store(tile_cache, monkeypatch,
                                                tmp_path):
    """"auto" is looked up once per (family, shape, device, user cache
    directory): a wrapper resolves on every launch.  A store clears the
    memo; a file changed by other means is read after
    `forget_resolved()`."""
    import json

    from repro_torch.tune import cache as tune_cache

    calls = []
    lookup = tune_cache.lookup_block
    monkeypatch.setattr(tune_cache, "lookup_block",
                        lambda *a: calls.append(a) or lookup(*a))
    for _ in range(3):
        assert common.resolve_block("coded_grad", (96, 12), "auto", 0,
                                    "cpu") == 0
    assert len(calls) == 1
    tile_cache.store("coded_grad", (96, 12), "cpu", (32,))
    for _ in range(2):
        assert common.resolve_block("coded_grad", (96, 12), "auto", 0,
                                    "cpu") == 32
    assert len(calls) == 2
    payload = json.load(open(tile_cache.path))
    payload["entries"]["coded_grad|cpu|128x16"]["block"] = [40]
    with open(tile_cache.path, "w") as f:
        json.dump(payload, f)
    assert common.resolve_block("coded_grad", (96, 12), "auto", 0,
                                "cpu") == 32
    tune_cache.forget_resolved()
    assert common.resolve_block("coded_grad", (96, 12), "auto", 0,
                                "cpu") == 40
    monkeypatch.setenv(tune_cache.CACHE_ENV, str(tmp_path / "other"))
    assert common.resolve_block("coded_grad", (96, 12), "auto", 0,
                                "cpu") == 0
    assert len(calls) == 4


@pytest.mark.parametrize("package", ["tune", "roofline"])
def test_tune_and_roofline_import_no_jax_or_repro(package):
    files = sorted((PORT / package).rglob("*.py"))
    assert len(files) >= 2
    module = "tuner" if package == "tune" else "analysis"
    code = (f"import sys, repro_torch.{package}.{module}"
            "\nbad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
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


def test_tune_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda, tile_cache, monkeypatch):
    """`python -m repro_torch.tune` and `tune.autotune` run on the card by
    default and raise without one; `--device cpu` tunes the CPU backend
    (its one candidate, timed here by an injected measure)."""
    from repro_torch import tune
    from repro_torch.tune import __main__ as cli
    from repro_torch.tune import tuner

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--family", "round_grad", "--shape", "5632x500"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tune.autotune("round_grad", (5632, 500))
    with pytest.raises(RuntimeError, match="CUDA"):
        tune.autotune("round_grad", (5632, 500), store=False,
                      terms_fn=lambda b: {"t_compute": 1.0, "t_memory": 1.0},
                      measure_fn=lambda b: 1.0)
    assert tile_cache.lookup("round_grad", (5632, 500), "cpu") is None
    monkeypatch.setattr(tuner, "measure", lambda fn, args, iters: 3.0)
    assert cli.main(["--family", "coded_grad", "--shape", "64x8",
                     "--device", "cpu"]) == 0
    ent = tile_cache.lookup("coded_grad", (64, 8), "cpu")
    assert ent["block"] == [0] and ent["us"] == 3.0 and ent["device"] == "cpu"


def test_row_tile_reaches_the_launch(monkeypatch, tile_cache):
    """On the kernel route the row tile goes to the C entry point (0 for
    the kernel's own partition) and sizes the float64 partials; "auto"
    reads the cache; a tile that is not a multiple of 8 is refused."""
    lib = mock.MagicMock()
    lib.rg_residual_rows.return_value = 0
    lib.rg_num_ctas.side_effect = lambda m: -(-m // 16)
    lib.rg_masked_round_gradient.return_value = 0
    lib.rg_coded_round_gradient.return_value = 0
    monkeypatch.setattr(rg_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(rg_ops, "_stream", lambda device: 0)
    shapes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        shapes.append(tuple(shape[0]) if isinstance(shape[0], tuple)
                      else shape)
        return real_empty(*shape, **kw)

    monkeypatch.setattr(rg_ops.torch, "empty", empty)
    x, y, w, b = _rg_operands()  # m = 20, d = 6
    rg_ops.COUNTER.reset()
    rg_ops.masked_round_gradient(x, y, w, b)
    rg_ops.masked_round_gradient(x, y, w, b, block_m=8)
    tile_cache.store("round_grad", (20, 6), "cpu", (16,))
    rg_ops.masked_round_gradient(x, y, w, b)
    tiles = [c.args[9] for c in lib.rg_masked_round_gradient.call_args_list]
    assert tiles == [0, 8, 16]
    assert [s for s in shapes if len(s) == 2] == [(2, 6), (3, 6), (2, 6)]
    assert rg_ops.COUNTER.tiles == {(0,): 1, (8,): 1, (16,): 1}
    rg_ops.coded_round_gradient(x, y, w, x[:5], y[:5], 0.5, b, block_m=8)
    assert lib.rg_coded_round_gradient.call_args.args[13] == 8
    assert shapes[-1] == (3 + 1, 6)
    with pytest.raises(ValueError, match="multiple of 8"):
        rg_ops.masked_round_gradient(x, y, w, b, block_m=12)


def test_encode_tile_reaches_the_launch(monkeypatch, tile_cache):
    lib = mock.MagicMock()
    lib.enc_encode_parity.return_value = 0
    monkeypatch.setattr(enc_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(enc_ops, "check_cuda_operand", lambda *a: None)
    monkeypatch.setattr(enc_ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))
    g, w, x = torch.ones(6, 5), torch.ones(5), torch.ones(5, 4)
    enc_ops.COUNTER.reset()
    enc_ops.encode_parity(g, w, x)
    enc_ops.encode_parity(g, w, x, block=(64, 128, 32))
    tile_cache.store("encode", (6, 5, 4), "cpu", (128, 32, 32))
    enc_ops.encode_parity(g, w, x)
    assert [c.args[7:10] for c in lib.enc_encode_parity.call_args_list] == \
        [(128, 64, 32), (64, 128, 32), (128, 32, 32)]
    assert enc_ops.COUNTER.tiles == {(128, 64, 32): 1, (64, 128, 32): 1,
                                     (128, 32, 32): 1}
    with pytest.raises(ValueError, match="no tile"):
        enc_ops.encode_parity(g, w, x, block=(32, 32, 32))


def _key():
    return np.array([0, 42], dtype=np.uint32)


def _enc_operands(n=3, ell=5, d=4):
    g = torch.Generator().manual_seed(1)
    return (torch.randn((n, ell, d), generator=g),
            torch.randn((n, ell), generator=g),
            torch.rand((n, ell), generator=g))


# each in-kernel-generator encode wrapper: (call, expected launches)
PRNG_WRAPPERS = {
    "single": (lambda xs, ys, w: enc_ops.encode_parity_prng(
        _key(), w[0].contiguous(), xs[0].contiguous(), 6), 1),
    "fleet": (lambda xs, ys, w: enc_ops.encode_fleet_prng(
        _key(), xs, ys, w, 6, kind="bernoulli"), 3),
    "tiered": (lambda xs, ys, w: encode_fleet_tiered(
        _key(), xs, ys, w, 6, FleetTopology.uniform(3, 2)), 3),
}


@pytest.mark.parametrize("name", sorted(PRNG_WRAPPERS))
def test_prng_encode_route_never_computes_the_plain_version(monkeypatch,
                                                            name):
    """On the kernel route the in-kernel-generator encoders launch once
    per client through `enc_encode_parity_prng`, bump only
    `PRNG_COUNTER`, never reach a plain version, and raise (without
    counting) on a failed launch."""
    call, launches = PRNG_WRAPPERS[name]
    lib = mock.MagicMock()
    lib.enc_encode_parity_prng.return_value = 0
    monkeypatch.setattr(enc_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(enc_ops, "check_cuda_operand", lambda *a: None)
    monkeypatch.setattr(enc_ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))

    def plain(*args, **kw):
        raise AssertionError("the plain version ran on the kernel route")

    for fn in ("encode_parity", "encode_parity_prng"):
        monkeypatch.setattr(enc_ref, fn, plain)
    before = (enc_ops.COUNTER.launches, enc_ops.PRNG_COUNTER.launches)
    call(*_enc_operands())
    assert lib.enc_encode_parity_prng.call_count == launches
    assert (enc_ops.COUNTER.launches, enc_ops.PRNG_COUNTER.launches) == \
        (before[0], before[1] + launches)
    if name == "single":  # the key words go by value
        assert lib.enc_encode_parity_prng.call_args.args[:2] == (0, 42)
    lib.enc_encode_parity_prng.return_value = 700  # a CUDA error code
    with pytest.raises(RuntimeError, match="launch failed"):
        call(*_enc_operands())
    assert enc_ops.PRNG_COUNTER.launches == before[1] + launches


def test_prng_fleet_launches_accumulate_in_client_order(monkeypatch):
    """The fleet encoder's launches add into one (c, d+1) composite, in
    client order, with the keys of `split_keys`."""
    from repro_torch.kernels.encode import prng
    lib = mock.MagicMock()
    lib.enc_encode_parity_prng.return_value = 0
    monkeypatch.setattr(enc_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(enc_ops, "check_cuda_operand", lambda *a: None)
    monkeypatch.setattr(enc_ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))
    xs, ys, w = _enc_operands()
    enc_ops.encode_fleet_prng(_key(), xs, ys, w, 6)
    keys = prng.split_keys(_key(), 3)
    calls = lib.enc_encode_parity_prng.call_args_list
    assert [c.args[:2] for c in calls] == [tuple(int(v) for v in k)
                                          for k in keys]
    outs = {c.args[4] for c in calls}
    assert len(outs) == 1  # one accumulator
    # (c, ell, d + 1, kind normal, accumulate)
    assert {c.args[5:10] for c in calls} == {(6, 5, 5, 0, 1)}


def test_lsq_route_never_computes_the_plain_version(monkeypatch):
    lib = mock.MagicMock()
    lib.rg_residual_rows.return_value = 0
    lib.rg_num_ctas.side_effect = lambda m: -(-m // 16)
    lib.rg_lsq_gradient.return_value = 0
    assert cg_ops.COUNTER is rg_ops.LSQ_COUNTER
    monkeypatch.setattr(rg_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(rg_ops, "_stream", lambda device: 0)

    def plain(*args):
        raise AssertionError("the plain version ran on the kernel route")

    monkeypatch.setattr(rg_ref, "lsq_gradient", plain)
    monkeypatch.setattr(rg_ref, "masked_round_gradient", plain)
    x, y, _, b = _rg_operands()
    before = (cg_ops.COUNTER.launches, rg_ops.COUNTER.launches)
    cg_ops.lsq_gradient(x, y, b)
    assert lib.rg_lsq_gradient.call_count == 1
    assert (cg_ops.COUNTER.launches, rg_ops.COUNTER.launches) == \
        (before[0] + 1, before[1])
    lib.rg_lsq_gradient.return_value = 700
    with pytest.raises(RuntimeError, match="launch failed"):
        cg_ops.lsq_gradient(x, y, b)
    assert cg_ops.COUNTER.launches == before[0] + 1


def test_new_wrappers_raise_on_other_devices():
    xs, ys, w = (t.to("meta") for t in _enc_operands())
    with pytest.raises(ValueError, match="no encode kernel"):
        enc_ops.encode_parity_prng(_key(), w[0], xs[0], 4)
    x, y, _, b = (t.to("meta") for t in _rg_operands())
    with pytest.raises(ValueError, match="no round_grad kernel"):
        cg_ops.lsq_gradient(x, y, b)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "granite-8b",
                                  "codeqwen1.5-7b", "minitron-4b",
                                  "mistral-large-123b", "zamba2-1.2b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b"])
def test_serve_entry_points_default_to_cuda_and_raise_without_it(no_cuda,
                                                                 arch):
    """The LM serve paths: parameters, cache, prefill step, the engine,
    `greedy_generate` and the serve command line ask for the card unless told
    otherwise, and raise without one."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServeEngine

    cfg = get_config(arch).reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(cfg, 2, 16)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, n_slots=2, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.greedy_generate(cfg, params, torch.zeros((1, 4), dtype=int),
                              2, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", arch])
    # the CPU is used only when asked for, and the parameters must be there
    assert ServeEngine(cfg, params, n_slots=2, max_seq=16,
                       device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="parameters are on"):
        ServeEngine(cfg, params, n_slots=2, max_seq=16, device="meta")


def _ssd_operands(B=1, nc=2, Q=8, H=4, P=4, G=2, N=4):
    g = torch.Generator().manual_seed(2)
    return (torch.randn((B, nc, Q, H, P), generator=g),
            torch.rand((B, nc, Q, H), generator=g),
            -torch.rand((B, nc, Q, H), generator=g),
            torch.randn((B, nc, Q, G, N), generator=g),
            torch.randn((B, nc, Q, G, N), generator=g))


def test_ssd_route_never_computes_the_plain_version(monkeypatch):
    """On the kernel route `ssd_chunk` calls `ssd_chunk_launch` once with
    the operands' extents, per-group B and C as given, bumps only
    `SSD_COUNTER`, never reaches the plain version, and raises (without
    counting) on a failed launch."""
    lib = mock.MagicMock()
    lib.ssd_chunk_launch.return_value = 0
    monkeypatch.setattr(ssd_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(ssd_ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))

    def plain(*args):
        raise AssertionError("the plain version ran on the kernel route")

    monkeypatch.setattr(ssd_ref, "ssd_chunk_reference", plain)
    others = (rg_ops.COUNTER, rg_ops.CODED_COUNTER, rg_ops.TIER_COUNTER,
              rg_ops.LSQ_COUNTER, enc_ops.COUNTER, enc_ops.PRNG_COUNTER)
    before = [c.launches for c in others]
    n = ssd_ops.SSD_COUNTER.launches
    y, states = ssd_ops.ssd_chunk(*_ssd_operands())
    assert tuple(y.shape) == (1, 2, 8, 4, 4)
    assert tuple(states.shape) == (1, 2, 4, 4, 4)
    assert lib.ssd_chunk_launch.call_count == 1
    assert lib.ssd_chunk_launch.call_args.args[7:14] == (1, 2, 8, 4, 4, 2, 4)
    assert ssd_ops.SSD_COUNTER.launches == n + 1
    assert [c.launches for c in others] == before
    lib.ssd_chunk_launch.return_value = 700  # a CUDA error code
    with pytest.raises(RuntimeError, match="launch failed"):
        ssd_ops.ssd_chunk(*_ssd_operands())
    assert ssd_ops.SSD_COUNTER.launches == n + 1
    ops = list(_ssd_operands())
    ops[2] = ops[2].double()
    with pytest.raises(TypeError, match="da must be float32"):
        ssd_ops.ssd_chunk(*ops)


def test_ssd_wrapper_raises_on_other_devices():
    with pytest.raises(ValueError, match="no ssd kernel"):
        ssd_ops.ssd_chunk(*(t.to("meta") for t in _ssd_operands()))


def _fa_operands(B=1, Hq=4, Hkv=2, S=10, D=8):
    g = torch.Generator().manual_seed(3)
    return tuple(torch.randn((B, h, S, D), generator=g)
                 for h in (Hq, Hkv, Hkv))


def test_flash_route_never_computes_the_plain_version(monkeypatch):
    """On the kernel route `causal_attention` calls `flash_attn_launch`
    once with the operands' extents and strides and the float32 scale,
    bumps only `FLASH_COUNTER`, never reaches the plain version, and
    raises (without counting) on a failed launch."""
    lib = mock.MagicMock()
    lib.flash_attn_launch.return_value = 0
    monkeypatch.setattr(fa_ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(fa_ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))

    def plain(*args):
        raise AssertionError("the plain version ran on the kernel route")

    monkeypatch.setattr(fa_ref, "causal_attention", plain)
    others = (rg_ops.COUNTER, rg_ops.CODED_COUNTER, rg_ops.TIER_COUNTER,
              rg_ops.LSQ_COUNTER, enc_ops.COUNTER, enc_ops.PRNG_COUNTER,
              ssd_ops.SSD_COUNTER)
    before = [c.launches for c in others]
    n = fa_ops.FLASH_COUNTER.launches
    out = fa_ops.causal_attention(*_fa_operands())
    assert tuple(out.shape) == (1, 4, 10, 8)
    assert lib.flash_attn_launch.call_count == 1
    args = lib.flash_attn_launch.call_args.args
    assert args[4:9] == (1, 4, 2, 10, 8)
    assert args[9:21] == (320, 80, 8, 160, 80, 8, 160, 80, 8, 320, 80, 8)
    assert args[21] == fa_ops.scale(8)
    assert fa_ops.FLASH_COUNTER.launches == n + 1
    assert [c.launches for c in others] == before
    lib.flash_attn_launch.return_value = 700  # a CUDA error code
    with pytest.raises(RuntimeError, match="launch failed"):
        fa_ops.causal_attention(*_fa_operands())
    assert fa_ops.FLASH_COUNTER.launches == n + 1
    # a last dimension that is not contiguous is copied once, the rest not
    q, k, v = _fa_operands()
    lib.flash_attn_launch.return_value = 0
    fa_ops.causal_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v)
    assert lib.flash_attn_launch.call_args.args[9:12] == (320, 80, 8)


def test_flash_wrapper_raises_on_other_devices():
    with pytest.raises(ValueError, match="no flash_attn kernel"):
        fa_ops.causal_attention(*(t.to("meta") for t in _fa_operands()))


def test_no_source_file_imports_msgpack():
    """Checkpoints carry their own MessagePack codec: the card's machine
    has no `msgpack` package."""
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert "msgpack" not in roots, f"{path}:{node.lineno}"


def test_train_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    """The training command line, `fed_train` and the token stream ask for
    the card unless told otherwise, and raise without one."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.fed import FedConfig, fed_setup, fed_train
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--federated", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        token_batches(0, 2, 8, 16)
    cfg = get_config("granite-8b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    state = fed_setup(paper_fleet(seed=0, n=2, d=8).edge, FedConfig(2, 1, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        fed_train(state, steps.make_fed_grad_fn(cfg), params, adamw(1e-3),
                  iter([]), 1)
    # the CPU is used only when asked for
    it = token_batches(0, 2, 8, 16, device="cpu")
    assert next(it)["tokens"].device == torch.device("cpu")


def _grad_operands(ops):
    return [t.clone().requires_grad_() if t.is_floating_point() else t
            for t in ops]


# each kernel wrapper: (module, C entry point, call on operands, operands)
GRAD_WRAPPERS = {
    "masked": (rg_ops, "rg_masked_round_gradient",
               RG_WRAPPERS["masked"][0], _rg_operands),
    "coded": (rg_ops, "rg_coded_round_gradient", RG_WRAPPERS["coded"][0],
              _rg_operands),
    "tier": (rg_ops, "rg_tier_round_gradient", RG_WRAPPERS["tier"][0],
             _rg_operands),
    "lsq": (rg_ops, "rg_lsq_gradient", RG_WRAPPERS["lsq"][0], _rg_operands),
    "encode": (enc_ops, "enc_encode_parity",
               lambda xs, ys, w: enc_ops.encode_parity(
                   ys.contiguous(), w[0].contiguous(),
                   xs[0].contiguous()), _enc_operands),
    "encode_prng": (enc_ops, "enc_encode_parity_prng",
                    PRNG_WRAPPERS["single"][0], _enc_operands),
    "encode_prng_fleet": (enc_ops, "enc_encode_parity_prng",
                          PRNG_WRAPPERS["fleet"][0], _enc_operands),
    "ssd": (ssd_ops, "ssd_chunk_launch", ssd_ops.ssd_chunk, _ssd_operands),
    "flash": (fa_ops, "flash_attn_launch", fa_ops.causal_attention,
              _fa_operands),
}


@pytest.mark.parametrize("name", sorted(GRAD_WRAPPERS))
def test_kernel_route_refuses_operands_that_require_grad(monkeypatch, name):
    """The kernels have no backward: on the kernel route a call whose
    operand requires grad raises before any launch, naming the missing
    backward, and counts nothing; under `torch.no_grad()` the same call
    launches.  On the CPU the plain version stays differentiable."""
    ops, entry, call, operands = GRAD_WRAPPERS[name]
    lib = mock.MagicMock()
    lib.rg_residual_rows.return_value = 0
    lib.rg_num_ctas.side_effect = lambda m: -(-m // 16)
    getattr(lib, entry).return_value = 0
    counters = [c for c in vars(ops).values()
                if isinstance(c, common.LaunchCounter)]
    plain = call(*_grad_operands(operands()))  # the CPU route
    assert any(t.requires_grad for t in (
        plain if isinstance(plain, tuple) else (plain,)))
    monkeypatch.setattr(ops, "_dispatch", lambda device: lib)
    monkeypatch.setattr(ops, "check_cuda_operand", lambda *a: None,
                        raising=False)
    if hasattr(ops, "_stream"):
        monkeypatch.setattr(ops, "_stream", lambda device: 0)
    monkeypatch.setattr(ops.torch.cuda, "current_stream",
                        lambda device: mock.MagicMock(cuda_stream=0))
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match="has no backward"):
        call(*_grad_operands(operands()))
    assert getattr(lib, entry).call_count == 0
    assert [c.launches for c in counters] == before
    with torch.no_grad():
        call(*_grad_operands(operands()))
    assert getattr(lib, entry).call_count >= 1
    with torch.inference_mode():
        call(*operands())
