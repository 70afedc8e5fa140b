"""The lane and shard meshes (`launch.mesh.lane_mesh_size`,
`make_lane_mesh`, `make_shard_mesh`; `launch.sharding.lane_specs`,
`lane_shardings`) and the three engines that split work over them, on
the CPU.

`lane_mesh_size` is held to the reference's rule (its `jax.devices()`
replaced by a list of the given length) for every device count from 1
to 8 and lane count from 1 to 16.  The sweep (`run_sweep`), the serving
engine (`FedServeEngine`) and `fleet.solve_fleet` run over a device list
of k repeated CPU devices, and each result must be bit-equal
(`np.array_equal`, equal t*, c and loads) to the one-device run, with
the split itself checked: the lanes of a bucket or group go to
lane_mesh_size(lanes, k) devices, contiguous and even, and the fleet's
device chunks to all k.
"""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.launch.mesh as j_mesh
import repro.launch.sharding as j_sharding
from repro_torch.api import Session, TrainData, make_strategy, run_sweep
from repro_torch.api import session as t_session
from repro_torch.fleet import plan as t_fleet_plan
from repro_torch.fleet import solve_fleet
from repro_torch.launch import mesh, sharding
from repro_torch.plan import PlanRequest
from repro_torch.serving import ConvergenceCriterion, FedServeEngine
from repro_torch.serving import fed_engine
from repro_torch.sim.network import mega_fleet, paper_fleet

CPU = torch.device("cpu")
N, ELL, D, EPOCHS = 8, 40, 12, 15


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_lane_mesh_size_is_the_references(n_dev, monkeypatch):
    monkeypatch.setattr(j_mesh.jax, "devices", lambda: [None] * n_dev)
    devices = [CPU] * n_dev
    for n_lanes in range(1, 17):
        k = mesh.lane_mesh_size(n_lanes, devices)
        assert k == j_mesh.lane_mesh_size(n_lanes)
        assert n_lanes % k == 0 and 1 <= k <= min(n_dev, n_lanes)
        assert mesh.make_lane_mesh(n_lanes, devices) == devices[:k]
    assert mesh.make_shard_mesh(devices) == devices
    with pytest.raises(ValueError):
        mesh.lane_mesh_size(0, devices)


def test_lane_specs_and_shardings():
    """The specs are the reference's `tuple(P(...))`; on a lane mesh each
    leaf's leading axis splits into even contiguous ranges, one a
    device, and an uneven split is refused."""
    tree = {"a": torch.zeros(6, 3), "b": {"c": torch.zeros(6)}}
    want = j_sharding.lane_specs({"a": np.zeros((6, 3)),
                                  "b": {"c": np.zeros(6)}})
    specs = sharding.lane_specs(tree)
    assert specs == {"a": tuple(want["a"]), "b": {"c": tuple(want["b"]["c"])}}
    assert specs["a"] == tuple(P("lanes", None))
    devs = [torch.device("cpu"), torch.device("meta"), torch.device("cpu")]
    sh = sharding.lane_shardings(devs, tree)
    assert sh["a"] == sh["b"]["c"] == [(devs[0], range(0, 2)),
                                       (devs[1], range(2, 4)),
                                       (devs[2], range(4, 6))]
    with pytest.raises(ValueError, match="evenly"):
        sharding.shard_lanes(devs[:2] * 2, 6)


def test_local_devices_of_the_cpu():
    assert mesh.local_devices("cpu") == [CPU]


@pytest.fixture(scope="module")
def problem():
    fleet = paper_fleet(0.2, 0.2, seed=1, n=N, d=D)
    return fleet, TrainData.linreg(0, N, ELL, D, device=CPU)


def _sessions(fleet, data):
    """Four CodedFL lanes (one bucket) and two uncoded ones (another)."""
    c = int(0.3 * data.m)
    coded = [Session(make_strategy("cfl", key_seed=s, fixed_c=c), fleet,
                     0.3, EPOCHS, seed=s, device=CPU) for s in range(4)]
    uncoded = [Session(make_strategy("uncoded"), fleet, lr, EPOCHS, seed=9,
                       device=CPU) for lr in (0.3, 0.2)]
    return coded + uncoded


def _split_spy(monkeypatch, module):
    """Record (mesh size, lanes) of every `shard_lanes` call of `module`."""
    calls = []
    real = sharding.shard_lanes

    def spy(m, n_lanes):
        calls.append((len(m), n_lanes))
        return real(m, n_lanes)

    monkeypatch.setattr(module, "shard_lanes", spy)
    return calls


@pytest.mark.parametrize("k", [2, 3, 4])
def test_sweep_over_k_devices_equals_one(problem, k, monkeypatch):
    fleet, data = problem
    one = run_sweep(_sessions(fleet, data), data, devices=[CPU])
    calls = _split_spy(monkeypatch, t_session)
    many = run_sweep(_sessions(fleet, data), data, devices=[CPU] * k)
    assert sorted(calls) == sorted([(mesh.lane_mesh_size(4, [CPU] * k), 4),
                                    (mesh.lane_mesh_size(2, [CPU] * k), 2)])
    for a, b in zip(one, many):
        assert np.array_equal(a.nmse, b.nmse) and np.array_equal(a.beta,
                                                                 b.beta)
        assert np.array_equal(a.times, b.times)


@pytest.mark.parametrize("k", [2, 4])
def test_serve_over_k_devices_equals_one(problem, k, monkeypatch):
    """Four slots a group over k devices, more sessions than slots, an
    early exit: every report bit-equal to the one-device engine's."""
    fleet, data = problem
    crit = ConvergenceCriterion(nmse_target=0.5, min_epochs=3)

    def serve(devices):
        engine = FedServeEngine(data, lane_width=4, chunk=5, criterion=crit,
                                device=CPU, devices=devices)
        sessions = _sessions(fleet, data) + _sessions(fleet, data)[:3]
        return engine.serve(sessions)

    one = serve([CPU])
    calls = _split_spy(monkeypatch, fed_engine)
    many = serve([CPU] * k)
    assert calls and set(calls) == {(k, 4)}
    for a, b in zip(one, many):
        assert np.array_equal(a.nmse, b.nmse) and np.array_equal(a.beta,
                                                                 b.beta)
        assert a.extras == b.extras
    assert any(r.extras["serve_converged"] for r in many)


@pytest.fixture(scope="module")
def fleet_request():
    """A 300-device request and its one-device solve (chunks of 32)."""
    fleet = mega_fleet(300, d=16, seed=3)
    req = PlanRequest(edge=fleet.edge, server=fleet.server,
                      data_sizes=np.random.default_rng(1).integers(
                          8, 40, size=300), c_up=128)
    return req, solve_fleet(req, eps_rel=1e-4, chunk=32, device=CPU,
                            devices=[CPU])


@pytest.mark.parametrize("k", [2, 3, 5])
def test_solve_fleet_over_k_devices_equals_one(k, fleet_request,
                                                monkeypatch):
    """At n = 300 with chunks of 32 (10 chunks: uneven runs at k = 3),
    t*, c, the loads and the aggregate equal the one-device solve."""
    req, one = fleet_request
    meshes = []
    real = mesh.make_shard_mesh

    def spy(devices=None):
        meshes.append(real(devices))
        return meshes[-1]

    monkeypatch.setattr(t_fleet_plan, "make_shard_mesh", spy)
    got = solve_fleet(req, eps_rel=1e-4, chunk=32, device=CPU,
                      devices=[CPU] * k)
    assert [len(m) for m in meshes] == [k]
    assert got.t_star == one.t_star and got.c == one.c
    np.testing.assert_array_equal(got.loads, one.loads)
    assert got.expected_agg == one.expected_agg
    np.testing.assert_array_equal(got.p_return, one.p_return)
