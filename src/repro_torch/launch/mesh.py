"""Production meshes (counterpart of `repro/launch/mesh.py`).

Single pod: 16 x 16 = 256 ranks over ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks over ("pod", "data", "model").

A mesh is a `torch.distributed.device_mesh.DeviceMesh`, one rank a card,
over the default process group, which must span the mesh
(`launch.distributed.initialize_distributed` makes one from the cluster's
environment).  `production_world` stands a fake 256- or 512-rank world in
for the cards, so that the dry run (`launch.dryrun`) places meta-device
shards on the production meshes in one process, as the reference
compiles on placeholder host devices.

The lane mesh and the shard mesh are plain lists of `torch.device`,
the local cards (or devices) one process drives: `make_lane_mesh`
splits a sweep's or a serving group's lanes evenly over `lane_mesh_size`
of them (`api.run_sweep`, `serving.FedServeEngine`), `make_shard_mesh`
spans them all for `fleet.solve_fleet`'s device axis.  The reference's
meshes are `jax.sharding.Mesh`es under `shard_map`; here each device
runs its share of the work in turn from this process, and the
arithmetic of a lane or a shard is the same on every device, so no
result depends on the mesh size.

Not carried over: the TPU v5e constants (`PEAK_FLOPS_BF16`, `HBM_BW`,
`ICI_BW`: the H100's rates live in `repro_torch.roofline`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD_SHAPE = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(mesh shape, axis names) of the single- or multi-pod mesh."""
    if multi_pod:
        return MULTI_POD_SHAPE, MULTI_POD_AXES
    return SINGLE_POD_SHAPE, SINGLE_POD_AXES


def _device_type() -> str:
    """"cuda" over an NCCL group, else "cpu"."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The production mesh over the default group, which must hold
    exactly its 256 or 512 ranks."""
    shape, axes = production_shape(multi_pod)
    want = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise RuntimeError(
            f"mesh needs {want} ranks, the process group holds {have}; for "
            "a dry run use repro_torch.launch.dryrun (a fake world)")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A (world // model_axis, model_axis) mesh over ("data", "model")
    spanning the default group; without one, a world of this process
    alone (one card: (1, 1)) is made in-process over gloo and stays
    until `torch.distributed.destroy_process_group()`."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    return init_device_mesh(device_type or _device_type(),
                            (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def production_world(multi_pod: bool = False) -> Iterator[DeviceMesh]:
    """A fake process group of the production mesh's 256 or 512 ranks in
    this process (this process rank 0; its collectives do nothing), and
    the mesh over it, on "cpu" (the dry run's tensors live on the meta
    device).  The group is destroyed on exit.  Refuses to run beside a
    live default group, which it would replace."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is live; the fake "
                           "production world would replace it")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, _ = production_shape(multi_pod)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    finally:
        dist.destroy_process_group()


def local_devices(device=None) -> list[torch.device]:
    """The devices of `device`'s type this process drives, `device`
    first: every card (`torch.cuda.device_count()`) for a CUDA device
    (None: the current card), the one device otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return [dev]
    first = torch.cuda.current_device() if dev.index is None else dev.index
    return [torch.device("cuda", first)] + [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())
        if i != first]


def lane_mesh_size(n_lanes: int,
                   devices: Optional[Sequence[torch.device]] = None) -> int:
    """Device count for a sweep's lane axis: the largest divisor of
    `n_lanes` that fits the device count (`devices`, default
    `local_devices()`).

    Divisibility keeps the split even, as the reference's `shard_map`
    requires: every device runs the same number of lanes.  A 16-lane
    sweep over 4 devices uses all 4; a 5-lane sweep uses 1."""
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    n_dev = len(local_devices() if devices is None else devices)
    return next(k for k in range(min(n_dev, n_lanes), 0, -1)
                if n_lanes % k == 0)


def make_lane_mesh(n_lanes: int,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> list[torch.device]:
    """The lane (batch-of-sessions) mesh of a sweep: the first
    `lane_mesh_size(n_lanes, devices)` of `devices` (default
    `local_devices()`).  Each runs its lanes in turn on its own copies of
    their operands, so the mesh size never changes a lane's
    arithmetic."""
    devices = local_devices() if devices is None else list(devices)
    return devices[:lane_mesh_size(n_lanes, devices)]


def make_shard_mesh(devices: Optional[Sequence[torch.device]] = None
                    ) -> list[torch.device]:
    """The mesh of a tensor-sharded solve: ALL of `devices` (default
    `local_devices()`).  Unlike the lane mesh, its size does not adapt:
    `fleet.solve_fleet` splits one problem's device axis over it."""
    return local_devices() if devices is None else list(devices)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of a plain {name: size}
    dict standing in for one."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-parallel axes of a mesh (includes 'pod' when present)."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


__all__ = ["MULTI_POD_AXES", "MULTI_POD_SHAPE", "SINGLE_POD_AXES",
           "SINGLE_POD_SHAPE", "axis_sizes", "data_axes", "lane_mesh_size",
           "local_devices", "make_host_mesh", "make_lane_mesh",
           "make_production_mesh", "make_shard_mesh", "production_shape",
           "production_world"]
