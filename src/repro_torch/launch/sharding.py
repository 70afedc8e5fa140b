"""Per-architecture sharding rules (counterpart of
`repro/launch/sharding.py`).

Name-pattern rules over the parameter tree give each leaf a spec:

  * tensor parallel over "model": attention QKV/O output dims, MLP hidden,
    vocab/embedding, MoE expert dim (expert parallel);
  * FSDP over "data" for the >40B configs (phi3.5-moe, mistral-large,
    llama4-maverick): the non-model-sharded major dim of every large
    matrix is sharded over the data axis; optimizer states inherit the
    param specs (bf16 states for these configs);
  * Mamba mixer params stay replicated over "model" (packed projection
    boundaries do not align with shard boundaries);
  * batch (and the caches' batch dim) over ("pod", "data"); KV head dim
    over "model" when n_kv_heads is divisible, else head_dim over "model".

Multi-pod: parameters are replicated across pods (the "pod" axis only
carries batch parallelism).

A spec is a tuple with one entry a dim: None, an axis name, or a tuple
of axis names (major first), equal to `tuple(PartitionSpec(...))` of the
reference's spec (a one-name tuple is the name, as PartitionSpec
normalises it).  The rules read only the mesh's axis sizes, so `mesh` is
a `DeviceMesh` or a plain {axis: size} dict.  In place of the
reference's `NamedSharding`, `placements` turns a spec into DTensor
placements on a mesh, `shard_shape` gives a leaf's local shard shape,
and `shard_meta` makes the meta-device DTensor of a leaf.  Trees of specs
keep the parameter tree's dicts; `flatten_specs` lists them by path.

The lane layout of the sweep and serving engines: `lane_specs` gives
each leaf of stacked per-lane operands the reference's spec, its leading
axis over "lanes"; on a lane mesh (a list of devices, `launch.mesh.
make_lane_mesh`) `lane_shardings` turns each leaf's spec into the
device and the range of lanes each device owns (`shard_lanes`), in
place of the reference's `NamedSharding`.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.optimizers import OptState

from .mesh import axis_sizes, data_axes

# configs large enough to need parameter (ZeRO-3 style) sharding over data
FSDP_ARCHS = {"phi3.5-moe-42b-a6.6b", "mistral-large-123b",
              "llama4-maverick-400b-a17b"}

STACKED = ("blocks", "moe_blocks", "cross_blocks", "enc_blocks")


def _size(mesh, axes) -> int:
    """The product of the named axes' sizes (absent axes count 1)."""
    sizes = axis_sizes(mesh)
    names = (axes,) if isinstance(axes, str) else axes
    return math.prod(sizes.get(a, 1) for a in names)


def _norm(entry):
    """A spec entry as PartitionSpec keeps it: a one-name tuple is the
    name."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def param_spec(cfg: ArchConfig, mesh, path: str, shape: tuple[int, ...],
               fsdp: bool) -> tuple:
    """The spec of one parameter leaf (name-pattern rules)."""
    dd = "data" if fsdp else None  # FSDP shards the complementary dim
    leaf = path.split("/")[-1]
    lead = (None,) if path.split("/")[0] in STACKED else ()

    def spec(*axes):
        # drop axes that don't divide
        return tuple(None if ax is None or dim % _size(mesh, ax) else _norm(ax)
                     for dim, ax in zip(shape, lead + axes))

    # --- embeddings / head -------------------------------------------------
    if path == "embed":
        return spec("model", dd)
    if path == "lm_head":
        return spec(dd, "model")
    # --- MoE ---------------------------------------------------------------
    if "/moe/" in path or path.endswith("/router"):
        if leaf == "router":
            return spec(None, None)
        if leaf in ("w_gate", "w_up", "w_down"):   # (E, D, F) / (E, F, D)
            return spec("model", dd, None)
    # --- attention ---------------------------------------------------------
    if leaf in ("wq", "wk", "wv", "wkv"):
        return spec(dd, "model")
    if leaf == "wo":
        return spec("model", dd)
    if leaf in ("bq", "bk", "bv", "bkv"):
        return spec("model")
    # --- dense MLP ---------------------------------------------------------
    if leaf in ("w_gate", "w_up", "w_gu"):
        return spec(dd, "model")
    if leaf == "w_down":
        return spec("model", dd)
    # --- mamba mixer: tensor parallelism off, FSDP over data -----------------
    if leaf in ("w_in", "w_out"):
        return spec(dd, None)
    if leaf == "conv_w":
        return spec(None, dd)
    # norms, biases, gates, a_log, ... -> replicated
    return (None,) * len(shape)


def base_arch_name(name: str) -> str:
    """Strip variant suffixes (e.g. '-sw8192') to recover the base arch."""
    return name.split("-sw")[0]


def _map_with_path(fn, node, prefix: str = ""):
    """fn(path, leaf) over a dict tree, keeping its dicts."""
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in node.items()}
    return fn(prefix, node)


def _zip_map(fn, specs, tree):
    """fn(spec, leaf) over a spec tree and the dict tree it belongs to."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, specs[k], v) for k, v in tree.items()}
    return fn(specs, tree)


def flatten_specs(specs, prefix: str = "") -> dict[str, tuple]:
    """{path: spec} of a spec tree (dicts, and an OptState's fields)."""
    if isinstance(specs, OptState):
        specs = {k: v for k, v in specs._asdict().items() if v is not None}
    if isinstance(specs, dict):
        out: dict[str, tuple] = {}
        for k, v in specs.items():
            out.update(flatten_specs(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: specs}


def param_shardings(cfg: ArchConfig, mesh, params: Any,
                    fsdp: Optional[bool] = None) -> Any:
    fsdp = base_arch_name(cfg.name) in FSDP_ARCHS if fsdp is None else fsdp
    return _map_with_path(
        lambda path, leaf: param_spec(cfg, mesh, path, tuple(leaf.shape),
                                      fsdp), params)


def _batch_axes(mesh, b: int):
    """The batch dim's entry: every data axis where they divide it, else
    "data" where it divides, else None."""
    baxes = data_axes(mesh)
    if b % _size(mesh, baxes) == 0:
        return _norm(baxes)
    return "data" if b % _size(mesh, "data") == 0 else None


def batch_shardings(cfg: ArchConfig, mesh, batch: Any) -> Any:
    """tokens/targets (B, S) over batch axes; modality stubs likewise;
    decode pos is replicated."""
    def one(path, leaf):
        if path == "pos" or leaf.ndim == 0:
            return ()
        return (_batch_axes(mesh, leaf.shape[0]),) + (None,) * (leaf.ndim - 1)

    return _map_with_path(one, batch)


def cache_shardings(cfg: ArchConfig, mesh, cache: Any) -> Any:
    """KV caches (L, B, T, G, hd): batch over data axes; heads over model
    when divisible, else head_dim over model.  SSM state (L, B, H, P, N):
    heads over model.  Conv cache (L, B, K, C): channels over model."""
    model = _size(mesh, "model")

    def one(path, leaf):
        shp = leaf.shape
        b = _batch_axes(mesh, shp[1])
        if "mamba" in path and path.endswith("ssm"):
            return (None, b, "model" if shp[2] % model == 0 else None, None,
                    None)
        if "mamba" in path and path.endswith("conv"):
            return (None, b, None, "model" if shp[3] % model == 0 else None)
        # attention / cross KV: (L, B, T, G, hd)
        if shp[3] % model == 0:
            return (None, b, None, "model", None)
        if shp[4] % model == 0:
            return (None, b, None, None, "model")
        return (None, b, None, None, None)

    return _map_with_path(one, cache)


def opt_state_shardings(mesh, param_sh: Any, opt_state: OptState,
                        zero1: bool = False) -> OptState:
    """Optimizer moments inherit the param specs; step is replicated.

    zero1=True (ZeRO-1): moments of fully-replicated params are sharded
    over `data` on their first divisible dim (> 1)."""
    data = _size(mesh, "data")

    def like(ps, leaf):
        if zero1 and all(a is None for a in ps):
            for i, dim in enumerate(leaf.shape):
                if dim % data == 0 and dim > 1:
                    return tuple("data" if j == i else None
                                 for j in range(leaf.ndim))
        return ps

    mu, nu = opt_state.mu, opt_state.nu
    return OptState(step=(),
                    mu=None if mu is None else _zip_map(like, param_sh, mu),
                    nu=None if nu is None else _zip_map(like, param_sh, nu))


def replicated(mesh, tree: Any) -> Any:
    return _map_with_path(lambda path, leaf: (), tree)


# ---------------------------------------------------------------------------
# the lane layout (in place of the reference's lane NamedShardings)
# ---------------------------------------------------------------------------

def lane_specs(tree: Any) -> Any:
    """Specs splitting every leaf's leading axis over "lanes": axis 0 is
    the session lane, everything behind it is per-lane state and stays
    unsharded."""
    return _map_with_path(
        lambda path, leaf: ("lanes",) + (None,) * (leaf.ndim - 1), tree)


def shard_lanes(mesh, n_lanes: int) -> list[tuple[torch.device, range]]:
    """Lanes 0 .. n_lanes - 1 split evenly over the lane mesh (a list of
    devices): [(device j, its contiguous range of lanes)], in mesh
    order.  The mesh size must divide the lane count
    (`launch.mesh.lane_mesh_size`)."""
    k = len(mesh)
    if k < 1 or n_lanes % k:
        raise ValueError(f"{n_lanes} lanes do not split evenly over "
                         f"{k} devices")
    per = n_lanes // k
    return [(dev, range(j * per, (j + 1) * per))
            for j, dev in enumerate(mesh)]


def lane_shardings(mesh, tree: Any) -> Any:
    """For each leaf of `lane_specs(tree)` on a `make_lane_mesh` mesh:
    the (device, range of lanes) pairs its leading axis splits into."""
    return _map_with_path(lambda path, leaf: shard_lanes(
        mesh, leaf.shape[0]), tree)


# ---------------------------------------------------------------------------
# specs on a DeviceMesh (in place of NamedSharding)
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> list:
    """DTensor placements of a spec on `mesh`: Shard(d) on each mesh dim
    that the spec names for tensor dim d, Replicate() on the others.  A
    tensor dim over several axes is split over them in mesh order, major
    first, as the reference's tuple entries."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            dim_of[ax] = d
    return [Shard(dim_of[ax]) if ax in dim_of else Replicate()
            for ax in mesh.mesh_dim_names]


def shard_shape(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """The local shard shape of a leaf of `shape` under `spec` (each dim
    divided by the sizes of its axes; the reference's
    `NamedSharding.shard_shape`).  Raises where an axis does not divide
    its dim."""
    out = []
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        n = 1 if entry is None else _size(mesh, entry)
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {entry} ({n})")
        out.append(dim // n)
    return tuple(out)


def shard_bytes(spec: tuple, leaf: torch.Tensor, mesh) -> int:
    """Bytes of one device's shard of `leaf`."""
    return math.prod(shard_shape(spec, tuple(leaf.shape), mesh)) \
        * leaf.element_size()


def shard_meta(spec: tuple, leaf: torch.Tensor, mesh):
    """The meta-device DTensor of `leaf` under `spec` on `mesh`: this
    rank's shard (of `shard_shape`) with the global shape inferred from
    the placements, which must give back the leaf's shape."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(shard_shape(spec, tuple(leaf.shape), mesh),
                        dtype=leaf.dtype, device="meta")
    dt = DTensor.from_local(local, mesh, placements(spec, mesh),
                            run_check=False)
    if tuple(dt.shape) != tuple(leaf.shape):
        raise ValueError(f"spec {spec} on {tuple(mesh.shape)} gives "
                         f"{tuple(dt.shape)}, not {tuple(leaf.shape)}")
    return dt


__all__ = ["FSDP_ARCHS", "base_arch_name", "batch_shardings",
           "cache_shardings", "flatten_specs", "lane_shardings", "lane_specs",
           "opt_state_shardings", "param_shardings", "param_spec",
           "placements", "replicated", "shard_bytes", "shard_lanes",
           "shard_meta", "shard_shape"]
