"""MessagePack checkpoints of trees of tensors (counterpart of
`repro/checkpoint/checkpoint.py`), in the reference's layout.

Layout: <dir>/step_<%08d>.msgpack, each file one map {"step": n,
"arrays": {path: {"dtype", "shape", "data"}}} with the leaves' paths
joined by "/" in `jax.tree`'s order (`repro_torch.tree`; an optimizer
state's leaves read "opt/step", "opt/mu/...") and each leaf's bytes in C
order.  The encoder is `checkpoint.codec`, which writes the bytes
`msgpack.packb(payload, use_bin_type=True)` writes, so a file written by
either package restores in the other.  A file is written to ".tmp" and
published by `os.replace`.

Restore rebuilds into a caller-supplied template tree — each leaf cast to
the template leaf's dtype and placed on its device, a missing leaf or a
wrong shape raising — or, with no template, returns {path: CPU tensor}
(the reference returns NumPy arrays, which have no bfloat16).
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree

from . import codec

_SEP = "/"

# torch dtype <-> the NumPy name the reference writes (`str(arr.dtype)`);
# bfloat16 (ml_dtypes' name) travels as its 16-bit pattern
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _host_bytes(leaf) -> tuple[str, list[int], memoryview]:
    """(dtype name, shape, the C-order bytes, uncopied)."""
    t = torch.as_tensor(leaf).detach().to("cpu").contiguous()
    if t.dtype not in _NAMES:
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return (_NAMES[t.dtype], list(t.shape),
            memoryview(raw.numpy().reshape(-1).view(np.uint8)))


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.msgpack")


def save_checkpoint(ckpt_dir: str, step: int, tree_: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    for key, leaf in tree.flatten_with_path(tree_, _SEP):
        name, shape, data = _host_bytes(leaf)
        arrays[key] = {"dtype": name, "shape": shape, "data": data}
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        codec.pack({"step": step, "arrays": arrays}, f.write)
    os.replace(tmp, path)  # atomic publish
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.msgpack", name))]
    return max(steps) if steps else None


def _tensor(entry: dict) -> torch.Tensor:
    name = entry["dtype"]
    if name not in _DTYPES:
        raise TypeError(f"cannot restore a {name} leaf")
    dt = _DTYPES[name]
    if dt == torch.bfloat16:
        arr = np.frombuffer(entry["data"], dtype=np.int16)
        t = torch.from_numpy(arr).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(entry["data"], dtype=name))
    return t.reshape(entry["shape"])


def restore_checkpoint(ckpt_dir: str, template: Any = None,
                       step: Optional[int] = None) -> tuple[int, Any]:
    """Returns (step, tree).  With a template, leaves are cast to the
    template's dtypes, placed on its leaves' devices and validated against
    its shapes."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with open(_path(ckpt_dir, step), "rb") as f:
        # writable, so the tensors below are views of it
        payload = codec.unpackb(bytearray(f.read()))
    arrays = payload["arrays"]
    if template is None:
        return payload["step"], {k: _tensor(v) for k, v in arrays.items()}
    out = []
    for key, leaf in tree.flatten_with_path(template, _SEP):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = _tensor(arrays[key])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
        out.append(arr.to(device=leaf.device, dtype=leaf.dtype, copy=True))
    return payload["step"], tree.unflatten(template, out)
