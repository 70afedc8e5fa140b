"""Versioned on-disk tile cache: the persisted half of the autotuner.

The counterpart of `repro/tune/cache.py`, with the same schema, keys and
lookup order.  One JSON file per location:

    {"version": 1,
     "entries": {
       "<family>|<backend>|<bucket>": {
         "block": [128, 64, 32],
         "us": 41.2,                # measured winner time (audit trail)
         "bound_us": 3.7,           # its roofline lower bound
         "n_candidates": 6, "n_pruned": 0,
         "torch": "2.5.1", "device": "NVIDIA H100 80GB HBM3, 700.00 W",
         "source": "measured"
       }, ...}}

Lookup order (first hit wins):

  1. the user cache, `$REPRO_TORCH_TUNE_CACHE_DIR/tiles.json`, defaulting
     to `~/.cache/repro-torch-tune/tiles.json` (written by `python -m
     repro_torch.tune`); a place of its own, so that the JAX package's
     cache is never read;
  2. the committed fallback `src/repro_torch/tune/defaults.json`, tuned
     on an H100 for the shapes the port's driven paths launch
     (`families.CI_SHAPES`).

Shapes are bucketed before keying (each dim rounds up to the next power
of two), so nearby problem sizes share one tuned tile.  Backends are
`kernels.common.backend()`'s: `"cuda-sm90"` and `"cpu"`.

A `version` mismatch invalidates a file wholesale; `store()` always
writes the current version (dropping stale-version entries on the first
write).
"""
from __future__ import annotations

import json
import os
from typing import Optional

CACHE_VERSION = 1
CACHE_ENV = "REPRO_TORCH_TUNE_CACHE_DIR"
CACHE_FILENAME = "tiles.json"

# (abspath, mtime_ns, inode, size) -> entries dict; re-read only when the
# file changes (`store` records what it wrote, so two writes within one
# tick of the file system's clock never read back a stale memo)
_LOAD_MEMO: dict[tuple[str, int, int, int], dict] = {}
# (family, shape, device, $REPRO_TORCH_TUNE_CACHE_DIR) -> the tile that
# `kernels.common.resolve_block` resolved "auto" to: a wrapper resolves on
# every launch, so a lookup's answer is kept for the life of the process.
# `TileCache.store` clears it; whoever changes a cache file by other means
# calls `forget_resolved()`.
RESOLVED: dict[tuple, object] = {}


def forget_resolved() -> None:
    """Drop the memoized "auto" tiles (after a cache file changed)."""
    RESOLVED.clear()


def _memo_key(path: str, st: os.stat_result) -> tuple[str, int, int, int]:
    return (os.path.abspath(path), st.st_mtime_ns, st.st_ino, st.st_size)


def _pow2ceil(v: int) -> int:
    return 1 if v <= 1 else 1 << (int(v) - 1).bit_length()


def bucket_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Power-of-two ceiling per dim: the cache's shape equivalence class."""
    return tuple(_pow2ceil(int(s)) for s in shape)


def cache_key(family: str, shape: tuple[int, ...], backend: str) -> str:
    bucket = "x".join(str(s) for s in bucket_shape(shape))
    return f"{family}|{backend}|{bucket}"


def user_cache_path() -> str:
    base = os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-tune")
    return os.path.join(base, CACHE_FILENAME)


def defaults_path() -> str:
    """The committed fallback (the driven paths' shapes on the H100)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "defaults.json")


def _load_entries(path: str) -> dict:
    """Entries of one cache file; {} when absent or version-mismatched."""
    try:
        st = os.stat(path)
    except OSError:
        return {}
    memo_key = _memo_key(path, st)
    if memo_key in _LOAD_MEMO:
        return _LOAD_MEMO[memo_key]
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        payload = {}
    entries = payload.get("entries", {}) \
        if payload.get("version") == CACHE_VERSION else {}
    _LOAD_MEMO[memo_key] = entries
    return entries


class TileCache:
    """One cache file (user cache, repo defaults, or a test tmpdir)."""

    def __init__(self, path: str):
        self.path = path

    def lookup(self, family: str, shape: tuple[int, ...],
               backend: str) -> Optional[dict]:
        return _load_entries(self.path).get(
            cache_key(family, shape, backend))

    def store(self, family: str, shape: tuple[int, ...], backend: str,
              block, meta: Optional[dict] = None) -> dict:
        """Merge one winner into the file (read-modify-write).

        Stale-version files are dropped wholesale on the first store:
        old-schema entries are never carried forward.
        """
        entries = dict(_load_entries(self.path))
        entry = {"block": [int(b) for b in
                           (block if isinstance(block, (tuple, list))
                            else (block,))]}
        entry.update(meta or {})
        entries[cache_key(family, shape, backend)] = entry
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": entries},
                      f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)
        _LOAD_MEMO[_memo_key(self.path, os.stat(self.path))] = entries
        forget_resolved()
        return entry


def lookup_entry(family: str, shape: tuple[int, ...],
                 backend: Optional[str] = None) -> Optional[dict]:
    """User cache first, then the committed defaults; backend None means
    `kernels.common.backend()` of the current device."""
    if backend is None:
        from repro_torch.kernels import common

        backend = common.backend()
    for path in (user_cache_path(), defaults_path()):
        ent = _load_entries(path).get(cache_key(family, shape, backend))
        if ent is not None:
            return ent
    return None


def lookup_block(family: str, shape: tuple[int, ...],
                 backend: Optional[str] = None
                 ) -> Optional[tuple[int, ...]]:
    """The tuned tile for `(family, shape bucket, backend)`, or None."""
    ent = lookup_entry(family, shape, backend)
    if ent is None or not ent.get("block"):
        return None
    return tuple(int(b) for b in ent["block"])
