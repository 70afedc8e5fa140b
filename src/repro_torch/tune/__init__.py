"""`repro_torch.tune`: the roofline-pruned tile autotuner of the port's
CUDA kernels and its persisted cache (counterpart of `repro.tune`).

Public surface:

  * `lookup_block`, `TileCache`, `bucket_shape` — the cache layer (pure
    stdlib; what the kernel wrappers' `block="auto"` reads);
  * `autotune`, `tune_shapes`, `TuneResult` — the tuner (imported lazily,
    so that `repro_torch.tune.cache` stays light on the `block="auto"`
    path);
  * `FAMILIES`, `CI_SHAPES` — the kernel-family registry.

`python -m repro_torch.tune` tunes on the card and fills the cache.
"""
from .cache import (CACHE_VERSION, TileCache, bucket_shape, cache_key,
                    defaults_path, lookup_block, lookup_entry,
                    user_cache_path)

_LAZY = {
    "autotune": "tuner", "tune_shapes": "tuner", "TuneResult": "tuner",
    "candidate_terms": "tuner", "roofline_bound": "tuner",
    "prune": "tuner", "measure": "tuner",
    "FAMILIES": "families", "CI_SHAPES": "families",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["CACHE_VERSION", "TileCache", "bucket_shape", "cache_key",
           "defaults_path", "lookup_block", "lookup_entry",
           "user_cache_path", *_LAZY]
