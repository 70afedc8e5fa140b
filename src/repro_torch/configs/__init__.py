"""Architecture configs of the ported model families.

`load_all` imports the config modules that are ported (their families'
models run in `repro_torch.models`), so `get_config`/`list_archs` see
exactly those; the reference's other configs come with their families.
"""
import importlib

from .base import (ArchConfig, EncDecSpec, HybridSpec, INPUT_SHAPES, MoESpec,
                   SSMSpec, VLMSpec, get_config, list_archs, register)

_MODULES = ["codeqwen15_7b", "granite_8b", "llama4_maverick", "lm_100m",
            "mamba2_1p3b", "minitron_4b", "mistral_large_123b",
            "phi35_moe", "zamba2_1p2b"]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


__all__ = ["ArchConfig", "EncDecSpec", "HybridSpec", "INPUT_SHAPES",
           "MoESpec", "SSMSpec", "VLMSpec", "get_config", "list_archs",
           "register", "load_all"]
