"""Architecture configs of the model zoo, the reference's eleven.

`load_all` imports the config modules (their families' models run in
`repro_torch.models`), so `get_config`/`list_archs` see them.
"""
import importlib

from .base import (ArchConfig, EncDecSpec, HybridSpec, INPUT_SHAPES, MoESpec,
                   SSMSpec, VLMSpec, get_config, input_specs, list_archs,
                   register)

_MODULES = ["codeqwen15_7b", "granite_8b", "llama32_vision_11b",
            "llama4_maverick", "lm_100m", "mamba2_1p3b", "minitron_4b",
            "mistral_large_123b", "phi35_moe", "whisper_tiny",
            "zamba2_1p2b"]

# the ten assigned architectures (lm-100m is an examples-only extra)
ASSIGNED = [
    "phi3.5-moe-42b-a6.6b", "codeqwen1.5-7b", "granite-8b", "zamba2-1.2b",
    "mamba2-1.3b", "llama4-maverick-400b-a17b", "llama-3.2-vision-11b",
    "mistral-large-123b", "minitron-4b", "whisper-tiny",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


__all__ = ["ASSIGNED", "ArchConfig", "EncDecSpec", "HybridSpec",
           "INPUT_SHAPES", "MoESpec", "SSMSpec", "VLMSpec", "get_config",
           "input_specs", "list_archs", "register", "load_all"]
