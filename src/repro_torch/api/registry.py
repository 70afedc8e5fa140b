"""Strategy registry: construct any coding scheme by name (counterpart of
`repro/api/registry.py`).

Names: uncoded, cfl, gradcode, stochastic (alias scfl), lowlatency (alias
lowlat), codedfedl (alias cfedl), hierarchical (aliases hier, fleet — pass
base= and topology=, see `repro_torch.fleet`).  Extra keyword arguments
pass straight through to the strategy dataclass; for key-carrying
schemes `key_seed=<int>` is accepted and becomes the port's key, the int
seed of a `torch.Generator` (the reference turns it into
`jax.random.PRNGKey(key_seed)`).

User schemes join via `register_strategy("myscheme", MyStrategy)` (or as a
decorator, `@register_strategy("myscheme")`).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple, Type

_BUILTINS: Dict[str, Tuple[str, str]] = {
    "uncoded": ("repro_torch.api.strategy", "UncodedFL"),
    "cfl": ("repro_torch.api.strategy", "CodedFL"),
    "gradcode": ("repro_torch.api.strategy", "GradientCodingFL"),
    "stochastic": ("repro_torch.schemes", "StochasticCodedFL"),
    "lowlatency": ("repro_torch.schemes", "LowLatencyCFL"),
    "codedfedl": ("repro_torch.schemes", "CodedFedL"),
    "hierarchical": ("repro_torch.fleet", "HierarchicalCFL"),
}
_ALIASES: Dict[str, str] = {"scfl": "stochastic", "lowlat": "lowlatency",
                            "cfedl": "codedfedl",
                            "hier": "hierarchical", "fleet": "hierarchical"}
_CUSTOM: Dict[str, Type] = {}


def available_strategies() -> Tuple[str, ...]:
    """Canonical registered names (aliases not included)."""
    return tuple(sorted(set(_BUILTINS) | set(_CUSTOM)))


def register_strategy(name: str, cls: Optional[Type] = None):
    """Register a user strategy class under `name` (callable or decorator).
    Built-in names and their aliases cannot be shadowed."""
    if name in _BUILTINS or name in _ALIASES:
        raise ValueError(
            f"cannot register {name!r}: it is a built-in strategy name or "
            "alias")

    def _register(c: Type) -> Type:
        _CUSTOM[name] = c
        return c
    return _register(cls) if cls is not None else _register


def make_strategy(name: str, **kwargs):
    """Construct a registered strategy by name (see module docstring)."""
    if name in _CUSTOM:  # custom names are exact (never alias-expanded)
        cls = _CUSTOM[name]
    elif (canonical := _ALIASES.get(name, name)) in _BUILTINS:
        where = _BUILTINS[canonical]
        cls = getattr(importlib.import_module(where[0]), where[1])
    else:
        raise ValueError(
            f"unknown strategy {name!r}; available: "
            f"{', '.join(available_strategies())}")

    key_seed = kwargs.pop("key_seed", None)
    fields = {f.name for f in dataclasses.fields(cls)} \
        if dataclasses.is_dataclass(cls) else set()
    if key_seed is not None and ("key" not in fields or "key" in kwargs):
        raise ValueError(
            f"key_seed is only valid for key-carrying strategies without an "
            f"explicit key= argument (strategy {name!r})")
    if "key" in fields and "key" not in kwargs:
        if key_seed is None:
            # no silent default: two runs that both "forgot" the key must
            # not share generator and noise draws
            raise ValueError(
                f"strategy {name!r} needs a PRNG key: pass key=<int seed> "
                "or key_seed=<int>")
        kwargs["key"] = int(key_seed)
    return cls(**kwargs)
