"""Protocol core: delay model, planning shims, encoding, aggregation, CFL
state (counterpart of `repro.core`).

The reference's 22 package-level names resolve on first access (PEP 562's
module `__getattr__`), each from its submodule, so importing this package
imports no submodule and the NumPy-only modules stay light until a name
is used."""
from __future__ import annotations

import importlib

# {name: the submodule that defines it}, as `repro.core` exports them
_SOURCES = {
    "DeviceDelayParams": "delay_model", "compute_cdf": "delay_model",
    "total_cdf": "delay_model", "sample_total": "delay_model",
    "expected_return": "returns", "optimal_loads": "returns",
    "RedundancyPlan": "redundancy", "solve_redundancy": "redundancy",
    "systematic_weights": "redundancy",
    "ClientParity": "encoding", "generator_matrix": "encoding",
    "encode_client": "encoding", "encode_fleet": "encoding",
    "client_partial_gradients": "aggregation",
    "parity_gradient": "aggregation", "combine": "aggregation",
    "uncoded_full_gradient": "aggregation", "gd_update": "aggregation",
    "nmse": "aggregation",
    "CFLState": "cfl", "setup": "cfl", "epoch_gradient": "cfl",
}
__all__ = list(_SOURCES)


def __getattr__(name: str):
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f".{_SOURCES[name]}", __name__),
                    name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_SOURCES))
