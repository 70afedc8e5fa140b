"""Protocol core: delay model, planning shims, encoding, aggregation, CFL
state (counterpart of `repro.core`).  Importing this package imports no
submodule, so the NumPy-only modules stay light."""
