"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

Run one cell from the root of a checkout:

    python3 -m cfl_bench.run --workload mamba2-1.3b.fedtrain --seed 7 \
        --seconds 51 --trace 0

`BENCHMARK.json` at the root names the cells, the configurations and the
metrics; everything that belongs to one of them sits in a file of its own
that the harness finds by its name:

  configs/<config>.json     a model configuration as it is run
  traffic/<traffic>.json    a traffic mix: the parameters `traffic.py`
                            and the runner of its `kind` read
  metrics/<metric>.py       a per-layer metric's reader
  limits/<workload>.json    the limits of a cell's output checks
  families/<family>.py      the parameter tree a family's weights fill
  runners/<kind>.py         how one kind of traffic drives the port
  reference/                the plain PyTorch and NumPy reference, which
                            imports nothing of the port

Nothing here imports `jax` or the JAX package `repro`.
"""
