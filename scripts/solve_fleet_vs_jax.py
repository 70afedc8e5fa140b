"""Compare the port's `solve_fleet` with the JAX package's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/solve_fleet_vs_jax.py

The JAX `repro.fleet.solve_fleet` calls `jax.experimental.enable_x64`,
which JAX 0.9 removed; this process sets it to `jax.enable_x64(True)`
before the call (the shim is this script's own, in its own process; the
JAX package and the tests are left as they are).  With one host device
the reference's mesh has one shard, as the port has.  Both solve the
same requests; prints t*, c, the loads' agreement and each wall time.
"""
from __future__ import annotations

import time

import jax
import numpy as np

jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from repro.fleet import solve_fleet as j_solve_fleet  # noqa: E402
from repro.plan.solver import PlanRequest as JRequest  # noqa: E402
from repro.sim.network import mega_fleet as j_mega_fleet  # noqa: E402
from repro.sim.network import paper_fleet as j_paper_fleet  # noqa: E402
from repro_torch.fleet import solve_fleet as t_solve_fleet  # noqa: E402
from repro_torch.plan import PlanRequest as TRequest  # noqa: E402
from repro_torch.sim.network import mega_fleet as t_mega_fleet  # noqa: E402
from repro_torch.sim.network import paper_fleet as t_paper_fleet  # noqa: E402


def cases():
    """(label, jax request, port request, eps_rel)."""
    sizes = np.random.default_rng(2).integers(40, 81, size=24)
    jf, tf = (j_paper_fleet(0.2, 0.2, seed=0, n=24, d=40),
              t_paper_fleet(0.2, 0.2, seed=0, n=24, d=40))
    for kw in ({"c_up": 400}, {"srv_weight": 0.5, "fixed_c": 64}):
        yield (f"paper_fleet(24, d=40) {kw}",
               JRequest(jf.edge, jf.server, sizes, **kw),
               TRequest(tf.edge, tf.server, sizes, **kw), 1e-6)
    for n, eps in ((5000, 1e-3), (20_000, 1e-2)):
        jf, tf = j_mega_fleet(n, d=32, seed=0), t_mega_fleet(n, d=32, seed=0)
        sizes = np.random.default_rng(1).integers(4, 17, size=n)
        yield (f"mega_fleet({n}, d=32), shards 4-16, c_up 4096",
               JRequest(jf.edge, jf.server, sizes, c_up=4096),
               TRequest(tf.edge, tf.server, sizes, c_up=4096), eps)


def main() -> None:
    print(f"jax {jax.__version__}, {len(jax.devices())} device(s)")
    for label, jreq, treq, eps in cases():
        t0 = time.perf_counter()
        want = j_solve_fleet(jreq, eps_rel=eps)
        j_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = t_solve_fleet(treq, eps_rel=eps, device="cpu")
        t_s = time.perf_counter() - t0
        print(f"{label}, eps_rel {eps}: jax t*={want.t_star!r} c={want.c} "
              f"({j_s:.2f} s); port t*={got.t_star!r} c={got.c} "
              f"({t_s:.2f} s); t* rel diff "
              f"{abs(got.t_star - want.t_star) / want.t_star:.3e}; loads "
              f"equal {bool(np.array_equal(got.loads, want.loads))}; "
              f"expected_agg {want.expected_agg!r} / {got.expected_agg!r}")


if __name__ == "__main__":
    main()
