"""The lane and shard meshes over every card of one machine: phase 27 of
`chip_smoke.py` alone.

    python3 scripts/lane_mesh_cards.py

Builds the kernels, draws the §IV data on the first card (the port's
quickstart, 600 epochs), then runs `chip_smoke.mesh_phase` over all
`torch.cuda.device_count()` cards: 8 CodedFL lanes through `run_sweep`
and through `FedServeEngine(lane_width=4)` over the cards and over the
first card alone (lanes bit-equal, the kernel-1 launches counted), and
`solve_fleet` on 100 000 clients over the shard mesh and over one card
(t*, c and loads equal), with the wall times of each.  Prints the card
line of `nvidia-smi` first.  Needs at least one CUDA card (sm_90a) and
`nvcc`; on one card the meshes have size 1.
"""
from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.encode import ops as enc_ops  # noqa: E402
from repro_torch.kernels.round_grad import ops as rg_ops  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    os.environ["REPRO_TORCH_TUNE_CACHE_DIR"] = tempfile.mkdtemp()
    dev = resolve_device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    build.build(build.SOURCES)
    counters = {"round_grad": rg_ops.COUNTER,
                "coded_round_grad": rg_ops.CODED_COUNTER,
                "tier_round_grad": rg_ops.TIER_COUNTER,
                "lsq_gradient": rg_ops.LSQ_COUNTER,
                "encode": enc_ops.COUNTER}

    def reset():
        for counter in counters.values():
            counter.reset()

    def read() -> dict:
        return {k: counter.launches for k, counter in counters.items()}

    def expect(**launched) -> dict:
        return {**dict.fromkeys(counters, 0), **launched}

    out = quickstart.run(epochs=600, device=dev)
    mesh = cs.mesh_phase(out, dev, card, expect, reset, read)
    print(f"lane_mesh_cards: {mesh['cards']} card(s), walls "
          + ", ".join(f"{k} {v:.4f} s" for k, v in mesh["walls"].items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
