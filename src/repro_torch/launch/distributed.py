"""Multi-process bootstrap (counterpart of `repro/launch/distributed.py`).

Every process runs the same entry point; this module starts
`torch.distributed` from the launcher's environment, over NCCL where the
process has a card and over gloo where it has none, and checks the
world against the requested mesh before any computation starts.

    # per-process entry (the same command on every host):
    COORDINATOR_ADDRESS=host0:29500 NUM_PROCESSES=2 PROCESS_ID=0 \\
        python -m repro_torch.launch.train --distributed ...

Environment (explicit, as the reference's for CPU and GPU clusters):
    COORDINATOR_ADDRESS   host:port of process 0
    NUM_PROCESSES         total process count
    PROCESS_ID            this process's rank
or, with `auto=True`, torchrun's `env://` (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK), the counterpart of the reference's TPU-VM
self-discovery.  A process with a card takes the card LOCAL_RANK names
(else its rank modulo the cards it sees).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           auto: bool = False,
                           backend: Optional[str] = None) -> bool:
    """Start the default process group if a cluster environment is
    present.  Returns True when more than one process takes part.

    Explicit signals only: a coordinator address (argument or
    COORDINATOR_ADDRESS) or `auto=True`.  A safe no-op otherwise.
    `backend` defaults to "nccl" when a card is visible, else "gloo"."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env(
        "PROCESS_ID")
    if coordinator is None and not auto:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator is None:
        rank = _int_env("RANK") or 0
        init = {"init_method": "env://"}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs NUM_PROCESSES and "
                             "PROCESS_ID (or the arguments)")
        rank = process_id
        init = {"init_method": f"tcp://{coordinator}",
                "world_size": num_processes, "rank": process_id}
    if backend == "nccl":
        local = _int_env("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, **init)
    return dist.get_world_size() > 1


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def world_size() -> int:
    """Processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def validate_mesh_capacity(*, multi_pod: bool = False) -> None:
    """Fail fast if the world does not hold the production mesh's
    ranks, one a card."""
    import math

    from .mesh import production_shape
    want = math.prod(production_shape(multi_pod)[0])
    have = world_size()
    if have != want:
        raise RuntimeError(
            f"mesh needs {want} devices, cluster exposes {have}; "
            f"for a dry run use repro_torch.launch.dryrun (a fake world)")


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_hosts(name: str = "barrier") -> None:
    """Cross-process barrier (e.g. before checkpoint publish): a
    one-element all-reduce, on the card over NCCL."""
    if world_size() > 1:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        dist.all_reduce(torch.ones((), device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


__all__ = ["initialize_distributed", "is_coordinator", "sync_hosts",
           "validate_mesh_capacity", "world_size"]
