"""Multi-process setup: the same mesh mapped onto ``torch.distributed``
ranks.

Mirrors ``kube_batch_tpu/parallel/distributed.py``, in the SPMD form of
the JAX package's multi-controller runs: every rank runs the same program
on the same replicated inputs and computes the mesh positions it owns;
the shard bodies' collectives (``parallel/shard_solve.collect``) exchange
the per-shard payloads through ``torch.distributed.all_gather``, and the
tail then runs on every rank, so every rank holds the same result.

The backend is chosen from the hardware, never by trying one: ``nccl``
when every rank has a card of its own on this host (rank r drives
``cuda:r``), ``gloo`` otherwise (ranks sharing one card, or the CPU; the
payloads then cross through host memory).  The choice is printed.

Usage, in each process::

    from kube_batch_tpu_torch.parallel.distributed import initialize, global_mesh
    initialize("localhost:29500", num_processes=2, process_id=rank)
    mesh = global_mesh(shards_per_process=2)
    res = sharded_allocate_solve(snap, config, mesh)
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

_state: dict = {}


def choose_backend(num_processes: int) -> str:
    """``nccl`` when this host has a card per rank, else ``gloo``."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if cards >= num_processes > 1 else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Optional[str]:
    """Join the process group (``coordinator`` "host:port", the world size
    and this rank).  With no arguments it reads torchrun's environment
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) and stays single-process
    without one.  A second call is a no-op.  Returns the backend, or None
    when single-process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    if coordinator is None and num_processes is None:
        if "WORLD_SIZE" not in os.environ:
            return None
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ.get("RANK", "0"))
        init_method = "env://"
    else:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    backend = choose_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id)
    print(f"parallel.distributed: rank {process_id}/{num_processes} joins with "
          f"backend {backend}", file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    _state.update(backend=backend)
    return backend


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:rank`` under ``nccl``, else ``device``
    (default the card, or the CPU without one)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", dist.get_rank())
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def global_mesh(shards_per_process: int = 1, device=None):
    """The 1-D node mesh over every rank: rank r owns positions
    ``[r·k, (r+1)·k)`` (k = ``shards_per_process``), on its own device, so
    each rank's node shards are contiguous.  Single-process (no group):
    a plain mesh of ``k`` shards on ``device``."""
    import torch.distributed as dist

    from kube_batch_tpu_torch.parallel.mesh import Mesh

    k = shards_per_process
    if not dist.is_initialized():
        return Mesh([rank_device(device)] * k)
    world, rank = dist.get_world_size(), dist.get_rank()
    nccl = dist.get_backend() == "nccl"
    mine = rank_device(device)
    devices = []
    for r in range(world):
        devices += [torch.device("cuda", r) if nccl else mine] * k
    return Mesh(devices, ranks=[r for r in range(world) for _ in range(k)], rank=rank)
