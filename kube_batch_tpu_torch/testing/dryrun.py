"""The multi-device dryrun: ``python -m kube_batch_tpu_torch.testing.dryrun N``.

Mirrors ``kube_batch_tpu/testing/dryrun.py``: the allocate solve sharded
over an N-shard mesh at a small shape, a shape past the 4 096 padding
bucket held equal to the single-device solve, and the reclaim solve held
equal to its single-device twin.  ``--device`` (default ``cuda``) picks
the mesh's devices: N distinct cards when there are N, else N shards of
the one card (``cuda:0``), or N shards of the CPU with ``--device cpu``.

``--distributed P`` runs the two-process rehearsal instead: P child
processes join one ``torch.distributed`` group (``parallel/distributed.py``:
``nccl`` with a card each, ``gloo`` otherwise), each owning
``--shards-per-process`` positions of a 1-D mesh, solve the
4 096 × 1 024 snapshot, and rank 0's result must equal this process's
single-device solve, field by field.  One JSON line reports it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: the rehearsal's snapshot (chip_smoke's mid size)
DIST_TASKS, DIST_NODES = 4096, 1024


def mesh_devices(n: int, device: str):
    """N devices: N distinct cards when there are N, else N shards of the
    one card, or of the CPU."""
    if device == "cpu":
        return ["cpu"] * n
    cards = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if cards >= n else ["cuda:0"] * n


def _with_running(snap, meta, frac: float):
    """The first ``frac`` of jobs Running, round-robin over the nodes, with
    consistent ledgers (the JAX package's dryrun helper), on numpy."""
    from kube_batch_tpu_torch.api.types import TaskStatus

    task_job = snap.task_job
    nj, nn = meta.n_jobs, meta.n_nodes
    run_jobs = np.zeros(snap.job_min_avail.shape[0], bool)
    run_jobs[: int(nj * frac)] = True
    run_task = run_jobs[task_job] & snap.task_valid
    idxs = np.flatnonzero(run_task)
    nodes = (np.arange(idxs.size) % nn).astype(np.int32)
    task_node = snap.task_node.copy()
    task_node[idxs] = nodes
    status = snap.task_status.copy()
    status[idxs] = int(TaskStatus.RUNNING)
    req = snap.task_resreq
    used = np.zeros_like(snap.node_used)
    np.add.at(used, nodes, req[idxs])
    J = snap.job_min_avail.shape[0]
    job_allocated = np.zeros_like(snap.job_allocated)
    np.add.at(job_allocated, task_job[idxs], req[idxs])
    queue_alloc = np.zeros_like(snap.queue_alloc)
    np.add.at(queue_alloc, snap.job_queue[task_job[idxs]], req[idxs])
    job_min = snap.job_min_avail.copy()
    job_min[run_jobs] = 1
    return snap._replace(
        task_node=task_node, task_status=status,
        task_pending=snap.task_pending & ~run_task,
        node_idle=np.maximum(snap.node_alloc - used, 0.0), node_used=used,
        job_ready=np.bincount(task_job[idxs], minlength=J).astype(np.int32),
        job_allocated=job_allocated, queue_alloc=queue_alloc, job_min_avail=job_min)


def _differs(a, b):
    return [f for f, x, y in zip(a._fields, a, b) if not torch.equal(x.cpu(), y.cpu())]


def run(n: int, device: str = "cuda") -> dict:
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy, snapshot_to_numpy
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig, allocate_solve
    from kube_batch_tpu_torch.ops.eviction import EvictConfig, evict_solve
    from kube_batch_tpu_torch.parallel.mesh import (
        make_mesh, sharded_allocate_solve, sharded_evict_solve,
    )
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    mesh = make_mesh(mesh_devices(n, device))
    dev = mesh.first
    out = {"mesh": [str(d) for d in mesh.devices], "devices_distinct": mesh.devices_distinct}
    # 1. a small shape
    snap, meta = synthetic_device_snapshot(256, max(64, n * 8), gang_size=4, n_queues=3,
                                           gpu_task_frac=0.2, device=dev)
    res = sharded_allocate_solve(snap, AllocateConfig(), mesh)
    placed = int((res.assigned[: meta.n_tasks] >= 0).sum())
    assert placed > 0, "the sharded dryrun placed nothing"
    assert bool((res.node_idle >= -snap.quanta[None, :]).all()), "a node is overcommitted"
    out["small_placed"] = placed
    # 2. past the 4 096 bucket (the task axis pads to 5 120), sharded == single
    big, meta_big = synthetic_device_snapshot(5000, 1024, gang_size=4, n_queues=3, device=dev)
    cfg = AllocateConfig()
    bad = _differs(sharded_allocate_solve(big, cfg, mesh), allocate_solve(big, cfg))
    assert not bad, f"the sharded solve differs past the 4096 bucket in {bad}"
    out["bucket_5120_equal"] = True
    # 3. the reclaim solve on a tight cluster, sharded == single
    ev, meta_ev = synthetic_device_snapshot(512, max(16, n * 2), gang_size=4, n_queues=3,
                                            device=dev)
    ev = snapshot_from_numpy(_with_running(snapshot_to_numpy(ev), meta_ev, 0.7), dev)
    ev_cfg = EvictConfig(mode="reclaim")
    (sh, _), (one, _) = sharded_evict_solve(ev, ev_cfg, mesh), evict_solve(ev, ev_cfg)
    bad = _differs(sh, one)
    assert not bad, f"the sharded eviction solve differs in {bad}"
    out["evict_claims"] = int((sh.claim_node[: meta_ev.n_tasks] >= 0).sum())
    return out


# --------------------------------------------------------------------------
# the multi-process rehearsal
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, device: str, k: int, out_path: str) -> None:
    """One rank: join, place the seeded snapshot on the global mesh, solve,
    and (rank 0) write the result's fields."""
    from kube_batch_tpu_torch.ops import kernels
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig
    from kube_batch_tpu_torch.parallel import distributed
    from kube_batch_tpu_torch.parallel.mesh import sharded_allocate_solve
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    backend = distributed.initialize(f"127.0.0.1:{port}", world, rank)
    mesh = distributed.global_mesh(shards_per_process=k, device=device)
    snap, _meta = synthetic_device_snapshot(DIST_TASKS, DIST_NODES, gang_size=4, n_queues=3,
                                            seed=0, device=mesh.first)
    kernels.reset_launches()
    t = time.perf_counter()
    res = sharded_allocate_solve(snap, AllocateConfig(), mesh)
    wall_ms = (time.perf_counter() - t) * 1e3
    import torch.distributed as dist

    info = dict(rank=rank, backend=backend, device=str(mesh.first), wall_ms=wall_ms,
                launches=dict(kernels.launches), rounds=int(res.rounds_run))
    np.savez(f"{out_path}.{rank}.npz", **{f: getattr(res, f).cpu().numpy() for f in res._fields})
    with open(f"{out_path}.{rank}.json", "w") as f:
        json.dump(info, f)
    dist.barrier()
    dist.destroy_process_group()


def rehearse(world: int = 2, device: str = "cuda", k: int = 2, timeout: float = 300) -> dict:
    """Run ``world`` ranks as child processes and hold each rank's result
    against this process's single-device solve of the same snapshot."""
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig, allocate_solve
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="kbt-dist-")
    out_path = os.path.join(tmp, "res")
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kube_batch_tpu_torch.testing.dryrun", "--rank", str(r),
         "--world", str(world), "--port", str(port), "--device", device,
         "--shards-per-process", str(k), "--out", out_path], env=env)
        for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"rehearsal ranks exited {rcs}")
    dev = torch.device("cuda", 0) if device != "cpu" else torch.device("cpu")
    snap, _meta = synthetic_device_snapshot(DIST_TASKS, DIST_NODES, gang_size=4, n_queues=3,
                                            seed=0, device=dev)
    one = allocate_solve(snap, AllocateConfig())
    ranks = []
    for r in range(world):
        got = np.load(f"{out_path}.{r}.npz")
        bad = [f for f in one._fields if not np.array_equal(got[f], getattr(one, f).cpu().numpy())]
        if bad:
            raise AssertionError(f"rank {r}'s sharded solve differs from one process in {bad}")
        with open(f"{out_path}.{r}.json") as f:
            ranks.append(json.load(f))
    for name in os.listdir(tmp):
        os.unlink(os.path.join(tmp, name))
    os.rmdir(tmp)
    return dict(world=world, shards_per_process=k, shape=[DIST_TASKS, DIST_NODES],
                equal="every field, every rank", placed=int((one.assigned >= 0).sum()),
                ranks=ranks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8, help="mesh shards")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--distributed", type=int, default=0, metavar="P",
                    help="run the P-process rehearsal")
    ap.add_argument("--shards-per-process", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        rank_main(a.rank, a.world, a.port, a.device, a.shards_per_process, a.out)
        return 0
    if a.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device is available; pass --device cpu", file=sys.stderr)
        return 1
    if a.distributed:
        print(json.dumps(rehearse(a.distributed, a.device, a.shards_per_process)))
    else:
        print(json.dumps(dict(dryrun=a.n, **run(a.n, a.device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
