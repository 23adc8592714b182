"""A faithful CPU re-creation of the reference's sequential allocate loop —
the denominator of BASELINE.md's "≥10× vs the Go allocate loop" target.

The reference's allocate (allocate.go:95-200) is an ordered greedy loop:
pop queue → pop job → per task: PredicateNodes over every node (16-worker
fan-out, scheduler_helper.go:34-64), PrioritizeNodes (LeastRequested +
BalancedResourceAllocation, nodeorder.go:188-227), SelectBestNode, place on
Idle (mutating the node for the next task), then commit the job's Statement
iff JobReady else roll every placement back (allocate.go:192-196).

This module reproduces exactly that control flow on the host: one task at a
time, full node scan per task, mutation between tasks, per-gang commit/
rollback — in three denominators that bracket what the reference could
achieve (``testing/go_pass_bench.py`` times their per-task pass):

  numpy           a Python loop over a numpy vector pass.
  native_single   the whole loop in compiled C (``native/go_pass.c``), one
                  thread — the generous lower bound: compiled-Go speed
                  class, zero framework overhead, no goroutine churn.
  native_pooled   the same loop, each task's pass chunked over a persistent
                  16-thread pool with barriers — the reference's
                  ParallelizeUntil shape.

The real reference sits above these bounds: its per-node work is interface-
dispatched k8s predicates and priorities over NodeInfo maps, plus PQ
maintenance, Statement allocations and per-placement event handlers.

Every leg runs on the host; the workload is the port's synthetic snapshot
(``testing/synthetic.py``), drawn on the CPU.

    python -m kube_batch_tpu_torch.testing.go_baseline [n_tasks] [n_nodes]
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np


def numpy_inner_pass(req, node_idle, node_alloc, quanta, cap_cpu, cap_mem):
    """The per-task pass: PredicateNodes (resource fit over EVERY node) then
    PrioritizeNodes (LeastRequested + BalancedResourceAllocation) and argmax
    — shared with testing/go_pass_bench.py so the micro-benchmark times the
    loop's actual pass.  Returns the best node index or -1."""
    feasible = np.all(req <= node_idle + quanta, axis=1)
    if not feasible.any():
        return -1
    used_cpu = node_alloc[:, 0] - node_idle[:, 0] + req[0]
    used_mem = node_alloc[:, 1] - node_idle[:, 1] + req[1]
    fr_cpu = (cap_cpu - used_cpu) / cap_cpu
    fr_mem = (cap_mem - used_mem) / cap_mem
    least_requested = (fr_cpu + fr_mem) * 5.0   # *10/2
    balanced = 10.0 - np.abs(fr_cpu - fr_mem) * 10.0
    score = np.where(feasible, least_requested + balanced, -np.inf)
    return int(np.argmax(score))


def go_loop_allocate(
    task_req: np.ndarray,   # [T, R] f64 — InitResreq per pending task
    task_job: np.ndarray,   # [T] int — job index, tasks of a job contiguous
    job_min: np.ndarray,    # [J] int — gang minAvailable
    node_idle: np.ndarray,  # [N, R] f64 — MUTATED in place like the Go loop
    node_alloc: np.ndarray,  # [N, R] f64 — allocatable (for scoring)
    quanta: np.ndarray,     # [R]
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Returns (assigned [T] node index or -1, stats)."""
    T, R = task_req.shape
    assigned = np.full(T, -1, np.int64)
    # semantic scoring dims like the k8s priorities: cpu (0) and memory (1)
    cap_cpu = np.maximum(node_alloc[:, 0], 1.0)
    cap_mem = np.maximum(node_alloc[:, 1], 1.0)

    t0 = time.perf_counter()
    placed_total = 0
    i = 0
    while i < T:
        j = task_job[i]
        lo = i
        while i < T and task_job[i] == j:
            i += 1
        placements = []  # (task, node, req) for rollback
        for t in range(lo, i):
            req = task_req[t]
            best = numpy_inner_pass(
                req, node_idle, node_alloc, quanta, cap_cpu, cap_mem
            )
            if best < 0:
                continue
            # ---- SelectBestNode + place (mutates Idle for the next task)
            node_idle[best] -= req
            placements.append((t, best, req))
        # ---- gang Statement: commit iff JobReady else roll back --------
        if len(placements) >= job_min[j]:
            for t, n, _ in placements:
                assigned[t] = n
            placed_total += len(placements)
        else:
            for _, n, req in reversed(placements):
                node_idle[n] += req
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    return assigned, {"elapsed_ms": elapsed_ms, "placed": placed_total}


def _workload(n_tasks, n_nodes, gang_size, n_queues):
    """The loop's inputs as contiguous host arrays (f64, int64), drawn by
    the port's synthetic generator on the CPU."""
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    snap, meta = synthetic_device_snapshot(
        n_tasks=n_tasks, n_nodes=n_nodes, gang_size=gang_size,
        n_queues=n_queues, device="cpu",
    )
    nt, nn = meta.n_tasks, meta.n_nodes

    def host(t, dtype, rows=None):
        a = t.numpy()
        return np.ascontiguousarray(a if rows is None else a[:rows], dtype)

    return (
        host(snap.task_req, np.float64, nt),
        host(snap.task_job, np.int64, nt),
        host(snap.job_min_avail, np.int64),
        host(snap.node_idle, np.float64, nn),
        host(snap.node_alloc, np.float64, nn),
        host(snap.quanta, np.float64),
        nt, nn,
    )


def go_loop_allocate_native(task_req, task_job, job_min, node_idle,
                            node_alloc, quanta, pooled: bool,
                            threads: int = 16):
    """The same loop run entirely in compiled C (``native/go_pass.c``;
    ``node_idle`` is mutated).  Returns (assigned, stats); raises when the
    library does not build or the pool does not start."""
    from kube_batch_tpu_torch import native

    lib = native.load()
    T, R = task_req.shape
    N = node_idle.shape[0]
    for a, dtype in ((task_req, np.float64), (task_job, np.int64),
                     (job_min, np.int64), (node_idle, np.float64),
                     (node_alloc, np.float64), (quanta, np.float64)):
        if a.dtype != dtype or not a.flags.c_contiguous:
            raise TypeError(f"expected a C-contiguous {np.dtype(dtype)} array, "
                            f"got {a.dtype}")
    assigned = np.full(T, -1, np.int64)
    scratch = np.zeros(T, np.int64)

    def run():
        t0 = time.perf_counter()
        placed = lib.go_loop_run(
            task_req.ctypes.data, task_job.ctypes.data, job_min.ctypes.data,
            node_idle.ctypes.data, node_alloc.ctypes.data, quanta.ctypes.data,
            T, N, R, 1 if pooled else 0,
            assigned.ctypes.data, scratch.ctypes.data,
        )
        return placed, (time.perf_counter() - t0) * 1e3

    if pooled:
        with native.POOL_LOCK:
            native.pool_init(lib, threads)
            try:
                placed, elapsed_ms = run()
            finally:
                lib.go_pass_pool_shutdown()
    else:
        placed, elapsed_ms = run()
    return assigned, {"elapsed_ms": elapsed_ms, "placed": int(placed)}


def run_go_baseline(n_tasks: int, n_nodes: int, gang_size: int = 4,
                    n_queues: int = 3) -> Dict[str, float]:
    """Time the sequential loop over the synthetic headline workload (tasks
    already in queue/job order — the PQ ordering the reference spends extra
    time maintaining is given to the loop for free).

    Reports the numpy re-creation and the compiled-C bracket (see the module
    docstring): ``native_single_ms`` is the generous denominator;
    ``native_pooled_ms`` the reference's 16-worker chunking shape."""
    task_req, task_job, job_min, node_idle, node_alloc, quanta, nt, nn = (
        _workload(n_tasks, n_nodes, gang_size, n_queues)
    )
    assigned, stats = go_loop_allocate(
        task_req, task_job, job_min, node_idle.copy(), node_alloc, quanta
    )
    stats["n_tasks"] = nt
    stats["n_nodes"] = nn
    # identical control flow + arithmetic ⇒ identical placements; a C run
    # whose placements diverge is NOT a valid denominator and reports its
    # divergence count INSTEAD of a time
    for label, pooled in (("native_single", False), ("native_pooled", True)):
        a_native, s_native = go_loop_allocate_native(
            task_req, task_job, job_min, node_idle.copy(), node_alloc, quanta,
            pooled=pooled,
        )
        if np.array_equal(a_native, assigned):
            stats[f"{label}_ms"] = round(s_native["elapsed_ms"], 1)
            stats[f"{label}_placed"] = s_native["placed"]
        else:
            stats[f"{label}_divergence"] = int((a_native != assigned).sum())
    return stats


if __name__ == "__main__":
    import json
    import sys

    nt = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    nn = int(sys.argv[2]) if len(sys.argv) > 2 else 5_000
    print(json.dumps(run_go_baseline(nt, nn)))
