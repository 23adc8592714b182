"""Drive the port's scheduling cycle the way a cluster does, and check it.

    python -m kube_batch_tpu_torch.testing.cycle_drive [--tasks 50000]
        [--nodes 5000] [--arrivals 5000] [--host-ports-frac 0.0]
        [--device cuda|cpu] [--profile]

Builds ``synthetic_cluster(tasks, nodes, gang_size=4, n_queues=3)`` through
the port's cache handlers (timed apart as ingest), then runs three cycles
of ``Scheduler.run_once`` with the shipped tier list and ``actions:
"allocate"``:

1. every pod pending — the full program (K1 once per round);
2. after a kubelet pass (bound pods start Running) and ``arrivals`` new
   pending pods in gangs of 4 — the compacted program when they fit the
   task capacity's pending bucket (K2 and the table rounds);
3. after a second kubelet pass, with nothing pending — the idle path.
   The bidding rounds are capped (6 × 3), so cycle 2 may leave arrivals
   unplaced; their PodGroups turn Pending, which allocate skips until an
   enqueue action (not ported yet) promotes them, and the second pass
   deletes those jobs as a user cancels jobs that did not start.

After each cycle it checks the column store against the object model,
every node's ``idle ≥ −quanta`` and ``used ≤ allocatable + quanta``, and
that no pod was bound twice, and it records the cycle's stage times, kernel
launches, (on the card) host syncs, and what stayed unplaced and why.  A
cycle is timed with the cyclic garbage collector paused after a full
collection, as the JAX package's ``bench.py`` times its cycles.  With
``--profile`` each cycle runs under ``torch.profiler`` instead of the sync
count, and its record adds the device's busy time and top kernels (the
profiler slows the host several times over, so take wall and stage times
from a run without it).  Prints one JSON line; any failed check raises.
``device=None`` means CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Pod, PodGroup
from kube_batch_tpu_torch.api.types import PodGroupPhase, PodPhase, TaskStatus
from kube_batch_tpu_torch.framework.conf import default_configuration
from kube_batch_tpu_torch.ops import kernels
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing.synthetic import CPU_CHOICES, MEM_CHOICES, synthetic_cluster

GANG = 4
N_QUEUES = 3


def fail(msg: str) -> None:
    raise AssertionError(msg)


@contextlib.contextmanager
def count_syncs(device: torch.device):
    """Count the host↔device synchronisations inside the block (CUDA's
    sync-debug warnings: every blocking copy and scalar read); yields a
    one-element list that holds the count afterwards.  On the CPU the
    count stays 0."""
    box = [0]
    if device.type != "cuda":
        yield box
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode("default")
    box[0] = sum(1 for w in caught if "synchroniz" in str(w.message))


@contextlib.contextmanager
def device_profile(device: torch.device, top: int = 8):
    """Profile the block's CUDA activity; yields a dict that afterwards
    holds ``device_busy_ms`` (the sum of kernel and memory-op times on the
    device) and the ``top_kernels`` by device time."""
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield out
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    out["device_busy_ms"] = sum(e.self_device_time_total for e in dev) / 1e3
    out["top_kernels"] = [
        {"name": e.key[:80], "count": e.count, "device_ms": e.self_device_time_total / 1e3}
        for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:top]]


def node_invariants(cache) -> Dict[str, int]:
    """Nodes whose idle fell below −quanta or whose used exceeds
    allocatable + quanta (the cache's live ledgers)."""
    cols = cache.columns
    q = cols.spec.quanta
    live = cols.n_valid
    return {
        "nodes_idle_negative": int((np.any(cols.n_idle < -q, axis=1) & live).sum()),
        "nodes_over_alloc": int((np.any(cols.n_used > cols.n_alloc + q, axis=1) & live).sum()),
    }


def kubelet_start_bound(cache) -> int:
    """Every bound pod that is still Pending starts Running."""
    started = [dataclasses.replace(p, phase=PodPhase.RUNNING)
               for _k, p in sorted(cache.pods.items())
               if p.phase == PodPhase.PENDING and p.node_name is not None]
    for pod in started:
        cache.update_pod(pod)
    return len(started)


def add_arrivals(cache, n_pods: int, seed: int, tag: str) -> None:
    """``n_pods`` pending pods in new gangs of 4 over the cluster's
    queues, requests drawn like ``synthetic_cluster``'s."""
    rng = np.random.default_rng(seed)
    queues = sorted(cache.queues)
    n_jobs = -(-n_pods // GANG)
    for j in range(n_jobs):
        cache.add_pod_group(PodGroup(
            name=f"{tag}{j}", namespace="bench",
            min_member=min(GANG, n_pods - j * GANG),
            queue=queues[j % len(queues)], creation_index=10**6 + j))
    for i in range(n_pods):
        cache.add_pod(Pod(
            name=f"{tag}-t{i}", namespace="bench",
            requests={"cpu": float(rng.choice(CPU_CHOICES)),
                      "memory": float(rng.choice(MEM_CHOICES))},
            annotations={GROUP_NAME_ANNOTATION: f"{tag}{i // GANG}"},
            phase=PodPhase.PENDING, creation_index=10**6 + i))


def cancel_unplaced(cache) -> int:
    """Delete every job that still has Pending pods, pods and PodGroup;
    returns the number of pods deleted."""
    doomed = [job for job in cache.jobs.values()
              if job.pod_group is not None and job.task_status_index.get(TaskStatus.PENDING)]
    n = 0
    for job in doomed:
        for task in list(job.tasks.values()):
            cache.delete_pod(task.pod)
            n += 1
        cache.delete_pod_group(job.uid)
    return n


def observed(cache) -> dict:
    """Binds and every task's (status, node): what two runs must share."""
    return {
        "binds": dict(cache.binder.binds),
        "tasks": {k: (int(t.status), t.node_name)
                  for job in cache.jobs.values() for k, t in job.tasks.items()},
    }


def drive(n_tasks: int, n_nodes: int, arrivals: int, host_ports_frac: float = 0.0,
          seed: int = 0, device=None, keep_states: bool = False,
          profile: bool = False) -> dict:
    """The three-cycle drive (module docstring).  Returns the report; with
    ``keep_states`` it also carries each cycle's :func:`observed`, with
    ``profile`` each cycle's :func:`device_profile`."""
    t = time.perf_counter()
    cache = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES,
                              seed=seed, host_ports_frac=host_ports_frac)
    ingest_s = time.perf_counter() - t
    sched = Scheduler(cache, conf=default_configuration(), device=device)
    action = sched.actions[0]
    cycles: List[dict] = []
    states: List[dict] = []
    for c in range(3):
        churn_s, started, cancelled = 0.0, 0, 0
        if c > 0:
            t = time.perf_counter()
            started = kubelet_start_bound(cache)
            if c == 1:
                add_arrivals(cache, arrivals, seed + 1, "arrive")
            else:
                cancelled = cancel_unplaced(cache)
            churn_s = time.perf_counter() - t
        pending = int(cache.columns.schedulable_pending_mask().sum())
        binds_before = len(cache.binder.binds)
        kernels.reset_launches()
        gc.collect()
        gc.disable()
        try:
            watch = (device_profile(sched.device) if profile
                     else count_syncs(sched.device))
            with watch as seen:
                t = time.perf_counter()
                sched.run_once()
                if sched.device.type == "cuda":
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
        finally:
            gc.enable()
        launches = dict(kernels.launches)
        errs = cache.columns.check_consistency(cache)
        if errs:
            fail(f"cycle {c + 1}: column store disagrees with objects: {errs[:5]}")
        inv = node_invariants(cache)
        if any(inv.values()):
            fail(f"cycle {c + 1}: node invariants violated: {inv}")
        channel = cache.binder.channel
        if len(set(channel)) != len(channel):
            fail(f"cycle {c + 1}: a pod was bound twice")
        topk = action.last_topk
        mode = ("idle" if pending == 0 else "compacted" if topk is not None else "full")
        gangs = sum(1 for j in cache.jobs.values()
                    if j.pod_group is not None and not j.pod_group.shadow
                    and j.pod_group.phase == PodGroupPhase.RUNNING)
        # what the cycle left unplaced, and why (the Unschedulable messages)
        unplaced = int(cache.columns.schedulable_pending_mask().sum())
        reasons = sorted({cond.message for j in cache.jobs.values()
                          if j.pod_group is not None and j.task_status_index.get(TaskStatus.PENDING)
                          for cond in j.pod_group.conditions
                          if cond.type == "Unschedulable"})
        cycles.append(dict(
            cycle=c + 1, pending=pending, started_running=started,
            cancelled_pods=cancelled, churn_s=churn_s, mode=mode, topk=topk, rounds=action.last_solve_rounds,
            new_binds=len(cache.binder.binds) - binds_before,
            binds=len(cache.binder.binds), gangs_running=gangs,
            unplaced=unplaced, unschedulable=reasons[:3],
            fit_histogram=action.last_fit_histogram, fallback=action.last_fallback,
            wall_ms=wall_ms, stages_ms=dict(sched.last_cycle_ms),
            allocate_ms=dict(action.last_phase_ms), launches=launches,
            syncs=seen[0] if sched.device.type == "cuda" and not profile else None,
            invariants=inv))
        if profile:
            cycles[-1].update(seen)
        if keep_states:
            states.append(observed(cache))
    report = dict(tasks=n_tasks, nodes=n_nodes, arrivals=arrivals,
                  host_ports_frac=host_ports_frac, device=str(sched.device),
                  ingest_s=ingest_s, cycles=cycles)
    if keep_states:
        report["states"] = states
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", type=int, default=50_000)
    ap.add_argument("--nodes", type=int, default=5_000)
    ap.add_argument("--arrivals", type=int, default=5_000)
    ap.add_argument("--host-ports-frac", type=float, default=0.0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    print(json.dumps(drive(args.tasks, args.nodes, args.arrivals,
                           args.host_ports_frac, device=args.device,
                           profile=args.profile)))


if __name__ == "__main__":
    main()
