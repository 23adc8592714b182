"""Drive the port's scheduling cycle the way a cluster does, and check it.

    python -m kube_batch_tpu_torch.testing.cycle_drive [--tasks 50000]
        [--nodes 5000] [--arrivals 5000] [--host-ports-frac 0.0]
        [--device cuda|cpu] [--profile]
    python -m kube_batch_tpu_torch.testing.cycle_drive --overcommit
        [--running 40000] [--pending 20000] [--nodes 5000] [--device ...]

Both drives run three cycles of ``Scheduler.run_once`` under the shipped
five-action conf (``enqueue, reclaim, allocate, backfill, preempt``,
``config/kube-batch-tpu-conf.yaml``).  Before every cycle but the first a
kubelet pass deletes the pods the last cycle evicted and starts the bound
pods Running.

The headline drive (:func:`drive`) builds ``synthetic_cluster(tasks,
nodes, gang_size=4, n_queues=3)`` through the port's cache handlers (timed
apart as ingest):

1. every pod pending — the full program (K1 once per round);
2. ``arrivals`` new pending pods in gangs of 4 whose PodGroups carry their
   summed requests as MinResources, as Volcano's job controller sets them
   — the compacted program when they fit the pending bucket (K2).  The
   bidding rounds are capped (6 × 3), so part of them stays unplaced, and
   their PodGroups turn Pending;
3. enqueue promotes those PodGroups through the admission gate (its
   kernel) and allocate retries them.

The overcommit drive (:func:`drive_overcommit`) builds
``synthetic_overcommit_cluster(running, pending, nodes, gang_size=4)``:
queue q0 (weight 1) fills every node's cpu and queue q1 (weight 3) waits.
Cycle 1: reclaim evicts q0 pods and pipelines q1's claimants; allocate,
backfill and preempt run.  Cycle 2: with the evicted pods deleted, the
claimants bind.  Cycle 3: one more cycle.

After each cycle the drive checks the column store against the object
model, every node's ``idle ≥ −quanta`` and ``used ≤ allocatable +
quanta``, that no pod was bound twice, and the evictions: every evicted
pod is a victim of a claim that reclaim or preempt carried out, the
victims cover their claimant's request, reclaim's victims are in another
queue than their claimant, and no gang was evicted below its
MinAvailable.  It records per cycle the stage times (open, each action,
close), the allocate phases, the reclaim and preempt solves' rounds and
ms, binds, evictions, pipelined claimants, kernel launches, (on the card)
host syncs, and what stayed unplaced and why.  A cycle is timed with the
cyclic garbage collector paused after a full collection, as the JAX
package's ``bench.py`` times its cycles.  With ``--profile`` each cycle
runs under ``torch.profiler`` instead of the sync count, and its record
adds the device's busy time and top kernels (the profiler slows the host
several times over, so take wall and stage times from a run without it).
Prints one JSON line; any failed check raises.  ``device=None`` means
CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import time
import warnings
from typing import Callable, Dict, List

import numpy as np
import torch

from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Pod, PodGroup
from kube_batch_tpu_torch.api.types import PodGroupPhase, PodPhase, TaskStatus
from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
from kube_batch_tpu_torch.ops import kernels
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing.synthetic import (
    CPU_CHOICES,
    MEM_CHOICES,
    synthetic_cluster,
    synthetic_overcommit_cluster,
)

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


def eviction_checks(cache, sched, new_evicts: List[str]) -> Dict[str, int]:
    """Every pod evicted this cycle is a victim of a claim reclaim or
    preempt carried out; the victims cover their claimant's InitResreq;
    reclaim's victims sit in another queue than their claimant; no gang
    (MinAvailable > 1) dropped below MinAvailable through eviction.
    Raises on a violation; returns the counts checked."""
    claims = []
    for action in sched.actions:
        for claimant, _node, victims in getattr(action, "last_evictions", ()):
            claims.append((action.name, claimant, victims))
    victim_keys = [v.key() for _, _, victims in claims for v in victims]
    if sorted(victim_keys) != sorted(new_evicts):
        fail(f"{len(new_evicts)} pods evicted but {len(victim_keys)} victims of "
             "carried-out claims")
    spec = cache.spec
    for name, claimant, victims in claims:
        got = spec.empty()
        for v in victims:
            got.add_(v.resreq)
        if not claimant.init_resreq.less_equal(got):
            fail(f"{name}: victims of {claimant.key()} do not cover its request")
        if name == "reclaim":
            queue = cache.jobs[claimant.job].queue
            if any(cache.jobs[v.job].queue == queue for v in victims):
                fail(f"reclaim evicted a victim of {claimant.key()}'s own queue")
    short = [uid for uid in {v.job for _, _, victims in claims for v in victims}
             if cache.jobs[uid].min_available > 1
             and cache.jobs[uid].ready_task_num < cache.jobs[uid].min_available]
    if short:
        fail(f"eviction left gangs below MinAvailable: {short[:3]}")
    return {"claims": len(claims), "victims": len(victim_keys)}


def kubelet(cache, evicted: List[str]) -> Dict[str, int]:
    """Delete the pods evicted since the last pass, then start every bound
    pod that is still Pending."""
    deleted = 0
    for key in evicted:
        pod = cache.pods.get(key)
        if pod is not None:
            cache.delete_pod(pod)
            deleted += 1
    started = [dataclasses.replace(p, phase=PodPhase.RUNNING)
               for _k, p in sorted(cache.pods.items())
               if p.phase == PodPhase.PENDING and p.node_name is not None]
    for pod in started:
        cache.update_pod(pod)
    return {"evicted_deleted": deleted, "started_running": len(started)}


def add_arrivals(cache, n_pods: int, seed: int, tag: str) -> None:
    """``n_pods`` pending pods in new gangs of 4 over the cluster's
    queues, requests drawn like ``synthetic_cluster``'s; each PodGroup
    carries its pods' summed requests as MinResources."""
    rng = np.random.default_rng(seed)
    queues = sorted(cache.queues)
    cpu = rng.choice(CPU_CHOICES, n_pods)
    mem = rng.choice(MEM_CHOICES, n_pods)
    n_jobs = -(-n_pods // GANG)
    for j in range(n_jobs):
        lo, hi = j * GANG, min((j + 1) * GANG, n_pods)
        cache.add_pod_group(PodGroup(
            name=f"{tag}{j}", namespace="bench", min_member=hi - lo,
            queue=queues[j % len(queues)], creation_index=10**6 + j,
            min_resources={"cpu": float(cpu[lo:hi].sum()),
                           "memory": float(mem[lo:hi].sum())}))
    for i in range(n_pods):
        cache.add_pod(Pod(
            name=f"{tag}-t{i}", namespace="bench",
            requests={"cpu": float(cpu[i]), "memory": float(mem[i])},
            annotations={GROUP_NAME_ANNOTATION: f"{tag}{i // GANG}"},
            phase=PodPhase.PENDING, creation_index=10**6 + i))


def observed(cache) -> dict:
    """Binds, evictions and every task's (status, node): what two runs
    must share."""
    return {
        "binds": dict(cache.binder.binds),
        "evicts": list(cache.evictor.evicts),
        "tasks": {k: (int(t.status), t.node_name)
                  for job in cache.jobs.values() for k, t in job.tasks.items()},
    }


def run_cycles(cache, device, churn: Callable[[int], dict], ingest_s: float,
               keep_states: bool = False, profile: bool = False) -> dict:
    """Three cycles of the shipped conf on ``cache``; ``churn(c)`` runs
    before cycle ``c`` > 0 and returns what it did.  Returns the report."""
    sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()), device=device)
    actions = {a.name: a for a in sched.actions}
    allocate = actions["allocate"]
    cycles: List[dict] = []
    states: List[dict] = []
    n_evicts = 0
    for c in range(3):
        t = time.perf_counter()
        churned = kubelet(cache, cache.evictor.evicts[n_evicts:]) if c > 0 else {}
        n_evicts = len(cache.evictor.evicts)
        if c > 0:
            churned.update(churn(c))
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
        new_evicts = cache.evictor.evicts[n_evicts:]
        evict_check = eviction_checks(cache, sched, new_evicts)
        topk = allocate.last_topk
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
            cycle=c + 1, pending=pending, **churned, churn_s=churn_s, mode=mode,
            topk=topk, rounds=allocate.last_solve_rounds,
            new_binds=len(cache.binder.binds) - binds_before,
            binds=len(cache.binder.binds), new_evicts=len(new_evicts),
            evicts=len(cache.evictor.evicts),
            pipelined_claimants=actions["reclaim"].last_stats.get("pipelined", 0),
            reclaim=dict(actions["reclaim"].last_stats),
            preempt=dict(actions["preempt"].last_stats, committed=len(
                actions["preempt"].last_evictions)),
            enqueue=dict(path=actions["enqueue"].last_path,
                         gate_rows=actions["enqueue"].last_gate_rows),
            backfill=dict(actions["backfill"].last_placed),
            eviction_checks=evict_check, gangs_running=gangs,
            unplaced=unplaced, unschedulable=reasons[:3],
            fit_histogram=allocate.last_fit_histogram, fallback=allocate.last_fallback,
            wall_ms=wall_ms, stages_ms=dict(sched.last_cycle_ms),
            allocate_ms=dict(allocate.last_phase_ms), launches=launches,
            syncs=seen[0] if sched.device.type == "cuda" and not profile else None,
            invariants=inv))
        if profile:
            cycles[-1].update(seen)
        if keep_states:
            states.append(observed(cache))
    report = dict(device=str(sched.device), ingest_s=ingest_s, cycles=cycles)
    if keep_states:
        report["states"] = states
    return report


def drive(n_tasks: int, n_nodes: int, arrivals: int, host_ports_frac: float = 0.0,
          seed: int = 0, device=None, keep_states: bool = False,
          profile: bool = False) -> dict:
    """The headline drive (module docstring).  Returns the report; with
    ``keep_states`` it also carries each cycle's :func:`observed`, with
    ``profile`` each cycle's :func:`device_profile`."""
    t = time.perf_counter()
    cache = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES,
                              seed=seed, host_ports_frac=host_ports_frac)
    ingest_s = time.perf_counter() - t

    def churn(c: int) -> dict:
        if c == 1:
            add_arrivals(cache, arrivals, seed + 1, "arrive")
        return {}

    report = run_cycles(cache, device, churn, ingest_s, keep_states, profile)
    return dict(tasks=n_tasks, nodes=n_nodes, arrivals=arrivals,
                host_ports_frac=host_ports_frac, **report)


def drive_overcommit(n_running: int, n_pending: int, n_nodes: int, seed: int = 0,
                     device=None, keep_states: bool = False,
                     profile: bool = False) -> dict:
    """The overcommit drive (module docstring)."""
    t = time.perf_counter()
    cache = synthetic_overcommit_cluster(n_running=n_running, n_pending=n_pending,
                                         n_nodes=n_nodes, gang_size=GANG, seed=seed)
    ingest_s = time.perf_counter() - t
    report = run_cycles(cache, device, lambda c: {}, ingest_s, keep_states, profile)
    return dict(running=n_running, pending=n_pending, nodes=n_nodes, **report)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--overcommit", action="store_true")
    ap.add_argument("--tasks", type=int, default=50_000)
    ap.add_argument("--nodes", type=int, default=5_000)
    ap.add_argument("--arrivals", type=int, default=5_000)
    ap.add_argument("--host-ports-frac", type=float, default=0.0)
    ap.add_argument("--running", type=int, default=40_000)
    ap.add_argument("--pending", type=int, default=20_000)
    ap.add_argument("--device", default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if args.overcommit:
        out = drive_overcommit(args.running, args.pending, args.nodes,
                               device=args.device, profile=args.profile)
    else:
        out = drive(args.tasks, args.nodes, args.arrivals, args.host_ports_frac,
                    device=args.device, profile=args.profile)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
