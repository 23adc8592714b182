"""Drive the port's scheduling cycle the way a cluster does, and check it.

    python -m kube_batch_tpu_torch.testing.cycle_drive [--tasks 50000]
        [--nodes 5000] [--arrivals 5000] [--host-ports-frac 0.0]
        [--device cuda|cpu] [--profile]
    python -m kube_batch_tpu_torch.testing.cycle_drive --overcommit
        [--running 40000] [--pending 20000] [--nodes 5000] [--device ...]
    python -m kube_batch_tpu_torch.testing.cycle_drive --steady
        [--leg defaults|cold|noguard|oracle|pipelined] [--tasks 50000]
        [--nodes 5000] [--cycles 8] [--warmup 2] [--device ...]
    python -m kube_batch_tpu_torch.testing.cycle_drive --loop
        [--tasks 50000] [--nodes 5000] [--feed 20] [--period 1.0]
        [--device ...]

The first two drives run three cycles of ``Scheduler.run_once`` under
the shipped five-action conf (``enqueue, reclaim, allocate, backfill,
preempt``, ``config/kube-batch-tpu-conf.yaml``).  Before every cycle but
the first a kubelet pass deletes the pods the last cycle evicted and
starts the bound pods Running.

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

The steady-state drive (:func:`drive_steady`) is the counterpart of the
JAX package's ``bench.py`` ``multicycle_bench`` (and, delta leg against
oracle leg, ``run_multicycle_pair``): one cache built by
``synthetic_cluster(tasks, nodes, gang_size=4, n_queues=3)``, its axes
reserved for the wobble's ceiling, ``warmup`` + ``cycles`` back-to-back
cycles.  Before every cycle but the first the kubelet pass runs, then
2 % of the gangs whose pods are all bound complete (their pods and
PodGroup are deleted) and arrivals in gangs of 4 refill the pod count to
``tasks × (1 + 0.1·U(−1, 1))``.  ``--leg`` picks what is switched off:
``cold`` the warm candidate-table carry (``KB_WARM=0``), ``noguard`` the
guard plane (``KB_GUARD=0``), ``oracle`` the four
cross-cycle mechanisms together (``KB_SNAPSHOT_DELTA=0``,
``KB_DEVICE_CACHE=0``, ``KB_DELTA_CLOSE=0``, ``KB_WARM=0``); every leg
must decide identically.  The ``pipelined`` leg keeps the defaults but
runs each cycle through ``run_once_pipelined``: the cycle's status flush
and bind drain go to the writeback worker.  Before the checks and the
kubelet pass, which read acked bindings (``pod.node_name``), the drive
joins the bind drain with ``cache.flush_binds()`` (a real kubelet acts on
acked binds only), while the status flush goes on overlapping the churn
and the next cycle.  Each pipelined cycle reports its wall (barrier
included), the barrier's wait, that join, their sum (the number to set
beside a serial cycle's wall) and its writeback stage's own ms, timed on
the worker.  Every cycle of every drive also reports ``period_ms``, its
whole iteration (kubelet and churn, the cycle, the join, the checks): the
same work on every leg, so a writeback that only moved out of the
cycle's window, onto the untimed checks, still counts there.
``--steady --leg a,b,...`` runs the legs in that order in one process (an
A/B in one call: ``defaults,pipelined,pipelined,defaults``) and prints
each leg's line.

The loop drive (:func:`drive_loop`, the JAX package's ``bench.py``
``pipelined_bench``) runs ``Scheduler.run_forever`` on a thread over the
warmed ``synthetic_cluster(tasks, nodes)`` (shipped conf, two serial
cycles first), while a feeder thread posts ``feed`` single-pod gangs at
seeded offsets of U(0.15, 0.45) s; once with ``KB_PIPELINE=0`` (the
serial loop, a cycle every ``period`` s) and once pipelined (the event
trigger wakes a cycle per arrival burst).  A timing wrapper around the
fake binder stamps each bind's ack: it reports the arrival → bind-ack
latency (p50, p99, mean), the cycles run and why each woke, and checks
that every arrival was bound exactly once and that ``stop()`` drained
(an empty staging buffer, the writeback joined), and counts the kernel
launches of the loop's run (the warmup's excluded).

After each cycle the drive checks the column store against the object
model, every node's ``idle ≥ −quanta`` and ``used ≤ allocatable +
quanta``, that no pod was bound twice, and the evictions: every evicted
pod is a victim of a claim that reclaim or preempt carried out, the
victims cover their claimant's request, reclaim's victims are in another
queue than their claimant, and no gang was evicted below its
MinAvailable.  It records per cycle the stage times (open, each action,
close), the allocate phases, the reclaim and preempt solves' rounds and
ms, binds, evictions, pipelined claimants, kernel launches, (on the card)
host syncs, what stayed unplaced and why, the open and snapshot paths,
the churn, the resident cache's counters for the cycle, allocate's warm
plan record (``warm``) and the guard's counters for the cycle
(``guard``: sentinel verdicts read, trips, fail-closed solves, audits,
demoted paths), and a digest of
the decisions (binds, evictions, pipelined claimants, task statuses,
PodGroup phases).  A cycle is timed with the
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
import collections
import contextlib
import dataclasses
import gc
import hashlib
import itertools
import json
import os
import threading
import time
import warnings
from typing import Callable, Dict, List

import numpy as np
import torch

from kube_batch_tpu_torch.api.convert import host_field
from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Pod, PodGroup
from kube_batch_tpu_torch.api.resident import scatter_summary
from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.api.types import PodGroupPhase, PodPhase, TaskStatus
from kube_batch_tpu_torch.cache.fake import FakeBinder
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
#: the switches of the four cross-cycle mechanisms (delta open, resident
#: snapshot, delta close, warm candidate-table carry); all "0" is the oracle
ORACLE_SWITCHES = ("KB_SNAPSHOT_DELTA", "KB_DEVICE_CACHE", "KB_DELTA_CLOSE",
                   "KB_WARM")
#: the steady drive's legs: the switches each sets to "0" for its run
LEGS = {
    "defaults": (),
    "cold": ("KB_WARM",),
    "noguard": ("KB_GUARD",),
    "oracle": ORACLE_SWITCHES,
    "pipelined": (),
}


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
    """Binds, evictions, every task's (status, node) and every PodGroup's
    phase: what two runs must share."""
    return {
        "binds": dict(cache.binder.binds),
        "evicts": list(cache.evictor.evicts),
        "tasks": {k: (int(t.status), t.node_name)
                  for job in cache.jobs.values() for k, t in job.tasks.items()},
        "podgroups": {uid: None if job.pod_group.phase is None else job.pod_group.phase.value
                      for uid, job in cache.jobs.items() if job.pod_group is not None},
    }


def digest(state: dict, pipelined: int) -> str:
    """A short hash of :func:`observed`'s state and the cycle's pipelined
    claimants: two legs that decide alike print the same digest."""
    text = json.dumps([state, pipelined], sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


@contextlib.contextmanager
def switches_off(names):
    """Set the switches ``names`` to 0 for the block (the cache reads
    ``KB_SNAPSHOT_DELTA`` when it is made, the guard plane ``KB_GUARD``
    when it attaches), and restore the environment after it."""
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update({k: "0" for k in names})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def oracle_switches(oracle: bool):
    """With ``oracle``, the four cross-cycle switches at 0 for the block."""
    return switches_off(ORACLE_SWITCHES if oracle else ())


class SwapCheck:
    """Holds every swap of a cycle against a fresh upload of its host
    snapshot: ``on_swap`` (the column store's hook) keeps a copy of every
    host field and of every swapped tensor, and ``verify`` compares them
    after the cycle with ``torch.equal`` and raises on a difference."""

    def __init__(self):
        self.pending: List[tuple] = []
        self.swaps = 0
        self.ms = 0.0

    def on_swap(self, snap, out) -> None:
        t = time.perf_counter()
        self.pending.append(({n: host_field(n, getattr(snap, n)).copy()
                              for n in DeviceSnapshot._fields},
                             {n: getattr(out, n).clone() for n in DeviceSnapshot._fields}))
        self.swaps += 1
        self.ms += (time.perf_counter() - t) * 1e3

    def verify(self, where: str) -> int:
        for host, dev in self.pending:
            for name, arr in host.items():
                t = dev[name]
                if not torch.equal(t, torch.from_numpy(arr).to(t.device)):
                    fail(f"{where}: resident {name} differs from a fresh upload")
        n, self.pending = len(self.pending), []
        return n


def guard_counters(cache) -> dict:
    """The guard plane's lifetime counters and demoted paths ({} before it
    attaches)."""
    gp = getattr(cache, "guard_plane", None)
    if gp is None:
        return {}
    st = gp.state()
    return {"enabled": int(st["enabled"]), "verdicts": st["verdicts_consumed"],
            "trips": st["trips_total"], "failed_closed": st["failed_closed"],
            "audits": st["audits_run"], "audit_mismatches": st["audits_mismatched"],
            "demoted": sorted(n for n, p in st["paths"].items() if p["state"] != "healthy")}


def run_cycles(cache, device, churn: Callable[[int], dict], ingest_s: float,
               keep_states: bool = False, profile: bool = False,
               n_cycles: int = 3, check_swaps: bool = False,
               pipelined: bool = False) -> dict:
    """``n_cycles`` cycles of the shipped conf on ``cache``; ``churn(c)``
    runs before cycle ``c`` > 0 and returns what it did.  With
    ``check_swaps`` every resident swap is held against a fresh upload
    (:class:`SwapCheck`); with ``pipelined`` each cycle is
    ``run_once_pipelined`` (module docstring).  Returns the report."""
    sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()), device=device)
    try:
        return _run_cycles(sched, cache, churn, ingest_s, keep_states, profile,
                           n_cycles, check_swaps, pipelined)
    finally:
        sched.close()


def _run_cycles(sched, cache, churn, ingest_s, keep_states, profile, n_cycles,
                check_swaps, pipelined) -> dict:
    actions = {a.name: a for a in sched.actions}
    allocate = actions["allocate"]
    cols = cache.columns
    check = SwapCheck()
    cols.on_swap = check.on_swap if check_swaps else None
    cycles: List[dict] = []
    states: List[dict] = []
    n_evicts = 0
    for c in range(n_cycles):
        t = t_iter = time.perf_counter()
        churned = kubelet(cache, cache.evictor.evicts[n_evicts:]) if c > 0 else {}
        n_evicts = len(cache.evictor.evicts)
        if c > 0:
            churned.update(churn(c))
        churn_s = time.perf_counter() - t
        pending = int(cache.columns.schedulable_pending_mask().sum())
        binds_before = len(cache.binder.binds)
        resident_before = cols.resident_counters().get("single", {})
        guard_before = guard_counters(cache)
        check.ms, check.swaps = 0.0, 0
        kernels.reset_launches()
        gc.collect()
        gc.disable()
        try:
            watch = (device_profile(sched.device) if profile
                     else count_syncs(sched.device))
            with watch as seen:
                t = time.perf_counter()
                if pipelined:
                    sched.run_once_pipelined()
                else:
                    sched.run_once()
                if sched.device.type == "cuda":
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            overlap = None
            if pipelined:
                # the bind drain joined before anything reads acked state;
                # the status flush keeps overlapping the churn
                t = time.perf_counter()
                cache.flush_binds()
                join_ms = (time.perf_counter() - t) * 1e3
                overlap = dict(barrier_ms=sched.last_cycle_ms["writeback_barrier"],
                               join_ms=join_ms, wall_plus_join_ms=wall_ms + join_ms,
                               writeback_ms=None)
                if cycles:
                    # this cycle's barrier joined the previous writeback
                    cycles[-1]["overlap"]["writeback_ms"] = sched.last_writeback_ms
        finally:
            gc.enable()
        launches = dict(kernels.launches)
        swaps_checked = check.verify(f"cycle {c + 1}") if check_swaps else None
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
        resident = cols.resident_counters().get("single")
        if resident is not None:
            resident = scatter_summary({"single": {
                k: v - resident_before.get(k, 0) for k, v in resident.items()}})["single"]
        state = observed(cache)
        claimants = actions["reclaim"].last_stats.get("pipelined", 0)
        guard_after = guard_counters(cache)
        guard = {k: v - guard_before.get(k, 0) for k, v in guard_after.items()
                 if k not in ("enabled", "demoted")}
        guard.update(enabled=guard_after.get("enabled", 0),
                     demoted=guard_after.get("demoted", []))
        cycles.append(dict(
            cycle=c + 1, pending=pending, **churned, churn_s=churn_s, mode=mode,
            open_path=cache.last_open_path, snapshot_path=cols.last_snapshot_path,
            churn=cache.last_churn, resident=resident, swaps=check.swaps,
            swaps_checked=swaps_checked, swap_check_ms=check.ms,
            digest=digest(state, claimants),
            topk=topk, rounds=allocate.last_solve_rounds,
            warm=allocate.last_warm, guard=guard,
            new_binds=len(cache.binder.binds) - binds_before,
            binds=len(cache.binder.binds), new_evicts=len(new_evicts),
            evicts=len(cache.evictor.evicts),
            pipelined_claimants=claimants,
            reclaim=dict(actions["reclaim"].last_stats),
            preempt=dict(actions["preempt"].last_stats, committed=len(
                actions["preempt"].last_evictions)),
            enqueue=dict(path=actions["enqueue"].last_path,
                         gate_rows=actions["enqueue"].last_gate_rows),
            backfill=dict(actions["backfill"].last_placed),
            eviction_checks=evict_check, gangs_running=gangs,
            unplaced=unplaced, unschedulable=reasons[:3],
            fit_histogram=allocate.last_fit_histogram, fallback=allocate.last_fallback,
            wall_ms=wall_ms, stages_ms=dict(sched.last_cycle_ms), overlap=overlap,
            allocate_ms=dict(allocate.last_phase_ms), launches=launches,
            syncs=seen[0] if sched.device.type == "cuda" and not profile else None,
            invariants=inv))
        if profile:
            cycles[-1].update(seen)
        if keep_states:
            states.append(state)
        # the whole iteration: kubelet and churn, the cycle, the join and
        # the checks — the same work on every leg, so a writeback that
        # only moved out of the cycle's window still shows here
        cycles[-1]["period_ms"] = (time.perf_counter() - t_iter) * 1e3
    cols.on_swap = None
    if pipelined:
        sched.drain_pipeline()
        if cycles:
            cycles[-1]["overlap"]["writeback_ms"] = sched.last_writeback_ms
    # a writeback stage or a bind that raised is logged by the loop and
    # re-derived next cycle; a drive counts it as a failure
    if sched.failed_writebacks or cache.dispatch_failures or cache.resync.parked_total:
        fail(f"{sched.failed_writebacks} writeback stages and {cache.dispatch_failures} "
             f"bind dispatches failed, {cache.resync.parked_total} binds or evictions "
             "parked for resync")
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


def drive_steady(n_tasks: int, n_nodes: int, cycles: int = 8, warmup_cycles: int = 2,
                 churn_frac: float = 0.02, wobble: float = 0.1, seed: int = 0,
                 device=None, leg: str = "defaults", check_swaps: bool = False,
                 keep_states: bool = False, profile: bool = False) -> dict:
    """The steady-state drive (module docstring).  ``leg`` names the
    switches turned off for the run (:data:`LEGS`: ``defaults``, ``cold``
    — no warm carry, ``noguard`` — no guard, ``oracle`` — the four
    cross-cycle mechanisms off), or ``pipelined``: the defaults, each
    cycle through ``run_once_pipelined``;
    ``check_swaps`` holds every resident swap against a fresh upload;
    ``profile`` adds each cycle's :func:`device_profile`.  The report's
    ``steady`` holds the p50s over the cycles after the warmup."""
    with switches_off(LEGS[leg]):
        t = time.perf_counter()
        cache = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES,
                                  seed=seed)
        # the wobble's ceiling, reserved so the axes never grow mid-drive
        cache.columns.reserve(n_tasks=int(n_tasks * 1.15),
                              n_jobs=int(n_tasks / GANG * 1.15) + 8)
        ingest_s = time.perf_counter() - t
        rng = np.random.default_rng(seed)
        serial = itertools.count(1_000_000)

        def churn(c: int) -> dict:
            """bench.py's churn_step: complete churn_frac of the gangs
            whose pods are all bound, then refill to the wobbled count."""
            k = max(1, int(len(cache.jobs) * churn_frac))
            done = 0
            for uid, job in list(cache.jobs.items()):
                if done >= k:
                    break
                pods = [cache.pods.get(key) for key in job.tasks]
                if not pods or any(p is None or p.node_name is None for p in pods):
                    continue
                for p in sorted(pods, key=lambda p: p.name):
                    cache.delete_pod(p)
                cache.delete_pod_group(uid)
                done += 1
            want = int(n_tasks * (1.0 + wobble * float(rng.uniform(-1, 1))))
            arrived = 0
            while len(cache.pods) + GANG <= want:
                j = next(serial)
                cache.add_pod_group(PodGroup(name=f"mc{j}", namespace="bench",
                                             min_member=GANG, queue=f"q{j % N_QUEUES}",
                                             creation_index=j))
                for i in range(GANG):
                    cache.add_pod(Pod(
                        name=f"mc{j}-{i}", namespace="bench",
                        requests={"cpu": float(rng.choice(CPU_CHOICES)),
                                  "memory": float(rng.choice(MEM_CHOICES))},
                        annotations={GROUP_NAME_ANNOTATION: f"mc{j}"},
                        phase=PodPhase.PENDING, creation_index=j * 10 + i))
                arrived += GANG
            return {"completed_gangs": done, "arrived": arrived}

        report = run_cycles(cache, device, churn, ingest_s, keep_states, profile,
                            n_cycles=warmup_cycles + cycles, check_swaps=check_swaps,
                            pipelined=leg == "pipelined")
    steady = report["cycles"][warmup_cycles:]

    def p50(values) -> float:
        return float(np.percentile(values, 50)) if values else 0.0

    report["steady"] = {
        "open_plus_snapshot_build_ms_p50": p50(
            [c["stages_ms"]["open"] + c["allocate_ms"].get("snapshot_build", 0.0)
             for c in steady]),
        "wall_ms_p50": p50([c["wall_ms"] for c in steady]),
        "solve_ms_p50": p50([c["allocate_ms"].get("solve", 0.0) for c in steady]),
        "close_ms_p50": p50([c["stages_ms"]["close"] for c in steady]),
        "period_ms_p50": p50([c["period_ms"] for c in steady]),
        "open_paths": [c["open_path"] for c in steady],
    }
    if leg == "pipelined":
        for key in ("barrier_ms", "join_ms", "wall_plus_join_ms", "writeback_ms"):
            report["steady"][key + "_p50"] = p50(
                [c["overlap"][key] for c in steady if c["overlap"][key] is not None])
    return dict(tasks=n_tasks, nodes=n_nodes, leg=leg, warmup_cycles=warmup_cycles,
                **report)


class TimedBinder(FakeBinder):
    """The fake binder with an ack clock: ``acked_at`` holds, per pod key,
    the ``time.perf_counter()`` of its first ack; ``all_acked`` is set
    once every key of :meth:`expect` is acked."""

    def __init__(self):
        super().__init__()
        self.acked_at: Dict[str, float] = {}
        self.all_acked = threading.Event()
        self._expected: set = set()

    def expect(self, keys) -> None:
        self._expected = set(keys)

    def _stamp(self, keys) -> None:
        t = time.perf_counter()
        for k in keys:
            self.acked_at.setdefault(k, t)
        if self._expected and self._expected.issubset(self.acked_at):
            self.all_acked.set()

    def bind(self, pod, hostname: str) -> None:
        super().bind(pod, hostname)
        self._stamp([pod.key()])

    def bind_many(self, pairs) -> None:
        super().bind_many(pairs)
        self._stamp([pod.key() for pod, _h in pairs])


def drive_loop(n_tasks: int, n_nodes: int, feed: int = 20, period: float = 1.0,
               seed: int = 0, device=None, warmup_cycles: int = 2) -> dict:
    """The loop drive (module docstring): the serial loop and the pipelined
    loop over the same warmed cluster shape and the same seeded arrival
    stream.  Returns one report per mode; any failed check raises."""
    offsets = np.random.default_rng(seed).uniform(0.15, 0.45, size=feed)
    return {"tasks": n_tasks, "nodes": n_nodes, "feed": feed, "period_s": period,
            "offsets_s": offsets.tolist(),
            "serial": _loop_mode(False, n_tasks, n_nodes, offsets, period, seed,
                                 device, warmup_cycles),
            "pipelined": _loop_mode(True, n_tasks, n_nodes, offsets, period, seed,
                                    device, warmup_cycles)}


def _loop_mode(pipelined: bool, n_tasks, n_nodes, offsets, period, seed, device,
               warmup_cycles) -> dict:
    t = time.perf_counter()
    cache = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES,
                              seed=seed)
    ingest_s = time.perf_counter() - t
    n_feed = len(offsets)
    cache.columns.reserve(n_tasks=n_tasks + GANG * n_feed,
                          n_jobs=n_tasks // GANG + GANG * n_feed)
    sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()),
                      schedule_period=period, device=device)
    # as bench.py's pipelined_bench: the mode set on the scheduler, and a
    # 20 ms starting floor, which then follows the measured cycle cost
    sched.pipelined, sched.min_period, sched.max_period = pipelined, 0.02, period
    binder = TimedBinder()
    cycles: List[dict] = []
    loop = feeder = None
    try:
        for _ in range(warmup_cycles):
            sched.run_once()
        warm_binds = len(cache.binder.binds)
        cache.binder = binder
        keys = [f"feed/arr{i}-0" for i in range(n_feed)]
        binder.expect(keys)
        arrived: Dict[str, float] = {}

        def on_cycle_end():
            cycles.append(dict(stages_ms=dict(sched.last_cycle_ms),
                               writeback_ms=sched.last_writeback_ms))

        sched.on_cycle_end = on_cycle_end

        def feed_arrivals():
            for i, dt in enumerate(offsets):
                time.sleep(float(dt))
                name = f"arr{i}"
                arrived[keys[i]] = time.perf_counter()
                cache.add_pod_group(PodGroup(name=name, namespace="feed", min_member=1,
                                             queue="q0", creation_index=5_000_000 + i))
                cache.add_pod(Pod(name=f"{name}-0", namespace="feed",
                                  requests={"cpu": 250.0, "memory": float(2 ** 30)},
                                  annotations={GROUP_NAME_ANNOTATION: name},
                                  phase=PodPhase.PENDING, creation_index=50_000_000 + i))

        loop = threading.Thread(target=sched.run_forever, name="kb-loop", daemon=True)
        feeder = threading.Thread(target=feed_arrivals, name="kb-feed", daemon=True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        loop.start()
        feeder.start()
        feeder.join(timeout=float(offsets.sum()) + 60.0)
        if feeder.is_alive():
            fail("loop: the feeder did not finish")
        all_bound = binder.all_acked.wait(timeout=6 * period + 10.0)
    finally:
        sched.stop()
        if loop is not None:
            loop.join(timeout=60.0)
    run_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if loop.is_alive():
        fail("loop: run_forever did not stop within 60 s")
    with cache._ingest_lock:
        staged_left = len(cache._ingest_staged)
    writeback_joined = sched._wb_future is None and sched._wb_worker is None
    if staged_left or not writeback_joined:
        fail(f"loop: stop() left {staged_left} staged events, writeback joined "
             f"{writeback_joined}")
    if not all_bound:
        fail(f"loop: {len(binder.acked_at)} of {n_feed} arrivals bound")
    counts = collections.Counter(binder.channel)
    if any(counts[k] != 1 for k in keys) or len(counts) != n_feed:
        fail(f"loop: arrivals not bound exactly once: {dict(counts)}")
    if (sched.failed_cycles or sched.failed_writebacks or cache.dispatch_failures
            or cache.resync.parked_total):
        fail(f"loop: {sched.failed_cycles} cycles, {sched.failed_writebacks} writeback "
             f"stages and {cache.dispatch_failures} bind dispatches failed, "
             f"{cache.resync.parked_total} parked")
    errs = cache.columns.check_consistency(cache)
    if errs:
        fail(f"loop: column store disagrees with objects: {errs[:5]}")
    lat = sorted((binder.acked_at[k] - arrived[k]) * 1e3 for k in keys)
    wb = [c["writeback_ms"] for c in cycles if c["writeback_ms"] is not None]
    return dict(mode="pipelined" if pipelined else "serial", ingest_s=ingest_s,
                warm_binds=warm_binds, run_s=run_s, bound=len(binder.acked_at),
                latency_ms=dict(p50=float(np.percentile(lat, 50)),
                                p99=float(np.percentile(lat, 99)),
                                mean=float(np.mean(lat)), max=lat[-1]),
                cycles=len(cycles),
                wakes=dict(sched.wake_reasons) if pipelined else {"tick": len(cycles)},
                cycle_ms_p50=float(np.percentile(
                    [sum(c["stages_ms"].values()) for c in cycles], 50)) if cycles else None,
                stages_ms_p50={k: float(np.percentile(
                    [c["stages_ms"].get(k, 0.0) for c in cycles], 50))
                    for k in (cycles[-1]["stages_ms"] if cycles else ())},
                writeback_ms_p50=float(np.percentile(wb, 50)) if wb else None,
                staged_left=staged_left, writeback_joined=writeback_joined,
                launches=launches, device=str(sched.device))


def drive_guard(n_tasks: int, n_nodes: int, arrivals: int, bundle_dir: str,
                cooldown: int = 2, seed: int = 0, device=None) -> dict:
    """The guard plane's drive (shipped conf, ``synthetic_cluster(n_tasks,
    n_nodes)``, ``arrivals`` new pods in gangs of 4 before every cycle but
    the first, the kubelet pass before every cycle but the first), with
    ``KB_AUDIT_EVERY=1`` and ``KB_GUARD_COOLDOWN=cooldown``:

    1. clean cycles: every engaged allocate dispatch is audited against
       the full solve, with no mismatch and no trip;
    2. one live node's word of the resident ``node_alloc`` is zeroed in
       place: that cycle fails closed (no new bind), the trip names
       ``node_overcommit`` and demotes ``topk`` and ``warm``, a bundle is
       written to ``bundle_dir``; the next cycle binds, and after
       ``cooldown`` clean cycles the half-open probe re-promotes both;
    3. a Running row's resident ``task_pending`` bit is set (its mirror
       kept at the host's truth) before a cycle whose swaps scatter: the
       host eligibility checksum trips, and no Running pod is bound
       again;
    4. the step-2 bundle replays on ``device`` and on the CPU: the
       overcommit is reproduced, identically, and the snapshot with the
       zeroed word restored from the host passes the sentinel.

    Raises on any failed check; returns the report."""
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
    from kube_batch_tpu_torch.guard import guard_of
    from kube_batch_tpu_torch.guard.bundle import _rebuild_config, load_bundle, replay_bundle
    from kube_batch_tpu_torch.ops.invariants import allocate_sentinel_solve

    knobs = {"KB_AUDIT_EVERY": "1", "KB_GUARD_COOLDOWN": str(cooldown)}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        cache = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES,
                                  seed=seed)
        cache.columns.reserve(n_tasks=n_tasks + 12 * arrivals,
                              n_jobs=(n_tasks + 12 * arrivals) // GANG + 8)
        sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()),
                          device=device)
        gp = guard_of(cache)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    gp.bundle_dir = bundle_dir
    allocate = next(a for a in sched.actions if a.name == "allocate")
    cols = cache.columns
    dev = sched.device
    log: List[dict] = []
    n_evicts = [0]

    def cycle(tag: str, plant=None, n_arrivals: int = arrivals) -> dict:
        """One cycle after the churn; ``plant()`` runs between the churn
        and the cycle (a fault planted there meets the cycle's swaps)."""
        c = len(log)
        if c > 0:
            kubelet(cache, cache.evictor.evicts[n_evicts[0]:])
            n_evicts[0] = len(cache.evictor.evicts)
            add_arrivals(cache, n_arrivals, seed + 100 + c, f"guard{c}-")
        if plant is not None:
            plant()
        before = dict(binds=len(cache.binder.binds), trips=gp.trips_total,
                      audits=gp.audits_run, verdicts=gp.verdicts_consumed)
        channel = len(cache.binder.channel)
        sched.run_once()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        errs = cols.check_consistency(cache)
        if errs:
            fail(f"guard {tag}: column store disagrees with objects: {errs[:3]}")
        ch = cache.binder.channel
        if len(set(ch)) != len(ch):
            fail(f"guard {tag}: a pod was bound twice")
        rec = dict(cycle=c + 1, tag=tag, new_binds=len(cache.binder.binds) - before["binds"],
                   binds_dispatched=len(ch) - channel,
                   trips=gp.trips_total - before["trips"],
                   audits=gp.audits_run - before["audits"],
                   verdicts=gp.verdicts_consumed - before["verdicts"],
                   topk=allocate.last_topk is not None, warm=allocate.last_warm,
                   paths={k: p.state for k, p in gp.paths.items() if k in ("topk", "warm")})
        log.append(rec)
        return rec

    # 1. clean cycles, every engaged allocate dispatch audited
    for tag in ("clean-full", "clean-compacted", "clean-warm"):
        cycle(tag)
    if gp.trips_total or gp.audits_mismatched:
        fail(f"guard: clean cycles tripped ({gp.trip_log})")
    if gp.audits_run < 2 or not any(r["warm"] for r in log):
        fail(f"guard: {gp.audits_run} audits, warm {[r['warm'] for r in log]}")
    audits_clean = gp.audits_run

    # 2. a zeroed capacity word in the resident node_alloc
    live = int(np.flatnonzero(cols.n_valid)[0])
    _ver, alloc_t = cols._dev_cache[dev]["node_alloc"]
    alloc_t[live] = 0.0
    rec = cycle("corrupt-node-alloc")
    trip = gp.trip_log[-1] if gp.trip_log else {}
    if rec["trips"] != 1 or rec["new_binds"] != 0 or rec["binds_dispatched"] != 0:
        fail(f"guard: the corrupted cycle did not fail closed: {rec}")
    if "node_overcommit" not in trip.get("detail", "") or \
            sorted(trip.get("demoted", [])) != ["topk", "warm"]:
        fail(f"guard: trip {trip}")
    if not gp.bundles or cols._warm_tables:
        fail("guard: no bundle, or the heal kept the carried table")
    bundle = gp.bundles[-1]
    rec = cycle("healed")
    if rec["new_binds"] == 0 or rec["trips"] or rec["topk"]:
        fail(f"guard: the healed cycle {rec}")
    while gp.paths["topk"].state != "healthy" or gp.paths["warm"].state != "healthy":
        if len(log) > 8 + cooldown:
            fail(f"guard: no re-promotion after {cooldown} clean cycles: {log[-3:]}")
        rec = cycle("cooldown")
        if rec["trips"]:
            fail(f"guard: a cooldown cycle tripped: {gp.trip_log[-1]}")
    if gp.paths["topk"].promotions != 1 or gp.paths["warm"].promotions != 1:
        fail(f"guard: promotions {gp.state()['paths']}")

    # 3. a phantom pending bit on a Running row, planted after the churn
    # (the row is still a Running pod's when the cycle swaps) in a cycle of
    # few arrivals: a task delta too wide to scatter uploads the column in
    # full, which rewrites the planted bit before any solve reads it
    running = {}

    def phantom():
        running.update((k, p.node_name) for k, p in cache.pods.items()
                       if p.phase == PodPhase.RUNNING)
        r = int(np.flatnonzero(cols.t_valid & (cols.t_status == int(TaskStatus.RUNNING)))[0])
        rc = cols._per_cycle_dev[dev]
        rc._dev["task_pending"][r] = True
        rc._mirror["task_pending"][r] = False

    trips = gp.trips_total
    rec = cycle("phantom-pending", phantom, n_arrivals=GANG * max(1, arrivals // 64))
    trip = gp.trip_log[-1] if gp.trip_log else {}
    if gp.trips_total != trips + 1 or "eligibility" not in trip.get("detail", ""):
        fail(f"guard: the phantom pending bit did not trip the checksum: {rec} {trip}")
    rebound = [k for k, node in running.items() if cache.binder.binds.get(k) != node]
    if rebound:
        fail(f"guard: Running pods bound again: {rebound[:3]}")

    # 4. the bundle replays: the card and the CPU agree, twice
    replays = [replay_bundle(bundle, dev), replay_bundle(bundle, dev),
               replay_bundle(bundle, "cpu")]
    rep = replays[0]
    if not rep["reproduced"] or "node_overcommit" not in rep["fast_violations"] \
            or rep["fast_vs_oracle_mismatches"]:
        fail(f"guard: the bundle replay {rep}")
    strip = ("bundle", "device")
    same = [{k: v for k, v in r.items() if k not in strip} for r in replays]
    if same[1] != same[0] or same[2] != same[0]:
        fail("guard: the bundle replays differ between runs or devices")
    snap, meta, _rows = load_bundle(bundle)
    fixed = snap._replace(node_alloc=cols.n_alloc32.copy())
    _res, verdict, _h, _e = allocate_sentinel_solve(snapshot_from_numpy(fixed, dev),
                                                    _rebuild_config(meta)[0])
    if int(verdict) != 0:
        fail(f"guard: the restored snapshot still fails its sentinel ({int(verdict)})")
    return dict(tasks=n_tasks, nodes=n_nodes, arrivals=arrivals, cooldown=cooldown,
                audits_clean=audits_clean, cycles=log, guard=gp.state(),
                trip_log=gp.trip_log, replay=rep, restored_verdict=int(verdict),
                device=str(dev))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--overcommit", action="store_true")
    ap.add_argument("--steady", action="store_true")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--feed", type=int, default=20)
    ap.add_argument("--period", type=float, default=1.0)
    ap.add_argument("--leg", default="defaults",
                    help="a leg of LEGS, or several, comma-separated, run in order")
    ap.add_argument("--cycles", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--tasks", type=int, default=50_000)
    ap.add_argument("--nodes", type=int, default=5_000)
    ap.add_argument("--arrivals", type=int, default=5_000)
    ap.add_argument("--host-ports-frac", type=float, default=0.0)
    ap.add_argument("--running", type=int, default=40_000)
    ap.add_argument("--pending", type=int, default=20_000)
    ap.add_argument("--device", default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if args.loop:
        out = drive_loop(args.tasks, args.nodes, args.feed, args.period,
                         device=args.device)
    elif args.steady:
        legs = args.leg.split(",")
        unknown = sorted(set(legs) - set(LEGS))
        if unknown:
            ap.error(f"unknown legs {unknown}; choose from {sorted(LEGS)}")
        for leg in legs[:-1]:
            print(json.dumps(drive_steady(args.tasks, args.nodes, args.cycles,
                                          args.warmup, device=args.device, leg=leg,
                                          profile=args.profile)), flush=True)
        out = drive_steady(args.tasks, args.nodes, args.cycles, args.warmup,
                           device=args.device, leg=legs[-1], profile=args.profile)
    elif args.overcommit:
        out = drive_overcommit(args.running, args.pending, args.nodes,
                               device=args.device, profile=args.profile)
    else:
        out = drive(args.tasks, args.nodes, args.arrivals, args.host_ports_frac,
                    device=args.device, profile=args.profile)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
