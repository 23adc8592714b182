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
    python -m kube_batch_tpu_torch.testing.cycle_drive --features
        [--tasks 50000] [--nodes 5000] [--device ...]
    python -m kube_batch_tpu_torch.testing.cycle_drive --whatif
        [--tasks 50000] [--nodes 5000] [--device ...] [--profile]
    python -m kube_batch_tpu_torch.testing.cycle_drive --replicate
        [--tasks 50000] [--nodes 5000] [--device ...]
    python -m kube_batch_tpu_torch.testing.cycle_drive --replicate-cost
        [--tasks 50000] [--nodes 5000] [--device ...]

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

The feature drive (:func:`drive_features`) builds the headline cluster
with PodDisruptionBudget gangs, claims on a PV ledger and on missing PVs
(``synthetic_cluster``'s feature options), adds a custom score row
(:func:`rack_affinity_row`, through a plugin's ``add_score_row``) to the
shipped conf, and runs two exclusive cycles and one isolated
(:func:`isolated_cycle`) with new PDB gangs, claims and plain gangs
arrived for it to place; it checks the PDB gangs and the PV ledger after
each (:func:`feature_checks`) and can hold K1 and K2 against their plain
versions on cycle 1's plane (:func:`hold_kernels`).

The what-if drive (:func:`drive_whatif`) runs the read plane on
:func:`whatif_cluster` (the headline cluster with one node filled by
evictable single-pod jobs, every pending pod deleted, a lease
published): K1 held at a probe gang's explicit rows
(:func:`hold_k1_rows`), a flush of 32 gangs timed without and with
evictions (:func:`whatif_flush`), the oracle contract gang by gang
(:func:`whatif_oracle`: each probed gang is submitted alone and must
bind at exactly its probed nodes, or evict exactly its probed victims),
16 clients served beside three steady cycles (:func:`whatif_serving`),
and on the card the same requests answered identically on the card and
the CPU at 4 096 × 1 024 (:func:`whatif_cross_device`).

The replicate drive (:func:`drive_replicate`) runs the steady drive's
cluster and churn twice with a query plane attached, both legs through
the same loop and per-cycle checks as every drive: without a publisher,
then with a ``ReplicationPublisher`` (a ring of 4) and a follower on the
same device pulling in process (:class:`ReplicaCheck`, the loop's
per-cycle hook).  :data:`REPLICATE_PLAN` says what the follower does in
each steady cycle.  In the cycles it follows, every record is pulled and
applied before the leader's next swap (the check rides the swap guard),
and four gangs (one with evictions) and a sweep go to both planes: the
answers must be equal, staleness included.  In the others the publisher
runs alone and the follower catches up after the cycle's wall.  One
frame is dropped (the next delta must be refused, the full frame after
it adopted warm, uploading only what changed), the follower sits a cycle
out so that its next catch-up is past the ring (it must get a full
frame), and the pull loop restarts (``revalidate_resident`` must say
warm).  On CUDA, :func:`replicate_cross_device` then feeds a card
follower and a CPU follower the frames of a ``WHATIF_MID`` leader; both
must answer 32 requests as the leader does.  It reports records per
cycle, frame bytes, the publisher's and the follower's times, uploads,
lag, probe times, the follower's K1 launches and the two legs' walls on
the same churn: the publisher's cost in the cycles where it ran alone,
and a lower bound in the followed ones (the checks' time, and the
encode they join, taken out of the wall).  :func:`replicate_cost` runs
the legs as two pairs in either order and reads the cost alone.

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
from kube_batch_tpu_torch.api.resident import PER_CYCLE_FIELDS, scatter_summary
from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.api.types import PodGroupPhase, PodPhase, TaskStatus
from kube_batch_tpu_torch.cache.fake import FakeBinder
from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.ops import kernels
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing.synthetic import (
    CPU_CHOICES,
    MEM_CHOICES,
    NODE_CPU,
    synthetic_cluster,
    synthetic_overcommit_cluster,
)

GANG = 4
N_QUEUES = 3
#: the feature drive's cycles: two exclusive, then one isolated
FEATURE_PLAN = ("exclusive", "exclusive", "isolated")
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


def isolated_cycle(sched, stages: Dict[str, float] = None):
    """One cycle of ``sched``'s actions in an isolated session
    (``open_session(..., isolated=True)``: ``cache.snapshot()`` clones, the
    objects' branches, the object snapshot), closed and its binds joined,
    the counterpart of the JAX package's isolated session driven the same
    way.  ``stages`` receives the wall ms of open (the clone included),
    clone, each action and close.  Returns the closed session."""
    from kube_batch_tpu_torch.framework.session import close_session, open_session

    cache = sched.cache
    t0 = time.perf_counter()
    ssn = open_session(cache, sched.conf.tiers, sched.device, isolated=True)
    ssn.action_names = [a.name for a in sched.actions]
    if stages is not None:
        stages["open"] = (time.perf_counter() - t0) * 1e3
        stages["clone"] = ssn.clone_ms
    for action in sched.actions:
        ta = time.perf_counter()
        action.execute(ssn)
        if stages is not None:
            stages["action:" + action.name] = (time.perf_counter() - ta) * 1e3
    tc = time.perf_counter()
    close_session(ssn)
    cache.flush_binds()
    if stages is not None:
        stages["close"] = (time.perf_counter() - tc) * 1e3
    return ssn


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


def add_feature_arrivals(cache, n_pods: int, seed: int, tag: str) -> None:
    """``n_pods`` pending pods in new gangs of 4 carrying the feature
    drive's inputs, requests drawn like ``synthetic_cluster``'s: every
    fourth gang (from the first) is defined by a PodDisruptionBudget
    (owner-linked pods in the default queue, every second of these with a
    member asking for twice a node's cpu, so it binds nothing); the gang
    after each PDB gang claims one new wildcard PV per pod from the
    cache's ledger; the rest are plain PodGroup gangs."""
    from kube_batch_tpu_torch.api.pod import PersistentVolume, PodDisruptionBudget

    rng = np.random.default_rng(seed)
    queues = sorted(q for q in cache.queues if q != cache.default_queue)
    cpu = rng.choice(CPU_CHOICES, n_pods)
    mem = rng.choice(MEM_CHOICES, n_pods)
    for j in range(-(-n_pods // GANG)):
        lo, hi = j * GANG, min((j + 1) * GANG, n_pods)
        pdb, claims = j % 4 == 0, j % 4 == 1
        if pdb:
            cache.add_pdb(PodDisruptionBudget(
                name=f"{tag}pdb{j}", namespace="bench", min_available=hi - lo,
                owner=f"rs-{tag}{j}", creation_index=10**6 + j))
        else:
            cache.add_pod_group(PodGroup(
                name=f"{tag}{j}", namespace="bench", min_member=hi - lo,
                queue=queues[j % len(queues)], creation_index=10**6 + j))
        for i in range(lo, hi):
            if claims:
                cache.volume_binder.add_pv(PersistentVolume(name=f"pv-{tag}{i}"))
            cache.add_pod(Pod(
                name=f"{tag}-t{i}", namespace="bench",
                requests={"cpu": 2 * NODE_CPU if pdb and j % 8 == 4 and i == lo
                          else float(cpu[i]), "memory": float(mem[i])},
                annotations={} if pdb else {GROUP_NAME_ANNOTATION: f"{tag}{j}"},
                owner=f"rs-{tag}{j}" if pdb else None,
                phase=PodPhase.PENDING, creation_index=10**6 + i,
                volume_claims=(f"claim-{tag}{i}",) if claims else ()))


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
                check_swaps, pipelined, hook=None) -> dict:
    """The loop of :func:`run_cycles` on ``sched``.  ``hook`` (the replicate
    drive's :class:`ReplicaCheck`) gets ``before(c)`` ahead of cycle ``c``
    and ``after(c)`` once its wall is read; ``after`` returns the ms the
    hook spent inside the cycle, which are taken out of its wall."""
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
        if hook is not None:
            hook.before(c)
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
        if hook is not None:
            wall_ms -= hook.after(c)
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


def reserve_wobble(cache, n_tasks: int) -> None:
    """Reserve the steady churn's ceiling, so the axes never grow mid-drive."""
    cache.columns.reserve(n_tasks=int(n_tasks * 1.15),
                          n_jobs=int(n_tasks / GANG * 1.15) + 8)


def steady_churn(cache, n_tasks: int, seed: int = 0, churn_frac: float = 0.02,
                 wobble: float = 0.1) -> Callable[[int], dict]:
    """bench.py's churn_step as ``churn(c)``: complete ``churn_frac`` of the
    gangs whose pods are all bound, then refill with gangs of 4 to
    ``n_tasks × (1 + wobble·U(−1, 1))`` pods."""
    rng = np.random.default_rng(seed)
    serial = itertools.count(1_000_000)

    def churn(c: int) -> dict:
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

    return churn


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
        reserve_wobble(cache, n_tasks)
        ingest_s = time.perf_counter() - t
        churn = steady_churn(cache, n_tasks, seed, churn_frac, wobble)
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


def rack_affinity_row(snap):
    """A custom score row of the JAX package's test row's form (a [T, N]
    preference read off the node index, ``tests/test_allocate_solve.py``
    ``_prefer_last_node_row``), per task class: a task asking for m GiB of
    memory prefers the nodes whose index is m modulo 8 (a rack of an
    eighth of the cluster).  Unlike the test's prefer-the-last-node row it
    keeps the gangs spread — every task of a round preferring one node
    would serialize the bidding.  Module level, as
    ``Session.add_score_row`` asks; it reads only snapshot fields, so the
    compacted solve's row-gathered view gets the same rows."""
    N = snap.node_alloc.shape[0]
    rack = torch.arange(N, device=snap.node_alloc.device) % 8
    want = (snap.task_req[:, 1] / (2.0 ** 30)).to(torch.int64) % 8
    return ((rack[None, :] == want[:, None]) & snap.node_valid[None, :]).to(torch.float32)


class RackAffinityPlugin(Plugin):
    """A plugin that registers :func:`rack_affinity_row` (weight 1, beside
    the built-in 0..10 rows) on every session."""

    name = "rack-affinity"

    def on_session_open(self, ssn) -> None:
        ssn.add_score_row("rack-affinity", rack_affinity_row, weight=1.0)


def features_conf():
    """The shipped conf with :class:`RackAffinityPlugin` in its last tier
    (registered on first use)."""
    from kube_batch_tpu_torch.framework.conf import PluginOption
    from kube_batch_tpu_torch.framework.interface import register_plugin_builder

    register_plugin_builder(RackAffinityPlugin.name, RackAffinityPlugin)
    conf = load_scheduler_conf(shipped_conf_path())
    conf.tiers[-1].plugins.append(PluginOption(name=RackAffinityPlugin.name))
    return conf


def feature_checks(cache) -> Dict[str, int]:
    """The PDB gang and PV ledger invariants after a cycle; raises on a
    violation.  Every PDB gang is bound all or nothing; no PV is reserved
    or bound twice, and none is reserved after the cycle; every bound pod
    with a claim sits on a node its PV reaches; no claim on a missing PV
    is bound."""
    allocated = (TaskStatus.BINDING, TaskStatus.BOUND, TaskStatus.RUNNING,
                 TaskStatus.ALLOCATED)
    pdb_bound = pdb_blocked = 0
    for uid, job in cache.jobs.items():
        if job.pdb is None:
            continue
        n = job.task_num(*allocated)
        if 0 < n < job.min_available:
            fail(f"PDB gang {uid} bound {n} of {job.min_available}")
        pdb_bound += n >= job.min_available
        pdb_blocked += n == 0
    vb = cache.volume_binder
    bound = list(vb.bound.values())
    reserved = [pv for res in vb.reservations.values() for pv in res.values()]
    if len(set(bound)) != len(bound) or set(bound) & set(reserved):
        fail("a PV is bound twice")
    if reserved:
        fail(f"{len(reserved)} PV reservations outlived the cycle")
    with_claims = impossible = 0
    for key, node in cache.binder.binds.items():
        pod = cache.pods.get(key)
        if pod is None or not pod.volume_claims:
            continue
        with_claims += 1
        for claim in pod.volume_claims:
            pv = vb.pvs.get(vb.bound.get(claim, ""))
            if pv is None:
                fail(f"{key} bound without a PV for {claim}")
            if not vb._reachable(pv, node):
                fail(f"{key} bound on {node}, which its PV {pv.name} does not reach")
    for pod in cache.pods.values():
        if any(vb.bound.get(c, "").startswith("pv-gone") for c in pod.volume_claims):
            impossible += 1
            if pod.key() in cache.binder.binds:
                fail(f"{pod.key()} bound with a claim on a missing PV")
    return {"pdb_gangs_bound": pdb_bound, "pdb_gangs_blocked": pdb_blocked,
            "pvs_bound": len(bound), "bound_pods_with_claims": with_claims,
            "impossible_claims_unbound": impossible}


def hold_kernels(dev, config) -> Dict[str, dict]:
    """K1 and K2 against their plain versions on a solve's device snapshot
    ``dev`` and its score plane under ``config.weights`` (custom rows
    included): K1 over every row, K2 over up to 8 192 pending rows (a
    compacted cycle's table).
    Every output must be bit-exact; raises otherwise.  On CPU tensors
    both sides are the plain versions."""
    from kube_batch_tpu_torch.ops.feasibility import static_predicates
    from kube_batch_tpu_torch.ops.kernels import (
        NEG,
        masked_best_node_raw_plain,
        masked_topk_blocks_plain,
    )
    from kube_batch_tpu_torch.ops.scoring import score_matrix

    score = score_matrix(dev, config.weights)
    static_ok = static_predicates(dev)
    k1_args = (score, static_ok, dev.task_req, dev.node_idle, dev.node_releasing,
               dev.task_pending, dev.quanta)
    rows = torch.nonzero(dev.task_pending).flatten()[:8192].to(torch.int32)
    score_static = torch.where(static_ok, score, NEG)[rows.long()]
    k2_args = (score_static, dev.task_req[rows.long()], dev.node_idle, dev.node_releasing,
               rows, dev.quanta)
    out = {}
    for name, kernel, plain, args in (
            ("K1", kernels.masked_best_node_raw, masked_best_node_raw_plain, k1_args),
            ("K2", kernels.masked_topk_blocks, masked_topk_blocks_plain, k2_args)):
        got, want = kernel(*args), plain(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                fail(f"{name} output {i} differs from its plain version on the plane "
                     "with the custom row")
        out[name] = {"shape": list(args[0].shape), "max_abs_err": 0.0}
    return out


def drive_features(n_tasks: int, n_nodes: int, pvc_pods: int, pvc_impossible: int,
                   pdb_gang_frac: float = 0.05, seed: int = 0, device=None,
                   hold_first: bool = False, keep_states: bool = False) -> dict:
    """The feature drive: ``synthetic_cluster(n_tasks, n_nodes,
    gang_size=4, n_queues=3)`` with ``pdb_gang_frac`` of its gangs defined
    by PodDisruptionBudgets, ``pvc_pods`` claims on a PV ledger and
    ``pvc_impossible`` claims on missing PVs, under the shipped conf plus a
    custom score row (:func:`features_conf`), one cycle per
    :data:`FEATURE_PLAN` entry: ``Scheduler.run_once`` for "exclusive",
    :func:`isolated_cycle` for "isolated".  The exclusive cycles bind all
    that fits, so before the isolated cycle about ``n_tasks / 32`` pods
    arrive (:func:`add_feature_arrivals`: PDB gangs, claims on new PVs,
    plain gangs) for its decisions to place.  After every cycle
    :func:`feature_checks`, the column
    store, the node ledgers and double binds are checked.  With
    ``hold_first`` the first cycle's allocate solve input is kept and K1
    and K2 are held against their plain versions on it
    (:func:`hold_kernels`), after that cycle's launches were read.  Each
    cycle records its wall by stage, allocate's phases (``snapshot_build``
    is the object snapshot on an isolated cycle), the clone ms, binds,
    the jobs the volume pre-check demoted, kernel launches and (on the
    card) host syncs; with ``keep_states`` also :func:`observed`, the
    event record (sorted) and the PV ledger."""
    from kube_batch_tpu_torch.actions import allocate as allocate_mod

    t = time.perf_counter()
    cache = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES, seed=seed,
                              pdb_gang_frac=pdb_gang_frac, pvc_pods=pvc_pods,
                              pvc_impossible=pvc_impossible)
    ingest_s = time.perf_counter() - t
    sched = Scheduler(cache, conf=features_conf(), device=device)
    allocate = {a.name: a for a in sched.actions}["allocate"]
    captured: list = []
    orig_dispatch = allocate_mod.dispatch_allocate_solve

    def recording(snap, config, **kw):
        captured.append((snap, config))
        return orig_dispatch(snap, config, **kw)

    cycles, states, held = [], [], None
    try:
        for c, kind in enumerate(FEATURE_PLAN):
            arrivals = 0
            if kind == "isolated":
                arrivals = GANG * max(2, n_tasks // (32 * GANG))
                add_feature_arrivals(cache, arrivals, seed + 100 + c, "late")
            binds_before = len(cache.binder.binds)
            kernels.reset_launches()
            if hold_first and c == 0:
                allocate_mod.dispatch_allocate_solve = recording
            stages: Dict[str, float] = {}
            gc.collect()
            gc.disable()
            try:
                with count_syncs(sched.device) as seen:
                    t = time.perf_counter()
                    if kind == "isolated":
                        isolated_cycle(sched, stages)
                    else:
                        sched.run_once()
                        stages = dict(sched.last_cycle_ms)
                    if sched.device.type == "cuda":
                        torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t) * 1e3
            finally:
                gc.enable()
                allocate_mod.dispatch_allocate_solve = orig_dispatch
            launches = dict(kernels.launches)
            errs = cache.columns.check_consistency(cache)
            if errs:
                fail(f"features cycle {c + 1}: column store disagrees with objects: {errs[:5]}")
            inv = node_invariants(cache)
            if any(inv.values()):
                fail(f"features cycle {c + 1}: node invariants violated: {inv}")
            channel = cache.binder.channel
            if len(set(channel)) != len(channel):
                fail(f"features cycle {c + 1}: a pod was bound twice")
            checks = feature_checks(cache)
            if hold_first and c == 0:
                if not captured:
                    fail("features cycle 1: allocate dispatched no solve")
                held = hold_kernels(*captured[0])
                captured.clear()
            cycles.append(dict(
                cycle=c + 1, session=kind, arrivals=arrivals, wall_ms=wall_ms,
                stages_ms=stages,
                clone_ms=stages.get("clone", 0.0),
                allocate_ms=dict(allocate.last_phase_ms),
                mode="compacted" if allocate.last_topk is not None else "full",
                rounds=allocate.last_solve_rounds, warm=allocate.last_warm,
                new_binds=len(cache.binder.binds) - binds_before,
                binds=len(cache.binder.binds), evicts=len(cache.evictor.evicts),
                volume_demoted_jobs=allocate.last_fallback.get("volume_demoted_jobs", 0),
                fallback=dict(allocate.last_fallback), launches=launches,
                syncs=seen[0] if sched.device.type == "cuda" else None,
                checks=checks, invariants=inv))
            if keep_states:
                vb = cache.volume_binder
                states.append(dict(observed(cache), events=sorted(cache.events),
                                   pv_bound=dict(vb.bound),
                                   pv_reserved={k: dict(v) for k, v in vb.reservations.items()}))
    finally:
        sched.close()
        cache.stop()
    if cache.dispatch_failures or cache.resync.parked_total:
        fail(f"{cache.dispatch_failures} bind dispatches failed, "
             f"{cache.resync.parked_total} binds or evictions parked for resync")
    report = dict(device=str(sched.device), ingest_s=ingest_s, cycles=cycles,
                  shape=[n_tasks, n_nodes], pdb_gang_frac=pdb_gang_frac,
                  pvc_pods=pvc_pods, pvc_impossible=pvc_impossible, held=held)
    if keep_states:
        report["states"] = states
    return report


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


#: the what-if drive's probed gangs in queue q0, counts 1–8: (count, cpu,
#: pinned node, evictions).  "full" is the node the fillers fill (its
#: gang's verdict is an eviction; last, since its claim stays pending
#: while the victims release), "free" a node pinned by hostname too
WHATIF_GANGS = (
    (2, 250.0, "free", False),
    (3, 1000.0, None, False),
    (4, 4000.0, None, False),
    (5, 250.0, None, False),
    (6, 1000.0, None, False),
    (7, 4000.0, None, False),
    (8, 250.0, None, False),
    (1, 4000.0, "full", True),
)
#: the what-if drive's pinned nodes, and the fillers that fill the first
WHATIF_NODES = {"full": "n0", "free": "n1"}
WHATIF_FILLERS = 8
#: the request mix of the serving part and of the card-vs-CPU part
#: (bench.py's whatif_serving_bench): counts U{1..8}, these cpus, 1 GiB
WHATIF_CPU = (250.0, 1000.0, 4000.0)
#: the plane's batch and window (bench.py's whatif_serving_bench); a
#: timed flush and the card-vs-CPU part send one full batch
WHATIF_BATCH, WHATIF_WINDOW_S = 32, 0.002
#: the serving part: client threads, requests each, and the steady cycles
#: run beside them
WHATIF_CLIENTS, WHATIF_REQUESTS, WHATIF_CYCLES = 16, 25, 3
#: the card-vs-CPU part's cluster
WHATIF_MID = (4096, 1024)


def whatif_body(count: int, cpu: float, node=None, evictions: bool = False,
                priority: int = 0) -> dict:
    """A what-if request for a gang of ``count`` members in queue q0."""
    from kube_batch_tpu_torch.api.pod import HOSTNAME_TOPOLOGY

    body = {"queue": "q0", "count": count, "priority": priority,
            "requests": {"cpu": cpu, "memory": float(2**30)}, "evictions": evictions}
    if node is not None:
        body["node_selector"] = {HOSTNAME_TOPOLOGY: node}
    return body


def probe_now(qp, body: dict) -> dict:
    """One request through a plane made with start_thread=False, flushed
    on this thread."""
    fut = qp.submit(body)
    qp.batcher.tick(now=qp.batcher.clock.monotonic() + 1e6)
    return fut.result(timeout=600)


def whatif_cluster(n_tasks: int, n_nodes: int, seed: int = 0, device=None):
    """The what-if drive's frozen cluster: ``synthetic_cluster(n_tasks,
    n_nodes, gang_size=4, n_queues=3)`` through the handlers, the two
    pinned nodes labelled with their hostname, and ``WHATIF_FILLERS``
    single-pod q0 jobs (MinAvailable 1, so evictable) pinned to the "full"
    node, each asking for its share of a node's cpu.  A plane
    (start_thread=False) is attached; two cycles of the shipped conf run,
    every pod still pending is deleted (nothing else competes with the
    probes), the fillers start Running (a victim runs), and a third cycle
    publishes the lease.  Returns (cache, scheduler, plane)."""
    from kube_batch_tpu_torch.api.pod import HOSTNAME_TOPOLOGY
    from kube_batch_tpu_torch.serve.plane import QueryPlane

    cache = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES, seed=seed)
    reserve_wobble(cache, n_tasks)
    for name in WHATIF_NODES.values():
        node = cache.nodes[name].node
        cache.update_node(dataclasses.replace(
            node, labels={**node.labels, HOSTNAME_TOPOLOGY: name}))
    for k in range(WHATIF_FILLERS):
        cache.add_pod_group(PodGroup(name=f"fill{k}", namespace="bench", min_member=1,
                                     queue="q0", creation_index=2 * 10**6 + k))
        cache.add_pod(Pod(
            name=f"fill{k}", namespace="bench",
            requests={"cpu": NODE_CPU / WHATIF_FILLERS, "memory": float(2**30)},
            annotations={GROUP_NAME_ANNOTATION: f"fill{k}"}, phase=PodPhase.PENDING,
            creation_index=2 * 10**6 + k,
            node_selector={HOSTNAME_TOPOLOGY: WHATIF_NODES["full"]}))
    sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()), device=device)
    qp = QueryPlane(cache, max_batch=WHATIF_BATCH, start_thread=False)
    for _ in range(2):
        sched.run_once()
    for pod in [p for p in cache.pods.values() if p.node_name is None]:
        cache.delete_pod(pod)
    for uid in [u for u, j in cache.jobs.items() if not j.tasks and j.pod_group is not None]:
        cache.delete_pod_group(uid)
    for k in range(WHATIF_FILLERS):
        pod = cache.pods.get(f"bench/fill{k}")
        if pod is not None:
            cache.update_pod(dataclasses.replace(pod, phase=PodPhase.RUNNING))
    sched.run_once()
    if qp.broker.current() is None:
        fail("whatif: the cycle published no lease")
    return cache, sched, qp


def hold_k1_rows(lease) -> dict:
    """K1 at explicit rows on a 64-member probe gang's plane of ``lease``
    (the lease's peeked rows, then rows past the task axis at a stride of
    5), against its plain version, bit-exact; on a CUDA lease also timed
    (CUDA events) against its bound."""
    from kube_batch_tpu_torch.ops.feasibility import static_predicates
    from kube_batch_tpu_torch.ops.kernels import masked_best_node_raw_plain
    from kube_batch_tpu_torch.ops.probe import _gang_view
    from kube_batch_tpu_torch.ops.scoring import score_matrix

    snap = lease.snap
    dev = snap.task_req.device
    T, R = snap.task_req.shape
    G = 64
    rng = np.random.default_rng(G)
    req = torch.zeros((G, R), dtype=torch.float32)
    req[:, 0] = torch.from_numpy(rng.choice(WHATIF_CPU, G).astype(np.float32))
    req[:, 1] = float(2**30)
    req[:, 2] = 1.0
    i32 = dict(dtype=torch.int32, device=dev)
    view = _gang_view(snap, req.to(dev), torch.ones(G, dtype=torch.bool, device=dev),
                      torch.tensor(G, **i32), torch.tensor(0, **i32), torch.tensor(0, **i32),
                      torch.zeros_like(snap.task_sel_bits[0]),
                      torch.tensor(False, device=dev), torch.zeros_like(snap.task_tol_bits[0]))
    rows = list(lease.probe_rows[:G // 2]) + [T + 3 + 5 * k for k in range(G // 2)]
    inp = dict(score=score_matrix(view, lease.config.weights).contiguous(),
               static_ok=static_predicates(view).contiguous(), task_req=view.task_req,
               idle=snap.node_idle, releasing=snap.node_releasing,
               pending=view.task_pending, quanta=snap.quanta,
               rows=torch.tensor(rows, dtype=torch.int32, device=dev))
    out = {"shape": list(inp["score"].shape), "rows_beyond_T": G // 2}
    if dev.type != "cuda":
        got = kernels.masked_best_node_raw(**inp)
        want = masked_best_node_raw_plain(**inp)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail("K1 at the probe's rows differs from its plain version")
        return dict(out, max_abs_err=0.0)
    from kube_batch_tpu_torch.testing.kernel_bench import k1_bound, run_case

    r = run_case(kernels.masked_best_node_raw, masked_best_node_raw_plain, inp, 20, 3)
    b_ms, b_by = k1_bound(inp)
    return dict(out, **r, bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / r["ms"])


def _submit_whatif_gang(cache, name: str, body: dict, serial: int) -> List[str]:
    """The probed gang, submitted as a client posts it: its PodGroup, then
    ``count`` pods in member order, created after everything in the
    cluster.  Returns the pod keys."""
    created = 5 * 10**7 + 100 * serial
    cache.add_pod_group(PodGroup(name=name, namespace="bench", min_member=body["count"],
                                 queue=body["queue"], creation_index=created))
    keys = []
    for k in range(body["count"]):
        cache.add_pod(Pod(name=f"{name}-{k}", namespace="bench",
                          requests=dict(body["requests"]),
                          annotations={GROUP_NAME_ANNOTATION: name},
                          phase=PodPhase.PENDING, priority=body["priority"],
                          creation_index=created + k,
                          node_selector=dict(body.get("node_selector", {}))))
        keys.append(f"bench/{name}-{k}")
    return keys


def whatif_oracle(cache, sched, qp) -> List[dict]:
    """The oracle contract on the frozen cluster, gang by gang
    (``WHATIF_GANGS``): probe, then submit the gang alone and run one
    cycle.  A lease is the snapshot its cycle's solve consumed, so it
    holds none of that cycle's own binds: before each probe but the first
    an idle cycle (nothing pending) publishes the lease of the state the
    gang's cycle will see.  A feasible verdict must bind exactly at its
    nodes, an eviction verdict must evict exactly its victims (through
    preempt), and every gang not pinned to the full node must be
    feasible.  Records each probe's latency, K1 launches and host syncs."""
    dev = sched.device
    out = []
    for i, (count, cpu, node, evictions) in enumerate(WHATIF_GANGS):
        if i:
            sched.run_once()
        if (cache.columns.has_schedulable_pending()
                or qp.broker.current().version != cache.last_open_version):
            fail(f"whatif gang {i}: the lease does not describe an idle cycle's state")
        body = whatif_body(count, cpu, WHATIF_NODES.get(node), evictions,
                           priority=100 if evictions else 0)
        kernels.reset_launches()
        with count_syncs(dev) as syncs:
            t = time.perf_counter()
            resp = probe_now(qp, body)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            probe_ms = (time.perf_counter() - t) * 1e3
        launches = kernels.launches["masked_best_node_raw"]
        lease = qp.broker.current()
        if resp["snapshot_version"] != lease.version:
            fail(f"whatif gang {i}: answered at {resp['snapshot_version']}, lease {lease.version}")
        keys = _submit_whatif_gang(cache, f"whatif{i}", body, i)
        n_ev = len(cache.evictor.evicts)
        sched.run_once()
        bound = [cache.binder.binds.get(k) for k in keys]
        evicted = sorted(cache.evictor.evicts[n_ev:])
        rec = dict(gang=i, count=count, cpu=cpu, pinned=node, evictions=evictions,
                   feasible=resp["feasible"], committed=resp["committed"],
                   nodes=resp["nodes"], bound=bound, probe_ms=probe_ms,
                   k1_launches=launches, syncs=syncs[0] if dev.type == "cuda" else None,
                   version=resp["snapshot_version"])
        if resp["feasible"] and bound != resp["nodes"]:
            fail(f"whatif gang {i}: probed at {resp['nodes']}, bound at {bound}")
        if node != "full" and not resp["feasible"]:
            fail(f"whatif gang {i}: {count} × {cpu} cpu reported infeasible: {resp}")
        if evictions:
            ev = resp["evictions"]
            rec.update(victims=ev["victims"], claim_nodes=ev["claim_nodes"],
                       covered=ev["covered"], evicted=evicted)
            if evicted != ev["victims"]:
                fail(f"whatif gang {i}: probed victims {ev['victims']}, evicted {evicted}")
            if node == "full" and not (ev["victims"] and ev["covered"]):
                fail(f"whatif gang {i}: no covered eviction on the full node: {ev}")
        if dev.type == "cuda" and launches == 0:
            fail(f"whatif gang {i}: the probe launched no K1")
        out.append(rec)
    return out


def whatif_serving(cache, sched, n_tasks: int, seed: int = 0) -> dict:
    """bench.py's whatif_serving_bench beside live cycles: a threaded plane
    (``WHATIF_BATCH``, ``WHATIF_WINDOW_S``, and the lease wait a deployment
    has, ``KB_WHATIF_TIMEOUT_S``) answers ``WHATIF_CLIENTS`` client threads
    of ``WHATIF_REQUESTS`` requests each (counts U{1..8}, cpu from
    ``WHATIF_CPU``, 1 GiB, one in four with evictions) while this thread
    runs ``WHATIF_CYCLES`` cycles of the steady drive (the kubelet pass,
    then the churn; the first pass, which starts every bound pod, runs
    before the window).  Each cycle records its wall, stages and
    allocate phases, the ms its swaps waited for in-flight probes, and
    the ms the lease was dark (retired, not yet re-armed).  Checks: no
    request failed; each client's versions never decrease; every
    answered node is in its lease's meta; every swap retired the lease
    and every cycle ended with one live; fewer dispatches than requests
    served."""
    from kube_batch_tpu_torch.serve.plane import QueryPlane

    qp = QueryPlane(cache, max_batch=WHATIF_BATCH, window_s=WHATIF_WINDOW_S)
    broker = qp.broker
    allocate = {a.name: a for a in sched.actions}["allocate"]
    nodes_by_version: Dict[int, set] = {}
    publish = qp.broker.publish

    def recording_publish(lease):
        nodes_by_version.setdefault(lease.version, set()).update(
            n for n in lease.meta.node_names if n)
        publish(lease)

    qp.broker.publish = recording_publish
    swaps = [0]
    cols = cache.columns
    try:
        n_ev = len(cache.evictor.evicts)
        kubelet(cache, [])
        sched.run_once()  # the new plane's first lease
        churn = steady_churn(cache, n_tasks, seed + 7)
        retired0, published0 = broker.retired, broker.published
        served0, dispatches0 = qp.requests_served, qp.dispatches
        broker.dark_longest_s = 0.0
        cols.on_swap = lambda snap, out: swaps.__setitem__(0, swaps[0] + 1)
        answers: Dict[int, list] = {}
        errors: List[str] = []
        lock = threading.Lock()

        def client(k: int) -> None:
            rng = np.random.default_rng([seed, k])
            mine = []
            try:
                for _ in range(WHATIF_REQUESTS):
                    body = whatif_body(int(rng.integers(1, 9)), float(rng.choice(WHATIF_CPU)),
                                       evictions=bool(rng.random() < 0.25))
                    t = time.perf_counter()
                    resp = qp.submit(body).result(timeout=600)
                    mine.append(((time.perf_counter() - t) * 1e3, resp))
            except Exception as e:  # noqa: BLE001 — counted, the drive fails on it
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
            with lock:
                answers[k] = mine

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(WHATIF_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        walls, log, leaseless = [], [], []
        for c in range(1, WHATIF_CYCLES + 1):
            kubelet(cache, cache.evictor.evicts[n_ev:])
            n_ev = len(cache.evictor.evicts)
            churn(c)
            wait0, dark0, swaps0 = broker.swap_wait_s, broker.dark_s, swaps[0]
            t = time.perf_counter()
            sched.run_once()
            if sched.device.type == "cuda":
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            log.append(dict(wall_ms=walls[-1], open_path=cache.last_open_path,
                            stages_ms=dict(sched.last_cycle_ms),
                            allocate_ms=dict(allocate.last_phase_ms),
                            swaps=swaps[0] - swaps0,
                            swap_wait_ms=(broker.swap_wait_s - wait0) * 1e3,
                            dark_ms=(broker.dark_s - dark0) * 1e3))
            if broker.current() is None:
                leaseless.append(c)
        cycles_s = time.perf_counter() - t0
        for t in threads:
            t.join(timeout=900)
        elapsed = time.perf_counter() - t0
        cols.on_swap = None
        served = qp.requests_served - served0
        dispatches = qp.dispatches - dispatches0
        retired = broker.retired - retired0
        published = broker.published - published0
        dark_longest_ms = broker.dark_longest_s * 1e3
    finally:
        cols.on_swap = None
        qp.close()
    if errors:
        fail(f"whatif serving: {len(errors)} clients failed: {errors[:3]}")
    lat = sorted(ms for mine in answers.values() for ms, _r in mine)
    for k, mine in answers.items():
        versions = [r["snapshot_version"] for _ms, r in mine]
        if versions != sorted(versions):
            fail(f"whatif serving: client {k}'s versions went back: {versions}")
        for _ms, r in mine:
            known = nodes_by_version.get(r["snapshot_version"], set())
            named = [n for n in r["nodes"] + r.get("evictions", {}).get("claim_nodes", [])
                     if n is not None]
            if any(n not in known for n in named):
                fail(f"whatif serving: nodes {named} not in lease {r['snapshot_version']}")
    if len(lat) != WHATIF_CLIENTS * WHATIF_REQUESTS:
        fail(f"whatif serving: {len(lat)} answers of {WHATIF_CLIENTS * WHATIF_REQUESTS}")
    if retired < swaps[0] or leaseless:
        fail(f"whatif serving: {retired} retirements for {swaps[0]} swaps, leaseless "
             f"after cycles {leaseless}")
    if not 0 < dispatches < served:
        fail(f"whatif serving: {dispatches} dispatches for {served} requests")
    return dict(clients=WHATIF_CLIENTS, requests=served, dispatches=dispatches,
                mean_batch_size=served / dispatches,
                dispatches_per_100_requests=100.0 * dispatches / served,
                latency_ms={"p50": float(np.percentile(lat, 50)),
                            "p99": float(np.percentile(lat, 99)),
                            "mean": float(np.mean(lat))},
                qps=served / elapsed, elapsed_s=elapsed, cycles_s=cycles_s,
                cycle_wall_ms=walls, cycles=log, swaps=swaps[0], retired=retired,
                published=published, dark_longest_ms=dark_longest_ms,
                lease_wait_s=qp.dispatch_timeout, max_batch=WHATIF_BATCH,
                window_s=WHATIF_WINDOW_S)


def whatif_flush(qp, seed: int = 0, profile: bool = False) -> dict:
    """``qp.batcher.max_batch`` requests of the serving mix (every eighth
    pinned to the full node) in one flush against the frozen lease,
    without and with evictions: each flush's wall (to its last answer,
    the card synchronised), K1 launches and host syncs, or with
    ``profile`` its :func:`device_profile` in place of the syncs (the
    profiler slows the host: take the walls from a run without it)."""
    bodies = whatif_requests(qp.batcher.max_batch, seed)
    dev = qp.broker.current().snap.task_req.device
    out = {}
    for ev in (False, True):
        kernels.reset_launches()
        with (device_profile(dev) if profile else count_syncs(dev)) as seen:
            t = time.perf_counter()
            futs = [qp.submit(dict(b, evictions=ev)) for b in bodies]
            qp.batcher.tick(now=qp.batcher.clock.monotonic() + 1e6)
            answers = [f.result(timeout=600) for f in futs]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        out["evictions" if ev else "plain"] = dict(
            gangs=len(answers), ms=ms, k1_launches=kernels.launches["masked_best_node_raw"],
            syncs=seen[0] if dev.type == "cuda" and not profile else None,
            feasible=sum(r["feasible"] for r in answers),
            **(seen if profile else {}))
    return out


def whatif_requests(n: int, seed: int) -> List[dict]:
    """``n`` seeded requests of the serving mix, every eighth pinned to the
    full node at 4000 cpu (an eviction verdict when evictions are on)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 8 == 7:
            out.append(whatif_body(1, 4000.0, WHATIF_NODES["full"]))
        else:
            out.append(whatif_body(int(rng.integers(1, 9)), float(rng.choice(WHATIF_CPU))))
    return out


def whatif_cross_device(device, seed: int = 0) -> dict:
    """The same ``WHATIF_BATCH`` requests, without and with evictions, to
    the frozen ``WHATIF_MID`` cluster built the same way on the CPU (K1's
    plain version) and on ``device``: each set is one flush, and the
    answers must be identical."""
    answers = {}
    bodies = whatif_requests(WHATIF_BATCH, seed)
    for leg, dev in (("cpu", "cpu"), ("device", device)):
        cache, sched, qp = whatif_cluster(*WHATIF_MID, seed, dev)
        try:
            got = {}
            for ev in (False, True):
                futs = [qp.submit(dict(b, evictions=ev)) for b in bodies]
                qp.batcher.tick(now=qp.batcher.clock.monotonic() + 1e6)
                got[ev] = [f.result(timeout=600) for f in futs]
            answers[leg] = got
            dispatches = qp.dispatches
        finally:
            qp.close()
            sched.close()
            cache.stop()
        if dispatches != 2:
            fail(f"whatif cross-device {leg}: {dispatches} dispatches for two flushes")
    for ev in (False, True):
        for i, (a, b) in enumerate(zip(answers["cpu"][ev], answers["device"][ev])):
            if a != b:
                fail(f"whatif cross-device: request {i} (evictions {ev}) answered "
                     f"differently: {a} / {b}")
    with_victims = sum(1 for r in answers["device"][True] if r["evictions"]["victims"])
    if not with_victims:
        fail("whatif cross-device: no answer named a victim")
    return dict(shape=list(WHATIF_MID), requests=WHATIF_BATCH,
                feasible=sum(r["feasible"] for r in answers["device"][False]),
                with_victims=with_victims, equal="every response, with and without evictions")


def drive_whatif(n_tasks: int, n_nodes: int, seed: int = 0, device=None,
                 profile: bool = False) -> dict:
    """The read plane's drive: the oracle contract on the frozen
    ``whatif_cluster`` (:func:`whatif_oracle`, with K1 held at the probe's
    rows first, :func:`hold_k1_rows`, and a flush of 32 gangs without and
    with evictions timed, :func:`whatif_flush`), then serving beside live cycles on
    the same cache (:func:`whatif_serving`), then the card against the CPU
    at ``WHATIF_MID`` (:func:`whatif_cross_device`, skipped on
    a CPU run).  ``profile`` profiles the timed flushes.  Raises on any
    failed check; returns the report."""
    t = time.perf_counter()
    cache, sched, qp = whatif_cluster(n_tasks, n_nodes, seed, device)
    setup_s = time.perf_counter() - t
    try:
        k1_rows = hold_k1_rows(qp.broker.current())
        flush = whatif_flush(qp, seed, profile)
        oracle = whatif_oracle(cache, sched, qp)
        qp.close()
        serving = whatif_serving(cache, sched, n_tasks, seed)
    finally:
        qp.close()
        sched.close()
        cache.stop()
    cross = (whatif_cross_device(sched.device, seed)
             if sched.device.type == "cuda" else None)
    return dict(tasks=n_tasks, nodes=n_nodes, device=str(sched.device), setup_s=setup_s,
                k1_probe_rows=k1_rows, flush=flush, oracle=oracle, serving=serving,
                cross_device=cross)


#: the replicate drive's probe bodies after every applied record: four
#: gangs in q0 (the last with evictions) and one sweep
REPLICATE_GANGS = ((2, 250.0, False), (4, 1000.0, False), (8, 4000.0, False),
                   (1, 4000.0, True))
REPLICATE_SWEEP = {"queue": "q0", "max_count": 16,
                   "requests": {"cpu": 1000.0, "memory": float(2**30)}}
#: the leader's ring while the publisher is attached
REPLICATE_RING = 4
#: the replicate drive's warmup and steady cycles per leg (bench.py:151's)
REPLICATE_WARMUP, REPLICATE_CYCLES = 2, 8
#: what the follower does in each steady cycle of the publishing leg (the
#: warmup cycles follow): ``follow`` joins, pulls and checks every record
#: before the leader's next swap; ``drop`` does too but drops the cycle's
#: first frame, so the next delta arrives past a gap and must be refused
#: and the full frame after it adopted warm; ``alone`` leaves the publisher
#: alone through the cycle and catches up after its wall; ``sitout`` does
#: not catch up either, so the next catch-up is past the ring and gets a
#: full frame.  The ``alone`` and ``sitout`` walls read the publisher's cost.
REPLICATE_PLAN = ("follow", "alone", "drop", "alone", "follow", "sitout", "alone",
                  "follow")
#: the cost drive's legs, publisher off or on: two pairs, in either order
REPLICATE_COST_ORDER = (False, True, True, False)


class Loopback:
    """``ApiTransport.get_bytes`` in process: serves ``pub.record_for``
    (either package's publisher); ``down`` makes it fail as an unreachable
    leader does, and ``lose`` loses one frame on the way (the frame after
    the one asked for comes instead).  ``last_bytes`` is the size of the
    last frame served."""

    def __init__(self, pub) -> None:
        self.pub = pub
        self.down = False
        self.lose = False
        self.last_bytes = 0

    def get_bytes(self, path: str, timeout: float = 60) -> bytes:
        if self.down:
            raise OSError("leader unreachable")
        since = int(path.rsplit("since=", 1)[1])
        if self.lose:
            self.lose = False
            since += 1
        frame = self.pub.record_for(since)
        self.last_bytes = len(frame)
        return frame

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _canonical(resp: dict) -> str:
    return json.dumps(resp, sort_keys=True)


def _sweep_now(qp, body: dict) -> dict:
    fut = qp.submit_sweep(body)
    qp.batcher.tick(now=qp.batcher.clock.monotonic() + 1e6)
    return fut.result(timeout=600)


def make_follower(pub, device, **plane_kw):
    """A follower with its own read-only cache and plane
    (start_thread=False), pulling ``pub`` in process."""
    from kube_batch_tpu_torch.replicate.follower import FollowerCache, ReplicationFollower
    from kube_batch_tpu_torch.serve.plane import QueryPlane

    fcache = FollowerCache()
    fqp = QueryPlane(fcache, start_thread=False, **plane_kw)
    return ReplicationFollower("http://in-process", cache=fcache, query_plane=fqp,
                               transport=Loopback(pub), poll_s=0.001, device=device)


def _pct(values, q):
    return float(np.percentile(values, q)) if values else None


class ReplicaCheck:
    """The publishing leg's hook on :func:`_run_cycles`.  In the cycles
    that :data:`REPLICATE_PLAN` follows, each record is joined, pulled and
    applied before the leader's next swap (the check rides the swap guard;
    the cycle's last record is checked after its wall), and the same
    bodies go to both planes, whose answers must be equal (canonical JSON,
    staleness included).  The check's time inside a cycle is taken out of
    its wall, and with it the encode that the check joined, so a followed
    cycle's wall is a lower bound of the leader's; the cycles the
    publisher runs alone read its cost."""

    def __init__(self, qp, pub, follower, device):
        self.qp, self.pub, self.f, self.device = qp, pub, follower, device
        self.mode = "follow"
        self.pending = False       # a record published and not checked yet
        self.dropped = None        # the dropped frame: None, "lost", "resynced"
        self.sitting = False       # sat out: no catch-up until past the ring
        self.records: List[dict] = []
        self.pulls: List[dict] = []
        self.resyncs: List[dict] = []
        self.compared = 0
        self.in_cycle_ms = 0.0
        self.cycle = 0
        self.follower_k1 = 0
        self.probe_ms = {"leader": [], "follower": []}

    # ---- the hook ---------------------------------------------------------
    def before(self, c: int) -> None:
        steady = c - REPLICATE_WARMUP
        self.mode = REPLICATE_PLAN[steady] if steady >= 0 else "follow"
        self.cycle, self.in_cycle_ms = c, 0.0

    def after(self, c: int) -> float:
        if self.mode == "sitout":
            self.sitting = True
        elif self.mode == "alone":
            self.catch_up()
        elif self.pending:
            self.check()
        self.pending = False
        return self.in_cycle_ms

    def publish_hook(self, publish):
        def hooked(ssn, snap, meta):
            publish(ssn, snap, meta)
            self.records.append(dict(seq=len(self.records) + 1, cycle=self.cycle,
                                     mode=self.mode, publish_ms=self.pub.last_publish_ms,
                                     join_ms=self.pub.last_join_ms))
            self.pending = True
        return hooked

    def guard(self, swap_guard):
        @contextlib.contextmanager
        def checked():
            if self.pending and self.mode not in ("alone", "sitout"):
                t = time.perf_counter()
                self.check()
                self.in_cycle_ms += (time.perf_counter() - t) * 1e3
            with swap_guard():
                yield
        return checked

    # ---- one record -------------------------------------------------------
    def _probe_both(self, name, leader_fn, follower_fn):
        t = time.perf_counter()
        want = leader_fn()
        _sync(self.device)
        t1 = time.perf_counter()
        k1 = kernels.launches["masked_best_node_raw"]
        got = follower_fn()
        _sync(self.device)
        t2 = time.perf_counter()
        self.follower_k1 += kernels.launches["masked_best_node_raw"] - k1
        self.probe_ms["leader"].append((t1 - t) * 1e3)
        self.probe_ms["follower"].append((t2 - t1) * 1e3)
        if _canonical(got) != _canonical(want):
            fail(f"replicate: {name} at seq {self.f.applier.applied_seq} answered "
                 f"differently: leader {want} / follower {got}")
        return got

    def compare(self) -> None:
        fqp = self.f.qp
        for count, cpu, ev in REPLICATE_GANGS:
            body = whatif_body(count, cpu, evictions=ev)
            got = self._probe_both(f"gang {count}x{cpu}", lambda: probe_now(self.qp, body),
                                   lambda: probe_now(fqp, body))
            if got["staleness"]["lag_cycles"] != 0:
                fail(f"replicate: a caught-up follower reports lag {got['staleness']}")
        self._probe_both("sweep", lambda: _sweep_now(self.qp, REPLICATE_SWEEP),
                         lambda: _sweep_now(fqp, REPLICATE_SWEEP))
        self.compared += 1

    def _join(self) -> None:
        """Join the encode in flight: the last record's encode and size."""
        t = time.perf_counter()
        self.pub.barrier()
        self.records[-1].update(barrier_ms=(time.perf_counter() - t) * 1e3,
                                encode_ms=self.pub.last_encode_ms,
                                frame_bytes=self.pub.last_frame_bytes)

    def _pull(self, expect_kind=None) -> dict:
        app = self.f.applier
        lag = self.pub.counters()["head_seq"] - app.applied_seq
        c0, s0, full0 = app.resident.counters(), app.static_uploads, app.full_adoptions
        t = time.perf_counter()
        outcome = self.f.run_once()
        _sync(self.device)
        total_ms = (time.perf_counter() - t) * 1e3
        if outcome != "applied":
            fail(f"replicate: the follower's pull gave {outcome!r}")
        kind = "full" if app.full_adoptions > full0 else "delta"
        if expect_kind is not None and kind != expect_kind:
            fail(f"replicate: expected a {expect_kind} frame, got {kind}")
        c1 = app.resident.counters()
        pull = dict(seq=app.applied_seq, cycle=self.cycle, mode=self.mode, kind=kind,
                    frame_bytes=self.f.transport.last_bytes, lag_before=lag,
                    total_ms=total_ms, **{f"{k}_ms": v for k, v in app.last_ms.items()},
                    full_uploads=c1["full_uploads"] - c0["full_uploads"],
                    scatters=c1["scatter_updates"] - c0["scatter_updates"],
                    clean=c1["clean_hits"] - c0["clean_hits"],
                    static_uploads=app.static_uploads - s0)
        self.pulls.append(pull)
        return pull

    def _past_gap(self) -> bool:
        """After a dropped frame, once a later record is out: the next
        frame comes past the gap and must be refused, and the full frame
        that the follower asks for then must be adopted warm."""
        app = self.f.applier
        if self.dropped != "lost" or self.pub.counters()["head_seq"] < app.applied_seq + 2:
            return False
        self.dropped = "resynced"
        self.f.transport.lose = True
        if self.f.run_once() != "resync":
            fail("replicate: a delta past a dropped frame was not refused")
        self.resyncs.append(dict(self._pull("full"), why="gap", gaps=app.gaps,
                                 per_cycle_changed=len(app.resident.delta_record)))
        return True

    def _to_head(self) -> None:
        """Pull until the follower holds the head: past a dropped frame
        the resync, past the ring one synthesized full frame, else the
        ring's records in order; then compare the planes."""
        self.sitting = False
        app = self.f.applier
        head = self.pub.counters()["head_seq"]
        if not self._past_gap() and app.applied_seq < head:
            past_ring = head - app.applied_seq > REPLICATE_RING
            first = self._pull("full" if past_ring else None)
            if past_ring:
                self.resyncs.append(dict(first, why="ring", ring=REPLICATE_RING))
        while app.applied_seq < head:
            self._pull()
        self.compare()

    def check(self) -> None:
        """The pending record, joined, then the follower brought to it;
        in a ``drop`` cycle the first frame never reaches the follower."""
        self.pending = False
        self._join()
        if self.mode == "drop" and self.dropped is None:
            self.dropped = "lost"
            return
        self._to_head()

    def catch_up(self) -> None:
        """After an ``alone`` cycle's wall: the last encode joined, the
        follower brought to the head; after a ``sitout``, not until it is
        past the ring."""
        if self.pending:
            self._join()
        head = self.pub.counters()["head_seq"]
        if self.sitting and head - self.f.applier.applied_seq <= REPLICATE_RING:
            return
        self._to_head()


def replicate_cross_device(device) -> dict:
    """The what-if drive's frozen ``WHATIF_MID`` cluster (:func:`whatif_cluster`:
    the full node holds evictable fillers) on ``device`` gets a publisher
    and runs two more cycles of the shipped conf, a small gang arriving
    before each; a follower on ``device`` and one on the CPU are fed the
    same frames after each cycle and must answer the same ``WHATIF_BATCH``
    requests identically (and as the leader does), with and without
    evictions."""
    from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher

    cache, sched, qp = whatif_cluster(*WHATIF_MID, 0, device)
    cache.replication = pub = ReplicationPublisher()
    followers = {leg: make_follower(pub, dev, max_batch=WHATIF_BATCH)
                 for leg, dev in (("device", device), ("cpu", "cpu"))}
    try:
        for c in (1, 2):
            # a small gang arrives (the full node's fillers stay: a steady
            # churn's arrivals would reclaim them), the pods bound before
            # start Running, and a cycle publishes the next record
            kubelet(cache, list(cache.evictor.evicts))
            name = f"rep{c}"
            cache.add_pod_group(PodGroup(name=name, namespace="bench", min_member=2,
                                         queue="q1", creation_index=3 * 10**6 + c))
            for i in range(2):
                cache.add_pod(Pod(
                    name=f"{name}-{i}", namespace="bench",
                    requests={"cpu": 500.0, "memory": float(2**30)},
                    annotations={GROUP_NAME_ANNOTATION: name}, phase=PodPhase.PENDING,
                    creation_index=(3 * 10**6 + c) * 10 + i))
            sched.run_once()
            pub.barrier()
            for f in followers.values():
                while f.run_once() == "applied":
                    pass
        bodies = whatif_requests(WHATIF_BATCH, 0)
        answers = {}
        for leg, qpl in (("leader", qp), *((k, f.qp) for k, f in followers.items())):
            got = {}
            for ev in (False, True):
                futs = [qpl.submit(dict(b, evictions=ev)) for b in bodies]
                qpl.batcher.tick(now=qpl.batcher.clock.monotonic() + 1e6)
                got[ev] = [f.result(timeout=600) for f in futs]
            answers[leg] = got
        for ev in (False, True):
            for i, (a, b, c_) in enumerate(zip(answers["device"][ev], answers["cpu"][ev],
                                               answers["leader"][ev])):
                if not a == b == c_:
                    fail(f"replicate cross-device: request {i} (evictions {ev}) answered "
                         f"differently: card {a} / cpu {b} / leader {c_}")
        seqs = {k: f.applier.applied_seq for k, f in followers.items()}
        if len(set(seqs.values())) != 1 or seqs["cpu"] != pub.counters()["head_seq"]:
            fail(f"replicate cross-device: followers at {seqs}, head {pub.counters()}")
        with_victims = sum(1 for r in answers["device"][True] if r["evictions"]["victims"])
        if not with_victims:
            fail("replicate cross-device: no answer named a victim")
    finally:
        for f in followers.values():
            f.qp.close()
        pub.close()
        qp.close()
        sched.close()
        cache.stop()
    return dict(shape=list(WHATIF_MID), requests=WHATIF_BATCH, records=seqs["cpu"],
                feasible=sum(r["feasible"] for r in answers["device"][False]),
                with_victims=with_victims,
                equal="card follower = CPU follower = leader, with and without evictions")


def _replicate_leg(n_tasks: int, n_nodes: int, device, publish: bool) -> dict:
    """One leg of the replicate drive on a fresh cluster: the steady drive
    (seed 0) with a query plane attached, through :func:`_run_cycles` and
    its per-cycle checks; with ``publish``, the publisher, a follower on
    the same device and :class:`ReplicaCheck`, then the pull loop's warm
    restart.  Raises on a failed check; returns the walls and the check."""
    from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher
    from kube_batch_tpu_torch.serve.plane import QueryPlane

    t0 = time.perf_counter()
    cache = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES, seed=0)
    reserve_wobble(cache, n_tasks)
    ingest_s = time.perf_counter() - t0
    churn = steady_churn(cache, n_tasks, 0)
    qp = QueryPlane(cache, start_thread=False)
    sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()), device=device)
    cols = cache.columns
    pub = follower = check = restart = None
    # the full collection before each cycle then scans only what the drive
    # made since: the cluster's millions of objects (and whatever the
    # process held before) are set aside for the leg
    gc.collect()
    gc.freeze()
    try:
        if publish:
            cache.replication = pub = ReplicationPublisher(ring_size=REPLICATE_RING)
            follower = make_follower(pub, sched.device)
            check = ReplicaCheck(qp, pub, follower, sched.device)
            qp.publish_session = check.publish_hook(qp.publish_session)
            cols.resident_swap_guard = check.guard(qp.broker.swap_guard)
        report = _run_cycles(sched, cache, churn, ingest_s, False, False,
                             REPLICATE_WARMUP + REPLICATE_CYCLES, False, False, hook=check)
        if follower is not None:
            _check_stream(check)
            # a restart of the pull loop re-adopts the synced residency warm
            seen = []
            revalidate = follower.applier.revalidate_resident
            follower.applier.revalidate_resident = lambda: seen.append(revalidate()) or seen[-1]
            follower.start()
            for _ in range(1000):
                if seen:
                    break
                time.sleep(0.01)
            follower.stop()
            if not seen or seen[0]["mode"] != "warm":
                fail(f"replicate: the restarted pull loop re-adopted {seen}")
            restart = seen[0]
    finally:
        cols.resident_swap_guard = qp._swap_guard
        if follower is not None:
            follower.qp.close()
        if pub is not None:
            pub.close()
        qp.close()
        sched.close()
        cache.stop()
        gc.unfreeze()
    return dict(walls=[c["wall_ms"] for c in report["cycles"]], check=check,
                restart=restart, seconds=time.perf_counter() - t0)


def _check_stream(check: ReplicaCheck) -> None:
    """The publishing leg's stream: every record landed in order, the
    dropped frame resynced warm (only what changed uploaded again), and
    the catch-up past the ring took a full frame."""
    head = check.pub.counters()["head_seq"]
    if head != len(check.records):
        fail(f"replicate: {len(check.records)} publishes, head at seq {head}")
    if [r["why"] for r in check.resyncs] != ["gap", "ring"]:
        fail(f"replicate: expected a gap resync, then a ring resync: {check.resyncs}")
    gap = check.resyncs[0]
    static_fields = len(DeviceSnapshot._fields) - len(PER_CYCLE_FIELDS)
    if not (gap["full_uploads"] + gap["scatters"] == gap["per_cycle_changed"]
            and gap["clean"] > 0 and gap["static_uploads"] < static_fields):
        fail(f"replicate: the gap's warm re-adoption uploaded more than what changed: {gap}")
    if check.f.applier.applied_seq != head:
        fail(f"replicate: the follower ended at seq {check.f.applier.applied_seq}, head {head}")


def _publisher_alone() -> List[int]:
    """The cycles of a leg where the publisher ran with no check."""
    return [REPLICATE_WARMUP + i for i, m in enumerate(REPLICATE_PLAN)
            if m in ("alone", "sitout")]


def drive_replicate(n_tasks: int, n_nodes: int, device=None) -> dict:
    """The replication stream's drive (module docstring): the steady drive
    with a query plane twice on the same seed, so both legs see the same
    churn: without a publisher (``off``), then with the publisher and a
    follower on the same device (``on``, :class:`ReplicaCheck` following
    :data:`REPLICATE_PLAN`); then, on CUDA, the card against the CPU
    (:func:`replicate_cross_device`).  Raises on any failed check; returns
    the report."""
    off = _replicate_leg(n_tasks, n_nodes, device, False)
    on = _replicate_leg(n_tasks, n_nodes, device, True)
    check = on["check"]
    recs, pulls = check.records, check.pulls
    deltas = [p for p in pulls if p["kind"] == "delta"]
    alone = _publisher_alone()
    followed = [REPLICATE_WARMUP + i for i, m in enumerate(REPLICATE_PLAN)
                if m not in ("alone", "sitout")]

    def stats(values):
        return dict(p50=_pct(values, 50), max=max(values) if values else None)

    device_name = str(torch.device("cuda" if device is None else device))
    n_cycles = REPLICATE_WARMUP + REPLICATE_CYCLES
    report = dict(
        tasks=n_tasks, nodes=n_nodes, device=device_name, cycles=REPLICATE_CYCLES,
        warmup_cycles=REPLICATE_WARMUP, plan=list(REPLICATE_PLAN),
        off_s=off["seconds"], on_s=on["seconds"],
        records=len(recs),
        records_per_cycle=[sum(1 for r in recs if r["cycle"] == c) for c in range(n_cycles)],
        checked=check.compared, counters=check.pub.counters(),
        frame_bytes=dict(full=[p["frame_bytes"] for p in pulls if p["kind"] == "full"],
                         delta=stats([p["frame_bytes"] for p in deltas])),
        publisher_ms=dict(
            publish=stats([r["publish_ms"] for r in recs if r["seq"] > 1]),
            # the join of the previous encode inside publish_cycle: ~0 where
            # the check joined it first, the real wait where the publisher
            # ran alone
            join_in_publish_alone=stats([r["join_ms"] for r in recs
                                         if r["seq"] > 1 and r["cycle"] in alone]),
            join_in_publish_followed=stats([r["join_ms"] for r in recs
                                            if r["seq"] > 1 and r["cycle"] not in alone]),
            check_barrier=stats([r["barrier_ms"] for r in recs
                                 if r["seq"] > 1 and "barrier_ms" in r]),
            encode=stats([r["encode_ms"] for r in recs if r["seq"] > 1 and "encode_ms" in r])),
        follower_ms={k: stats([p[f"{k}_ms"] for p in deltas])
                     for k in ("decode", "apply", "swap", "total")},
        follower_full_ms={k: [p[f"{k}_ms"] for p in pulls if p["kind"] == "full"]
                          for k in ("decode", "apply", "swap", "total")},
        uploads={k: sum(p[k] for p in deltas)
                 for k in ("full_uploads", "scatters", "clean", "static_uploads")},
        lag_p99=_pct([p["lag_before"] for p in pulls], 99),
        lag_p99_followed=_pct([p["lag_before"] for p in pulls if p["cycle"] not in alone], 99),
        probe_ms=dict(leader=stats(check.probe_ms["leader"]),
                      follower=stats(check.probe_ms["follower"])),
        follower_k1_launches=check.follower_k1,
        resyncs=check.resyncs, restart=on["restart"],
        # the same cycles of the same churn, on less off: where the
        # publisher ran alone (its cost), and where the checks ran (their
        # time and the encode they joined taken out: a lower bound)
        alone_cycles=alone,
        wall_ms_p50=dict(off=_pct([off["walls"][c] for c in alone], 50),
                         on=_pct([on["walls"][c] for c in alone], 50)),
        wall_ms_alone_on_less_off=[on["walls"][c] - off["walls"][c] for c in alone],
        wall_ms_followed_on_less_off=[on["walls"][c] - off["walls"][c] for c in followed],
        wall_ms=dict(off=off["walls"], on=on["walls"]),
    )
    t = time.perf_counter()
    report["cross_device"] = (replicate_cross_device(device)
                              if torch.device(device_name).type == "cuda" else None)
    report["cross_device_s"] = time.perf_counter() - t
    return report


def replicate_cost(n_tasks: int, n_nodes: int, device=None) -> dict:
    """The publisher's cost on the leader's steady wall: the replicate
    drive's legs in the order :data:`REPLICATE_COST_ORDER` (off, on, on,
    off: two pairs, each order once), every publishing leg checked as in
    :func:`drive_replicate`; each pair's walls are compared cycle by cycle
    in the cycles where the publisher ran alone."""
    legs = [_replicate_leg(n_tasks, n_nodes, device, publish)
            for publish in REPLICATE_COST_ORDER]
    alone = _publisher_alone()
    pairs = []
    for i in range(0, len(legs), 2):
        order = REPLICATE_COST_ORDER[i:i + 2]
        off, on = (legs[i], legs[i + 1]) if not order[0] else (legs[i + 1], legs[i])
        diff = [on["walls"][c] - off["walls"][c] for c in alone]
        pairs.append(dict(order=["on" if p else "off" for p in order],
                          wall_ms_p50=dict(off=_pct([off["walls"][c] for c in alone], 50),
                                           on=_pct([on["walls"][c] for c in alone], 50)),
                          on_less_off=diff, on_less_off_p50=_pct(diff, 50),
                          walls=dict(off=off["walls"], on=on["walls"])))
    every = [d for p in pairs for d in p["on_less_off"]]
    return dict(tasks=n_tasks, nodes=n_nodes, device=str(torch.device(
        "cuda" if device is None else device)), alone_cycles=alone, pairs=pairs,
        on_less_off_p50=_pct(every, 50), seconds=[leg["seconds"] for leg in legs])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--overcommit", action="store_true")
    ap.add_argument("--steady", action="store_true")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--features", action="store_true")
    ap.add_argument("--whatif", action="store_true")
    ap.add_argument("--replicate", action="store_true")
    ap.add_argument("--replicate-cost", action="store_true")
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
    if args.replicate:
        out = drive_replicate(args.tasks, args.nodes, device=args.device)
    elif args.replicate_cost:
        out = replicate_cost(args.tasks, args.nodes, device=args.device)
    elif args.whatif:
        out = drive_whatif(args.tasks, args.nodes, device=args.device, profile=args.profile)
    elif args.features:
        # chip_smoke's shares: 4 % of the pods claim a PV, 0.1 % a missing one
        out = drive_features(args.tasks, args.nodes, round(0.04 * args.tasks),
                             max(1, round(0.001 * args.tasks)), device=args.device,
                             hold_first=True)
    elif args.loop:
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
