"""The virtual-time cluster simulator: event-driven workload replay over
the REAL Scheduler/SchedulerCache.

Each virtual cycle: (1) all due events apply to the cache through the
ordinary ingest surface (add_pod/update_pod/add_node — the event-handler
path a live watch stream feeds), (2) the real L1 `Scheduler.run_once()`
executes the configured action pipeline, (3) binder/evictor acks drain
from the simulated kubelet and schedule lifecycle follow-ups on the event
heap, (4) longitudinal metrics sample the cache, (5) the virtual clock
advances one schedule period. No apiserver, no wall-clock waits, no
sampling during the run — same seed, byte-identical trace.

`python -m kube_batch_tpu_torch.sim --seed 7 --preset smoke` is the CLI front.

`--pipelined` switches the loop to the event-driven pacing of the L1
pipeline: cycles run at arrival events (floored by the config's
`min_period`, capped by the idle `period`) through the REAL staged cycle
body — run_once_pipelined + the writeback worker, joined per cycle so the
trace stays seed-deterministic.  The report's `pod_bind_latency_vt` is
then the arrival→decision latency the event trigger optimizes; compare
against the serial run of the same preset/seed.

Mirrors ``kube_batch_tpu/sim/runner.py``: the same presets, the same event
order, the same report.  What differs is the port's own: ``SimRunner`` and
``run_preset`` take ``device`` (``None`` means CUDA and raises without a
card), the allocate action is read off the scheduler's own action list
(the port's registry builds a fresh action per scheduler), the writeback
worker is retired through ``Scheduler.close()``, the cache's workers stop
when the run ends, and ``SimRunner`` takes ``mesh=`` (the Scheduler's,
``parallel/mesh.py``): a sharded run's report carries
``solve_collectives`` (``parallel/mesh.collective_stats`` at the JAX
package's abstract shapes of the store's capacities), as the JAX
package's does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from kube_batch_tpu_torch import metrics as prom_metrics
from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Node, Pod, PodGroup, Queue
from kube_batch_tpu_torch.api.types import PodPhase, TaskStatus, is_allocated
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.framework.conf import parse_scheduler_conf
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.sim import events as ev
from kube_batch_tpu_torch.sim import kubelet as kl
from kube_batch_tpu_torch.sim import workload
from kube_batch_tpu_torch.sim.clock import EventHeap, VirtualClock
from kube_batch_tpu_torch.sim.events import SimEvent, TraceRecorder
from kube_batch_tpu_torch.k8s.transport import CircuitBreaker, GuardedBackend
from kube_batch_tpu_torch.sim.faults import (
    BUSIEST,
    FaultInjector,
    bind_fail_script,
    brownout_script,
    corruption_script,
    leader_failover_script,
    node_crash_script,
    watch_flap_script,
)
from kube_batch_tpu_torch.sim.metrics import LongitudinalMetrics
from kube_batch_tpu_torch.testing.synthetic import GiB

SIM_NS = workload.SIM_NS


@dataclasses.dataclass
class SimConfig:
    """One simulation scenario. Everything that shapes the run is here (and
    is echoed into the report) so a config + seed IS the experiment."""

    seed: int = 0
    # cluster
    n_nodes: int = 6
    node_cpu: float = 16000.0
    node_mem: float = 64 * GiB
    node_pods: float = 110.0
    queues: Tuple[Tuple[str, int], ...] = (("q0", 1), ("q1", 2))
    # loop
    cycles: int = 60
    period: float = 1.0
    # None → the SHIPPED 5-action conf (enqueue, reclaim, allocate,
    # backfill, preempt), like the e2e driver — NOT the built-in 2-action
    # fallback: without the enqueue action a job that misses its first
    # cycle is written back PodGroupPending and the allocate gate then
    # skips it forever (allocate.go:50-52 / enqueue.go:66,115)
    conf_text: Optional[str] = None
    # workload (poisson unless `arrivals` is given explicitly)
    n_jobs: int = 16
    arrival_rate: float = 2.0
    gang_sizes: Tuple[int, ...] = (1, 2, 4)
    duration_range: Tuple[float, float] = (3.0, 12.0)
    start_latency: float = 0.5
    arrivals: Optional[List[SimEvent]] = None  # pre-built / trace-driven
    # event-driven pipelined pacing (the L1 loop's CycleTrigger under
    # virtual time): instead of ticking every `period`, the next cycle runs
    # at the earliest pending event, floored by `min_period` (burst
    # coalescing) and capped by `period` (the idle tick).  The cycle BODY is
    # the real pipelined one (staged close + writeback worker), joined per
    # cycle so the trace stays seed-deterministic; what virtual time
    # measures is the TRIGGER policy — arrival→decision latency — while the
    # wall-clock bench measures the overlap gain.
    pipelined: bool = False
    min_period: float = 0.05
    # column-capacity reservation (ColumnStore.reserve) — the corruption
    # preset reserves a task bucket big enough that the KB_TOPK compacted
    # path ENGAGES (capT ≥ 1024 → a 256-row pending bucket), so the
    # guard's demotion/re-promotion machinery has a real fast path to act
    # on at sim scale
    reserve_tasks: int = 0
    reserve_nodes: int = 0
    reserve_jobs: int = 0
    # faults
    faults: Tuple[SimEvent, ...] = ()
    evict_delay: float = 1.0
    # whether an evicted replica is recreated Pending by the job controller
    # (True models a Job/ReplicaSet owner; False mirrors the reference e2e's
    # bare pods, where eviction is deletion — and avoids the re-claim race
    # in which the recreated victim outranks the preemptor forever)
    evict_recreates: bool = False


def preset(name: str, seed: int = 0) -> SimConfig:
    """Named scenarios. `smoke` is the tier-1-sized run; `fault` crashes
    the busiest node under long-running gangs and must end with the
    displaced gangs re-placed; `churn` layers binder failures and a watch
    flap over the smoke workload (repair-path coverage).

    Chaos presets (fault-hardening evidence): `brownout` fails every
    egress call for a window — the breaker opens and the degraded cycle
    must keep ticking; `bind-storm` lands hundreds of gang pods while the
    binder flaps — zero lost/duplicate binds, bounded arrival→bind p99;
    `leader-failover` loses leadership mid-run — the warm standby must
    keep the resident device cache (no recompile/re-upload)."""
    if name == "smoke":
        return SimConfig(seed=seed)
    if name == "fault":
        # 3 gangs of 4×4000m on 4×16000m nodes: ≥3 nodes carry pods, every
        # pod runs for the whole horizon — the busiest node crashing at
        # t=8 displaces at least one full gang member set
        return SimConfig(
            seed=seed,
            n_nodes=4, node_cpu=16000.0,
            queues=(("q0", 1),),
            cycles=40, n_jobs=0,
            arrivals=workload.fixed_gangs(
                t=0.5, n_gangs=3, gang_size=4, cpu=4000.0, mem=2 * GiB,
                duration=200.0, queues=("q0",),
            ),
            faults=tuple(node_crash_script(
                t=8.0, node=BUSIEST, down_for=12.0, pod_fail_after=1.0
            )),
        )
    if name == "churn":
        cfg = SimConfig(seed=seed, cycles=80)
        cfg.faults = (
            *bind_fail_script(3.0, count=3),
            *watch_flap_script(9.0),
        )
        return cfg
    if name == "warm-churn":
        # the KB_WARM A/B scale: big enough that the compacted
        # allocate engages (task capacity past the smallest pending-bucket
        # rung, node capacity past the K width) with sustained gang churn
        # so the carried candidate table actually merges across cycles —
        # the --warm-ab leg runs this twice and bit-compares every bind
        cfg = SimConfig(seed=seed, cycles=60, n_nodes=40,
                        n_jobs=350, arrival_rate=10.0,
                        gang_sizes=(4, 6, 8),
                        duration_range=(6.0, 14.0))
        return cfg
    if name == "brownout":
        # apiserver brownout mid-workload: every egress call fails for a
        # window — the breaker must open, the degraded cycle must park
        # decisions and KEEP TICKING, and the workload must still drain
        # after the window (recovery through the resync backoff queue)
        cfg = SimConfig(seed=seed, cycles=90, n_jobs=12, arrival_rate=1.5)
        cfg.faults = tuple(brownout_script(6.0, duration=8.0))
        return cfg
    if name == "bind-storm":
        # hundreds of gang pods arrive in a tight burst while the binder
        # flaps (injected failures + a short brownout): the recovery
        # invariants are zero lost/duplicate binds and a bounded
        # pod-arrival→bind p99 despite the flapping
        # Job-controller semantics (evict_recreates): under storm pressure
        # preempt legitimately evicts singletons to start starving gangs —
        # with bare-pod semantics those victims would be DELETED and the
        # drain invariant (every submitted gang completes) could not hold
        arrivals = workload.poisson_arrivals(
            seed=seed, n_jobs=120, rate=30.0, queues=["q0"],
            gang_sizes=(1, 2, 4), duration_range=(2.0, 6.0),
            start_latency=0.25,
        )
        cfg = SimConfig(
            seed=seed, n_nodes=10, cycles=140, n_jobs=0, arrivals=arrivals,
            queues=(("q0", 1),), evict_recreates=True,
            faults=(
                *bind_fail_script(2.0, count=3),
                *brownout_script(4.0, duration=3.0),
                *bind_fail_script(12.0, count=2),
            ),
        )
        return cfg
    if name == "leader-failover":
        # leadership loss mid-run: the warm standby takes over through
        # cache.failover_recover — pod-store rebuild + resident-cache
        # revalidation — and must keep the device-resident buffers (no
        # full recompile/re-upload) while the workload drains normally
        cfg = SimConfig(seed=seed, cycles=70, n_jobs=14, arrival_rate=1.2)
        cfg.faults = tuple(leader_failover_script(9.0))
        return cfg
    if name == "corruption":
        # result-integrity chaos (the guard plane's acceptance preset):
        # three resident-DEVICE-column corruptions land mid-run — a zeroed
        # capacity word, a NaN score input, a flipped pending bit on a
        # RUNNING row — while the host truth stays intact.  Invariants the
        # CLI enforces: ZERO bad binds dispatched (no duplicate binds, no
        # accounting drift — every condemned solve failed closed),
        # demotion engages on trip, re-promotion recovers after the
        # cooldown, and a diagnostics bundle lands for --replay-bundle.
        # The reserved task bucket makes KB_TOPK engage at sim scale so
        # demotion has a real fast path to act on.
        cfg = SimConfig(
            seed=seed, n_nodes=4, node_cpu=8000.0, queues=(("q0", 1),),
            cycles=60, n_jobs=30, arrival_rate=0.75, gang_sizes=(1, 2),
            duration_range=(6.0, 18.0),
            reserve_tasks=1024, reserve_nodes=64,
        )
        cfg.faults = (
            *corruption_script(3.3, "ledger"),
            *corruption_script(16.3, "score"),
            # deliberately INSIDE the score trip's demotion window: with
            # KB_TOPK demoted the full-matrix program runs, which is the
            # path a flipped pending bit can actually steer into a
            # duplicate bind — the host pending cross-check must catch it
            *corruption_script(19.3, "pending"),
        )
        return cfg
    raise KeyError(
        f"unknown preset {name!r} (smoke | fault | churn | brownout | "
        "bind-storm | leader-failover | corruption)")


class SimRunner:
    def __init__(self, cfg: SimConfig, device=None, mesh=None):
        self.cfg = cfg
        self.clock = VirtualClock()
        self.heap = EventHeap()
        self.trace = TraceRecorder()
        self.metrics = LongitudinalMetrics()
        self.kubelet = kl.SimKubelet()
        # the kubelet rides the REAL transport circuit breaker (paced by the
        # virtual clock): a brownout opens it exactly like a production
        # apiserver outage would, and the cache's degraded path parks
        # decisions instead of hammering the failing egress
        self.breaker = CircuitBreaker(
            threshold=3, cooldown=2.5, clock=self.clock.monotonic,
            name="sim-apiserver",
        )
        guard = GuardedBackend(self.kubelet, self.breaker)
        self.cache = SchedulerCache(binder=guard, evictor=guard)
        if cfg.reserve_tasks or cfg.reserve_nodes or cfg.reserve_jobs:
            self.cache.columns.reserve(
                n_tasks=cfg.reserve_tasks, n_nodes=cfg.reserve_nodes,
                n_jobs=cfg.reserve_jobs,
            )
        if cfg.conf_text:
            conf = parse_scheduler_conf(cfg.conf_text)
        else:
            from kube_batch_tpu_torch.framework.conf import (
                load_scheduler_conf, shipped_conf_path)

            conf = load_scheduler_conf(shipped_conf_path())
        # the sim drives run_once() itself, but the injected clock also
        # makes run_forever() pace in virtual time if a caller wants it
        self.scheduler = Scheduler(
            self.cache, conf=conf, schedule_period=cfg.period,
            clock=self.clock, device=device, mesh=mesh,
        )
        # the configured allocate action, whose per-cycle records
        # (last_topk, last_warm) the longitudinal counters read
        self._allocate = next(
            (a for a in self.scheduler.actions if a.name == "allocate"), None)
        self.faults = FaultInjector(self)
        # per-pod lifecycle info: key → {job, duration, start_latency}
        self.pod_info: Dict[str, Dict] = {}
        self.job_tasks: Dict[str, set] = {}      # job uid → pod keys
        self.job_succeeded: Dict[str, set] = {}  # job uid → succeeded keys
        self._creation = itertools.count(1)
        self._reincarnation: Dict[str, int] = {}
        # bind-integrity bookkeeping: when each incarnation went Pending
        # (pod-arrival→bind latency) and which (key, uid) incarnations have
        # already been ack'd (a second ack = a duplicate bind — always a bug)
        self.pending_since: Dict[str, float] = {}
        self.bound_uids: set = set()
        self.duplicate_binds = 0
        self.failover_events: List[Dict] = []
        # KB_TOPK candidate-compaction longitudinal counters
        self.topk_cycles = 0
        self.topk_exhausted = 0
        self.topk_reentries = 0
        self.topk_k = 0
        # warm-carry accumulators
        self.warm_cycles = 0
        self.warm_cold = 0
        self.warm_reranked = 0
        self.warm_changed = 0
        self.warm_live = 0
        # order-exact digest of every acked (pod, node) bind — the
        # KB_WARM A/B leg's decision-equality receipt (same seed + a
        # bit-exact fast path ⇒ identical digest)
        self._bind_hash = hashlib.sha256()

    # ---- shared lookups --------------------------------------------------
    def job_of_pod(self, key: str) -> Optional[str]:
        info = self.pod_info.get(key)
        return info["job"] if info else None

    # ---- leader failover (warm standby) ----------------------------------
    def failover(self) -> Dict:
        """The LEADER_FAILOVER fault's body: the warm standby takes over via
        the real recovery path. Resident counters are snapshotted before,
        so the report can prove the no-recompile/no-re-upload invariant
        (full_uploads flat on the warm path)."""
        before = {p: dict(c)
                  for p, c in self.cache.columns.resident_counters().items()}
        report = self.cache.failover_recover()
        report["t"] = self.clock.now()
        report["resident_before"] = before
        self.failover_events.append(report)
        return report

    # ---- setup -----------------------------------------------------------
    def _setup(self) -> None:
        cfg = self.cfg
        for qname, weight in cfg.queues:
            self.cache.add_queue(Queue(name=qname, uid=f"sim-q-{qname}",
                                       weight=weight))
            self.trace.record(SimEvent(0.0, "queue-add",
                                       {"name": qname, "weight": weight}))
        for i in range(cfg.n_nodes):
            name = f"sim-n{i}"
            self.cache.add_node(Node(
                name=name,
                allocatable={"cpu": cfg.node_cpu, "memory": cfg.node_mem,
                             "pods": cfg.node_pods},
            ))
            self.trace.record(SimEvent(0.0, "node-add", {"name": name}))
        arrivals = cfg.arrivals
        if arrivals is None:
            arrivals = workload.poisson_arrivals(
                seed=cfg.seed, n_jobs=cfg.n_jobs, rate=cfg.arrival_rate,
                queues=[q for q, _ in cfg.queues],
                gang_sizes=cfg.gang_sizes,
                duration_range=cfg.duration_range,
                start_latency=cfg.start_latency,
            )
        self.heap.push_all(arrivals)
        self.heap.push_all(SimEvent(e.time, e.kind, dict(e.data))
                           for e in cfg.faults)

    # ---- event application ----------------------------------------------
    def _apply(self, event: SimEvent) -> None:
        if event.kind in ev.FAULT_KINDS:
            self.faults.apply(event)  # records its own (resolved) trace
            return
        handler = {
            ev.JOB_ARRIVAL: self._on_job_arrival,
            ev.POD_RUNNING: self._on_pod_running,
            ev.POD_SUCCEEDED: self._on_pod_succeeded,
            ev.POD_FAILED: self._on_pod_failed,
            ev.EVICT_TERMINATED: self._on_evict_terminated,
        }[event.kind]
        handler(event)

    def _on_job_arrival(self, event: SimEvent) -> None:
        d = event.data
        job_uid = f"{d['namespace']}/{d['name']}"
        self.cache.add_pod_group(PodGroup(
            name=d["name"], namespace=d["namespace"],
            uid=f"sim-pg-{d['name']}",
            min_member=d["min_member"], queue=d["queue"],
            creation_index=next(self._creation),
        ))
        keys = set()
        for t in d["tasks"]:
            pod = Pod(
                name=t["name"], namespace=d["namespace"],
                uid=f"sim-pod-{t['name']}-r0",
                requests={"cpu": t["cpu"], "memory": t["mem"]},
                annotations={GROUP_NAME_ANNOTATION: d["name"]},
                phase=PodPhase.PENDING,
                priority=int(t.get("priority", 0)),
                creation_index=next(self._creation),
            )
            key = pod.key()
            keys.add(key)
            self.pod_info[key] = {
                "job": job_uid,
                "duration": t["duration"],
                "start_latency": t["start_latency"],
            }
            self.pending_since[key] = event.time
            self.cache.add_pod(pod)
        self.job_tasks[job_uid] = keys
        self.job_succeeded[job_uid] = set()
        self.metrics.note_arrival(job_uid, event.time)
        self.trace.record(event)

    def _stale(self, event: SimEvent) -> bool:
        """Lifecycle events are pinned to a pod INCARNATION by uid: a heap
        event queued for an incarnation that has since been crash-lost or
        evicted and recreated must not fire against its successor (the
        stale first-life POD_SUCCEEDED would complete the rerun early, and
        a stale POD_RUNNING would start the recreated pod on its old,
        possibly still-crashed node)."""
        stored = self.cache.pods.get(event.data["key"])
        return stored is None or stored.uid != event.data["uid"]

    def _on_pod_running(self, event: SimEvent) -> None:
        key = event.data["key"]
        if self._stale(event):
            return  # lost to a crash/eviction while starting
        if not kl.set_running(self.cache, key, event.data["node"]):
            return
        self.trace.record(event)
        info = self.pod_info[key]
        self.heap.push(SimEvent(event.time + info["duration"],
                                ev.POD_SUCCEEDED,
                                {"key": key, "uid": event.data["uid"]}))

    def _on_pod_succeeded(self, event: SimEvent) -> None:
        key = event.data["key"]
        if self._stale(event) or not kl.set_succeeded(self.cache, key):
            return
        self.trace.record(event)
        job = self.job_of_pod(key)
        if job is None:
            return
        done = self.job_succeeded.setdefault(job, set())
        done.add(key)
        if done >= self.job_tasks.get(job, set()):
            self._complete_job(job, event.time)

    def _complete_job(self, job_uid: str, t: float) -> None:
        self.metrics.note_completion(job_uid, t)
        for key in sorted(self.job_tasks.get(job_uid, ())):
            kl.delete_pod(self.cache, key)
        self.cache.delete_pod_group(job_uid)
        self.trace.record(SimEvent(t, ev.JOB_COMPLETE, {"job": job_uid}))

    def _reincarnate(self, key: str, t: float, kind: str, node: str = "") -> None:
        """Crash-lost / evicted replica → the job controller recreates it
        as a fresh Pending pod (deterministic reincarnated uid)."""
        n = self._reincarnation.get(key, 0) + 1
        self._reincarnation[key] = n
        name = key.split("/", 1)[1]
        data = {"key": key, "reincarnation": n}
        if node:
            data["node"] = node
        if kl.replace_pending(self.cache, key, f"sim-pod-{name}-r{n}",
                              next(self._creation)):
            job = self.job_of_pod(key)
            if job is not None:
                self.job_succeeded.get(job, set()).discard(key)
            self.pending_since[key] = t  # fresh incarnation awaits its bind
            self.trace.record(SimEvent(t, kind, data))

    def _on_pod_failed(self, event: SimEvent) -> None:
        self._reincarnate(event.data["key"], event.time, ev.POD_FAILED,
                          event.data.get("node", ""))

    def _on_evict_terminated(self, event: SimEvent) -> None:
        key = event.data["key"]
        if self._stale(event):
            return  # the evicted incarnation is already gone
        if self.cfg.evict_recreates:
            self._reincarnate(key, event.time, ev.EVICT_TERMINATED)
            return
        if not kl.delete_pod(self.cache, key):
            return
        self.trace.record(SimEvent(event.time, ev.EVICT_TERMINATED,
                                   {"key": key, "deleted": True}))
        job = self.job_of_pod(key)
        if job is None:
            return
        tasks = self.job_tasks.get(job)
        if tasks is None:
            return
        tasks.discard(key)
        done = self.job_succeeded.get(job, set())
        done.discard(key)
        if tasks and done >= tasks:
            self._complete_job(job, event.time)

    # ---- per-cycle observation ------------------------------------------
    def _drain_kubelet(self, now: float) -> None:
        binds, evicts = self.kubelet.drain()
        for key, node in binds:
            self._bind_hash.update(f"{key}->{node};".encode())
            self.trace.record(SimEvent(now, ev.BIND,
                                       {"key": key, "node": node}))
            info = self.pod_info.get(key)
            if info is None:
                continue
            self.metrics.note_bind(info["job"], now)
            since = self.pending_since.pop(key, None)
            if since is not None:
                self.metrics.note_pod_bind_latency(now - since)
            stored = self.cache.pods.get(key)
            if stored is not None:
                tag = (key, stored.uid)
                if tag in self.bound_uids:
                    self.duplicate_binds += 1
                    # a duplicate bind is ALWAYS a bug — capture the cycle
                    # traces around it for offline triage
                    flight = getattr(self.cache, "flight_recorder", None)
                    if flight is not None:
                        flight.trigger(
                            "duplicate_bind",
                            detail=f"pod {key} uid {stored.uid}",
                        )
                else:
                    self.bound_uids.add(tag)
            if stored is not None:
                # uid pins the follow-up to THIS incarnation (see _stale)
                self.heap.push(SimEvent(
                    now + info["start_latency"], ev.POD_RUNNING,
                    {"key": key, "node": node, "uid": stored.uid},
                ))
        for key in evicts:
            self.trace.record(SimEvent(now, ev.EVICT, {"key": key}))
            self.metrics.note_eviction()
            stored = self.cache.pods.get(key)
            if stored is not None:
                self.heap.push(SimEvent(
                    now + self.cfg.evict_delay, ev.EVICT_TERMINATED,
                    {"key": key, "uid": stored.uid},
                ))

    def _queue_shares(self) -> Dict[str, Dict]:
        total = np.zeros(self.cache.spec.n)
        for node in self.cache.nodes.values():
            total += node.allocatable.vec
        alloc: Dict[str, np.ndarray] = {
            q: np.zeros(self.cache.spec.n) for q, _ in self.cfg.queues
        }
        for job in self.cache.jobs.values():
            if job.queue in alloc:
                alloc[job.queue] += job.allocated.vec
        weights = dict(self.cfg.queues)
        wsum = sum(weights.values()) or 1
        nz = total > 0
        out = {}
        for q, _ in self.cfg.queues:
            share = float(np.max(alloc[q][nz] / total[nz])) if nz.any() else 0.0
            out[q] = {
                "share": round(share, 6),
                "entitlement": round(weights[q] / wsum, 6),
            }
        return out

    def _task_counts(self) -> Tuple[int, int]:
        pending = running = 0
        for job in self.cache.jobs.values():
            pending += len(job.task_status_index.get(TaskStatus.PENDING, {}))
            running += len(job.task_status_index.get(TaskStatus.RUNNING, {}))
        return pending, running

    # ---- the loop --------------------------------------------------------
    def _one_cycle(self) -> Tuple[int, int]:
        """Apply due events, run one scheduling cycle (serial or pipelined
        body per the config), drain the kubelet, sample the longitudinal
        metrics.  Returns (pending, running) task counts."""
        now = self.clock.now()
        for event in self.heap.pop_due(now):
            self._apply(event)
        if self.cfg.pipelined:
            # the real staged cycle — close stages the flush, the writeback
            # worker runs it — joined immediately so binder acks land before
            # the kubelet drain and the trace stays byte-deterministic
            self.scheduler.run_once_pipelined()
            self.scheduler.drain_pipeline()
        else:
            self.scheduler.run_once()  # flushes async binds at its end
        self._drain_kubelet(now)
        # candidate-compaction longitudinal counters: presets prove K is
        # sized right when the exhaustion/full-head-re-entry totals stay
        # near zero over the whole scenario
        topk = getattr(self._allocate, "last_topk", None)
        if topk is not None:
            self.topk_cycles += 1
            self.topk_exhausted += topk.get("exhausted", 0)
            self.topk_reentries += topk.get("reentries", 0)
            self.topk_k = topk.get("k", self.topk_k)
        # warm-carry longitudinal counters: cycles the carried table
        # served, cold rebuilds, and the invalidation volume
        warm = getattr(self._allocate, "last_warm", None)
        if warm is not None:
            self.warm_cycles += 1
            if warm.get("cold"):
                self.warm_cold += 1
            self.warm_reranked += warm.get("reranked", 0)
            self.warm_changed += warm.get("changed", 0)
            self.warm_live += warm.get("bucket_live", 0)
        pending, running = self._task_counts()
        shares = self._queue_shares()
        # surface the longitudinal fairness series live: the same
        # per-queue share/entitlement samples the report aggregates are
        # exported as volcano_queue_* gauges, so a /metrics scrape of a
        # sim-driven (or production) process sees the current window
        prom_metrics.set_queue_shares(shares)
        self.metrics.note_cycle(
            now, shares, pending, running,
            snapshot_path=(
                f"{self.cache.last_open_path}"
                f"/{self.cache.columns.last_snapshot_path}"
            ),
            churn=self.cache.last_churn,
        )
        return pending, running

    def _drained(self, pending: int) -> bool:
        submitted = len(self.metrics.arrivals)
        return (not self.heap and pending == 0 and submitted > 0
                and len(self.metrics.completions) == submitted)

    def run(self) -> Dict:
        """Drive the scenario to its end and return the report; the cache's
        workers are stopped when it returns (its state stays readable)."""
        try:
            return self._run()
        finally:
            self.cache.stop()

    def _run(self) -> Dict:
        self._setup()
        cfg = self.cfg
        cycles_run = 0
        if cfg.pipelined:
            # event-driven pacing over the SAME virtual horizon as the
            # serial run (cycles × period): wake at the earliest pending
            # event, floored by min_period, capped by the idle period — the
            # CycleTrigger's semantics computed from the event heap (a
            # virtual clock has no condition variable to block on).  The
            # iteration cap bounds a pathological event stream.
            horizon = cfg.cycles * cfg.period
            max_cycles = cfg.cycles * max(
                2, int(round(cfg.period / max(cfg.min_period, 1e-6)))
            )
            try:
                while cycles_run < max_cycles:
                    pending, _ = self._one_cycle()
                    cycles_run += 1
                    if self._drained(pending):
                        break
                    now = self.clock.now()
                    nxt = self.heap.next_time()
                    if nxt is None:
                        step = cfg.period       # idle: tick at the slow floor
                    else:
                        step = min(max(nxt - now, cfg.min_period), cfg.period)
                    if now + step > horizon:
                        break
                    self.clock.sleep(step)
            finally:
                # the per-cycle drain already joined every stage; retire the
                # writeback worker so runners don't leak worker threads
                self.scheduler.close()
        else:
            for _ in range(cfg.cycles):
                pending, _ = self._one_cycle()
                cycles_run += 1
                if self._drained(pending):
                    break  # workload fully drained — nothing left to simulate
                self.clock.sleep(cfg.period)
        return self._finalize(cycles_run)

    # ---- end-of-run checks ----------------------------------------------
    def _invariant_errors(self) -> List[str]:
        errs = list(self.cache.columns.check_consistency(self.cache))
        for name, node in self.cache.nodes.items():
            if not np.allclose(node.idle.vec + node.used.vec,
                               node.allocatable.vec):
                errs.append(f"node {name} accounting drift: "
                            f"idle+used != allocatable")
            resident = np.zeros(self.cache.spec.n)
            for task in node.tasks.values():
                # RELEASING occupies `used` too (eviction in flight keeps
                # the capacity charged until the pod terminates,
                # node_info.py add_task); PIPELINED would not, but it is
                # session-only state reverted at close — never resident here
                if is_allocated(task.status) or (
                        task.status == TaskStatus.RELEASING):
                    resident += task.resreq.vec
            if not np.allclose(resident, node.used.vec):
                errs.append(f"node {name} used != Σ resident resreq")
        return errs

    def _fault_recovery(self) -> Optional[Dict]:
        displaced = sorted(self.faults.displaced_jobs)
        if not displaced and not self.faults.crashed_nodes:
            return None
        detail = {}
        all_ok = True
        for uid in displaced:
            job = self.cache.jobs.get(uid)
            if uid in self.metrics.completions:
                detail[uid] = "completed"
            elif job is not None and job.ready():
                detail[uid] = "re-placed"
            else:
                detail[uid] = "NOT re-placed"
                all_ok = False
        return {
            "displaced_jobs": detail,
            "recovered": all_ok,
            "nodes_still_down": sorted(self.faults.crashed_nodes),
        }

    def _finalize(self, cycles_run: int) -> Dict:
        report = self.metrics.report()
        cfg = self.cfg
        # per-cycle device-resident scatter counters (api/resident.py), per
        # solve path — the longitudinal twin of the bench's delta-vs-full
        # bytes-moved evidence
        from kube_batch_tpu_torch.api.resident import scatter_summary

        scatter = scatter_summary(self.cache.columns.resident_counters())
        # a sharded run carries the solve's collective bytes per round and
        # per solve beside the scatter counters
        solve_collectives = None
        mesh = self.scheduler.mesh
        if "sharded" in scatter and mesh is not None:
            from kube_batch_tpu_torch.parallel.mesh import collective_stats, shard_map_enabled

            if shard_map_enabled():
                cols = self.cache.columns
                solve_collectives = collective_stats(
                    mesh, shape=dict(T=cols.tasks.cap, N=cols.nodes.cap, R=cols.R))
        # cycle tracing plane: publish any still-armed flight dumps (a
        # trigger near the end of the horizon must not lose its capture)
        # and carry the SEED-STABLE stage-attribution summary — span
        # counts per stage + attributed retraces are functions of the
        # event stream, so they reproduce per seed like the trace hash
        tracer = getattr(self.cache, "tracer", None)
        flight = getattr(self.cache, "flight_recorder", None)
        if flight is not None:
            flight.flush()
        report.update({
            "unit": "virtual_seconds",
            "seed": cfg.seed,
            "cycle_mode": "pipelined" if cfg.pipelined else "serial",
            "cycles_run": cycles_run,
            "resident_scatter": scatter,
            **({"stage_attribution": tracer.stage_attribution()}
               if tracer is not None and tracer.enabled else {}),
            # candidate-compaction longitudinal evidence: how many cycles
            # ran compacted, and whether K was sized right (exhaustion /
            # re-entry totals near zero over the whole scenario)
            "topk": {
                "compacted_cycles": self.topk_cycles,
                "k": self.topk_k,
                "exhausted_total": self.topk_exhausted,
                "reentries_total": self.topk_reentries,
            },
            # warm-carry longitudinal evidence: how many cycles
            # the carried candidate table served, cold rebuilds, and the
            # invalidated-row fraction over the scenario — the KB_WARM A/B
            # leg (--warm-ab) additionally bit-compares bind_digest
            "warm": {
                "warm_cycles": self.warm_cycles,
                "cold_builds": self.warm_cold,
                "reranked_total": self.warm_reranked,
                "changed_total": self.warm_changed,
                "invalidated_row_fraction": (
                    round(self.warm_reranked / self.warm_live, 4)
                    if self.warm_live else None
                ),
            },
            **({"solve_collectives": solve_collectives}
               if solve_collectives is not None else {}),
            # fault-hardening evidence: bind integrity (no lost/duplicate
            # binds), the egress breaker's life, the repair queue's story
            "bind_integrity": {
                "acked_binds": self.kubelet.binds_total,
                "unique_pods_bound": len(self.bound_uids),
                "duplicate_binds": self.duplicate_binds,
            },
            "transport": {
                "breaker_state": self.breaker.state,
                "breaker_transitions": dict(self.breaker.transitions),
            },
            "resync": self.cache.resync.stats(),
            "config": {
                "n_nodes": cfg.n_nodes,
                "queues": list(map(list, cfg.queues)),
                "cycles": cfg.cycles,
                "period": cfg.period,
                "min_period": cfg.min_period if cfg.pipelined else None,
                "n_jobs_poisson": cfg.n_jobs if cfg.arrivals is None else 0,
                "faults": [e.kind for e in cfg.faults],
            },
            "invariants": {"errors": self._invariant_errors()},
            "bind_failures_injected": self.kubelet.bind_failures,
            "trace_events": len(self.trace),
            "trace_sha256": self.trace.sha256(),
            # decision receipt: the order-exact digest of every acked
            # bind — two runs that scheduled identically share it (the
            # --warm-ab leg's comparison point)
            "bind_digest": self._bind_hash.hexdigest(),
        })
        recovery = self._fault_recovery()
        if recovery is not None:
            report["fault_recovery"] = recovery
        failover = self._failover_report(scatter)
        if failover is not None:
            report["failover"] = failover
        guard = self._guard_report(report)
        if guard is not None:
            report["guard"] = guard
        return report

    def _guard_report(self, report) -> Optional[Dict]:
        """The result-integrity guard plane's longitudinal evidence.  On a
        corruption run, ``chaos_ok`` is the CLI's exit-code invariant:
        every injected corruption tripped the sentinel, every condemned
        solve failed closed (zero bad binds — no duplicate bind acks, no
        accounting drift), demotion engaged, re-promotion recovered after
        the cooldown, and a diagnostics bundle landed for
        ``--replay-bundle``."""
        gp = getattr(self.cache, "guard_plane", None)
        if gp is None:
            return None
        state = gp.state()
        state["corruptions_injected"] = self.faults.corruptions_applied
        state["trip_log"] = list(gp.trip_log)
        # trip-rate SLO alerting (obs/alerts) + the flight-recorder dumps
        # the trips triggered — both part of the corruption acceptance
        alert_ev = getattr(self.cache, "alert_evaluator", None)
        if alert_ev is not None:
            state["alerts"] = alert_ev.state()
        tracer = getattr(self.cache, "tracer", None)
        flight = getattr(self.cache, "flight_recorder", None)
        trace_on = tracer is not None and tracer.enabled
        if flight is not None:
            state["flight_dumps"] = list(flight.dumps)
        if self.faults.corruptions_applied:
            paths = state["paths"].values()
            alert_fired = bool(
                alert_ev is not None
                and alert_ev.state()["alerts"]
                .get("guard_trips", {}).get("fired_total", 0) >= 1
            )
            state["chaos_ok"] = bool(
                state["trips_total"] >= self.faults.corruptions_applied
                and state["failed_closed"] >= 1
                and any(p["trips"] > 0 for p in paths)       # demotion engaged
                and any(p["promotions"] > 0 for p in paths)  # re-promoted
                and state["bundles"]
                and alert_fired                              # SLO alert fired
                # every trip armed a flight dump (trace plane on)
                and (not trace_on or state.get("flight_dumps"))
                and self.duplicate_binds == 0
                and not report["invariants"]["errors"]
            )
        return state

    def _failover_report(self, scatter_now: Dict) -> Optional[List[Dict]]:
        """Per-failover recovery evidence: how many cycles until the
        pending backlog drained again, and whether the resident device
        cache survived (full_uploads flat ⇒ no re-upload, warm path)."""
        if not self.failover_events:
            return None
        out = []
        for evr in self.failover_events:
            recovery_cycles = None
            n = 0
            for rec in self.metrics.fairness:
                if rec["t"] < evr["t"]:
                    continue
                n += 1
                if rec["pending"] == 0:
                    recovery_cycles = n
                    break
            uploads_delta = {
                path: (scatter_now.get(path, {}).get("full_uploads", 0)
                       - evr["resident_before"].get(path, {})
                       .get("full_uploads", 0))
                for path in scatter_now
            }
            out.append({
                "t": evr["t"],
                "mode": evr["mode"],
                "resident_tokens": evr["resident_tokens"],
                "recovery_cycles": recovery_cycles,
                "resident_full_uploads_delta": uploads_delta,
            })
        return out


def run_preset(name: str, seed: int = 0, cycles: Optional[int] = None,
               trace_path: Optional[str] = None,
               pipelined: bool = False,
               chrome_trace_path: Optional[str] = None,
               device=None, mesh=None) -> Dict:
    """One-call entrypoint used by the CLI and the tests; ``device=None``
    means CUDA; ``mesh`` runs the solves sharded."""
    cfg = preset(name, seed=seed)
    if cycles is not None:
        cfg.cycles = cycles
    cfg.pipelined = pipelined
    runner = SimRunner(cfg, device=device, mesh=mesh)
    report = runner.run()
    report["metric"] = f"sim_{name}_makespan_vt"
    report["value"] = report.get("makespan_vt")
    report["preset"] = name
    if trace_path:
        runner.trace.write(trace_path)
        report["trace_path"] = trace_path
    if chrome_trace_path:
        # export the flight-recorder ring (the whole run at sim scale) as
        # Chrome trace-event JSON — chrome://tracing / Perfetto render it
        import json as _json

        from kube_batch_tpu_torch.obs.trace import chrome_trace

        flight = getattr(runner.cache, "flight_recorder", None)
        records = flight.records() if flight is not None else []
        with open(chrome_trace_path, "w") as f:
            _json.dump(chrome_trace(records), f)
        report["chrome_trace_path"] = chrome_trace_path
    return report
