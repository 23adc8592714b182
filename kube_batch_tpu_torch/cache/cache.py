"""SchedulerCache — the host-side cluster mirror (pkg/scheduler/cache).

Mirrors ``kube_batch_tpu/cache/cache.py`` (the reference's cache.go:71-736
and event_handlers.go): an in-memory image of pods, nodes, PodGroups,
queues and priority classes, fed by event-handler calls, with bind and
evict egress through pluggable Binder and Evictor seams and the
close-time job-status pass.  The cache owns the persistent
``ColumnStore`` (``api/columns.py``); every ingest handler binds or frees
its rows.

While a scheduling cycle holds the exclusive session gate
(``begin_exclusive_session``), ingest is deferred and applied in order at
``end_exclusive_session`` — the once-per-cycle staleness an informer
snapshot has, without a deep clone.

Every ingest handler and the close-time status staging stamp the dirty
tracker (``cache/dirty.py``); ``take_dirty``, ``session_view_delta`` and
``rebuild_open_cache`` give ``open_session`` its delta form, which
re-derives only the jobs that changed since the last open
(``KB_SNAPSHOT_DELTA=0`` or ``cache.delta_enabled = False`` keeps the full
``session_view`` every cycle, the oracle).

What the JAX package has and this port does not (each is later work in
ROADMAP.md): the async binder pool (binds run inline here, which leaves
the state ``flush_binds`` leaves), the failed-write resync queue and
repair loop with its ``rebuild_from_pod_store`` (a failed bind or evict is
logged and left for the pod's next update or delete), staged and batched
ingest (so nothing holds the tracker's version), isolated sessions'
``snapshot()``, PodDisruptionBudgets, the volume ledger (the fake binder
seam stays), and the egress breakers.  The cache starts no thread.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Dict, List

import numpy as np

from kube_batch_tpu_torch.api.cluster_info import ClusterInfo
from kube_batch_tpu_torch.api.columns import ColumnStore
from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.pod import Node, Pod, PodGroup, PriorityClass, Queue
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.resources import DEFAULT_SPEC, ResourceSpec
from kube_batch_tpu_torch.api.task_info import TaskInfo, job_id_for_pod
from kube_batch_tpu_torch.api.types import (
    PodGroupPhase,
    TaskStatus,
    queue_phase_counts,
)
from kube_batch_tpu_torch.cache.dirty import DirtyTracker, OpenCache
from kube_batch_tpu_torch.cache.fake import (
    FakeBinder,
    FakeEvictor,
    FakeStatusUpdater,
    FakeVolumeBinder,
)
from kube_batch_tpu_torch.utils.assertions import graft_assert
from kube_batch_tpu_torch.utils.switches import switch_on

logger = logging.getLogger("kube_batch_tpu_torch")

#: retention of the cache's event record (the k8s recorder's queue is
#: bounded too; this is a diagnostic record, not a durable store)
MAX_EVENTS = 200_000


class StatusFlush:
    """One cycle's status egress, staged by ``stage_status_flush`` and
    written by ``run_status_flush``: PodGroup clones to write, rendered
    event / condition ops, and the decided queue writes."""

    __slots__ = ("to_write", "ops", "qwrites")

    def __init__(self, to_write, ops, qwrites):
        self.to_write = to_write
        self.ops = ops
        self.qwrites = qwrites


class SchedulerCache:
    def __init__(
        self,
        spec: ResourceSpec = DEFAULT_SPEC,
        scheduler_name: str = "volcano",
        default_queue: str = "default",
        binder=None,
        evictor=None,
        status_updater=None,
        volume_binder=None,
        resolve_priority: bool = True,
    ):
        self.spec = spec
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        # the persistent columnar host model: rows assigned at ingest,
        # ledgers shared as views, snapshots built from columns
        self.columns = ColumnStore(spec)
        # cross-cycle churn bookkeeping (cache/dirty.py): ingest handlers
        # stamp a version and per-kind dirty sets, so a low-churn session
        # open hands out a delta against the previous cycle's open state
        self.dirty = DirtyTracker()
        self.open_cache = OpenCache()
        # jobs carrying per-session fit diagnostics (Session.note_fit_state):
        # the delta open clears exactly these
        self.fit_state_jobs: set = set()
        self.delta_enabled = switch_on("KB_SNAPSHOT_DELTA")
        # fraction of session jobs dirty above which the open falls back to
        # the full rebuild
        self.delta_churn_threshold = float(
            os.environ.get("KB_DELTA_CHURN_THRESHOLD", "0.25"))
        # which path the most recent open took, its churn, and the tracker
        # version it consumed
        self.last_open_path = "full"
        self.last_churn = 0.0
        self.last_open_version = 0
        # --priority-class toggle (options.go:30, consumed cache.go:352,378)
        self.resolve_priority = resolve_priority
        self.binder = binder if binder is not None else FakeBinder()
        self.evictor = evictor if evictor is not None else FakeEvictor()
        self.status_updater = status_updater or FakeStatusUpdater()
        self.volume_binder = volume_binder or FakeVolumeBinder()
        # guards every mutation: ingest may come from another thread while
        # a cycle runs (it is then deferred by the session gate below)
        self._lock = threading.RLock()
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, PriorityClass] = {}
        self.default_priority: int = 0
        # pod store: the apiserver analog the binder's ack writes into
        self.pods: Dict[str, Pod] = {}
        # (kind, object_key, message) record, bounded like the k8s recorder
        self.events: collections.deque = collections.deque(maxlen=MAX_EVENTS)
        # last written PodScheduled condition per pod key (dedup,
        # cache.go:151-173 podConditionHaveUpdate)
        self.pod_conditions: Dict[str, dict] = {}
        # per-job earliest next condition-only status write
        # (job_updater.go:20-31) and its jitter source
        self._status_next_write: Dict[str, float] = {}
        self._jitter = np.random.default_rng()
        # last written QueueStatus counts per queue (delta suppression)
        self._queue_status_written: Dict[str, dict] = {}
        # exclusive-session gate: while a cycle owns the cache, ingest is
        # deferred and applied at session close
        self._session_active = False
        self._deferred: List = []

    # ------------------------------------------------------------------
    # exclusive-session gate
    # ------------------------------------------------------------------
    def begin_exclusive_session(self) -> None:
        with self._lock:
            graft_assert(not self._session_active,
                         "nested exclusive sessions are not supported")
            self._session_active = True

    def end_exclusive_session(self) -> None:
        """Release the cycle's ownership and apply every mutation that
        arrived during it, in order."""
        with self._lock:
            self._session_active = False
            deferred, self._deferred = self._deferred, []
            for fn, args in deferred:
                try:
                    fn(*args)
                except Exception:  # noqa: BLE001 — one bad event must not
                    logger.exception("deferred ingest event failed")

    def _gate(self, fn, *args) -> bool:
        """True when the mutation was deferred (a session is active)."""
        if self._session_active:
            self._deferred.append((fn, args))
            return True
        return False

    # ------------------------------------------------------------------
    # ingest: pods (event_handlers.go:42-200)
    # ------------------------------------------------------------------
    def _owns(self, pod: Pod) -> bool:
        """Informer filter (cache.go:283-305): this scheduler's pods, or pods
        already bound anywhere (needed for node accounting)."""
        return pod.scheduler_name == self.scheduler_name or pod.node_name is not None

    def _resolve_pod_priority(self, pod: Pod) -> None:
        if not self.resolve_priority:
            return
        if pod.priority == 0 and pod.priority_class:
            pc = self.priority_classes.get(pod.priority_class)
            if pc is not None:
                pod.priority = pc.value
        elif pod.priority == 0 and self.default_priority:
            pod.priority = self.default_priority

    def _get_or_create_job(self, task: TaskInfo, pod: Pod) -> JobInfo:
        """(event_handlers.go:42-67) jobs keyed by group annotation; plain
        pods of this scheduler get a shadow PodGroup with minMember=1
        (cache/util.go:42-60)."""
        job = self.jobs.get(task.job)
        if job is None:
            job = JobInfo(task.job, self.spec)
            self.jobs[task.job] = job
            self.columns.bind_job(job)
        if job.pod_group is None and pod.group_name is None:
            job.set_pod_group(PodGroup(
                name=pod.name,
                namespace=pod.namespace,
                min_member=1,
                queue=self.default_queue,
                creation_index=pod.creation_index,
                shadow=True,
            ))
        return job

    def add_pod(self, pod: Pod) -> None:
        with self._lock:
            if self._gate(self.add_pod, pod):
                return
            if pod.key() in self.pods:
                # informer semantics are add-or-update
                self.update_pod(pod)
                return
            if not self._owns(pod):
                return
            self._resolve_pod_priority(pod)
            self.pods[pod.key()] = pod
            self._add_task(TaskInfo(pod, self.spec), pod)

    def _add_task(self, task: TaskInfo, pod: Pod) -> None:
        job = self._get_or_create_job(task, pod)
        self.dirty.note_pod(task._key)
        self.dirty.note_job(job.uid)
        job.add_task(task)
        self.columns.bind_task(task, job)
        if task.node_name:
            node = self.nodes.get(task.node_name)
            if node is None:
                # pod arrived before its node: hold a nodeless NodeInfo;
                # set_node replays accounting when the node shows up
                node = NodeInfo(None, self.spec)
                node.name = task.node_name
                self.nodes[task.node_name] = node
                self.columns.bind_node(node)
            node.add_task(task)

    def update_pod(self, pod: Pod) -> None:
        """delete + add (event_handlers.go:116-130).  nodeName is write-once
        and scheduler-owned: an update without a node keeps the stored
        pod's binding, so a client update cannot clobber a placement."""
        with self._lock:
            if self._gate(self.update_pod, pod):
                return
            stored = self.pods.get(pod.key())
            if stored is not None and not pod.node_name:
                pod.node_name = stored.node_name
            # keep a placeholder node alive across an update of its resident
            self._delete_pod_locked(pod, retire_placeholder=not self._owns(pod))
            if self._owns(pod):
                self._resolve_pod_priority(pod)
                self.pods[pod.key()] = pod
                self._add_task(TaskInfo(pod, self.spec), pod)

    def delete_pod(self, pod: Pod) -> None:
        with self._lock:
            if self._gate(self.delete_pod, pod):
                return
            self._delete_pod_locked(pod)

    def _delete_pod_locked(self, pod: Pod, retire_placeholder: bool = True) -> None:
        self.pods.pop(pod.key(), None)
        self.pod_conditions.pop(pod.key(), None)  # fresh pod ⇒ fresh dedup
        self.dirty.note_pod(pod.key())
        self.dirty.note_job(job_id_for_pod(pod))
        release = getattr(self.volume_binder, "release_task", None)
        if release is not None:
            release(pod.uid)  # free assumed-but-unbound volume reservations
        job = self.jobs.get(job_id_for_pod(pod))
        if job is None:
            return
        task = job.tasks.get(pod.key())
        if task is not None:
            job.delete_task(task)
            node = self.nodes.get(task.node_name) if task.node_name else None
            if node is not None and task.key() in node.tasks:
                node.remove_task(task)
                # a deleted-node placeholder exists only to carry its
                # residents; the last one leaving retires it
                if retire_placeholder and node.node is None and not node.tasks:
                    self.nodes.pop(node.name, None)
                    self.columns.free_node(node)
            self.columns.free_task(task)
        self._maybe_collect_job(job)

    def _maybe_collect_job(self, job: JobInfo) -> None:
        """processCleanupJob (cache.go:533-557): drop a job once it has no
        tasks and no real (non-shadow) PodGroup."""
        if not job.tasks and (job.pod_group is None or job.pod_group.shadow):
            if self.jobs.pop(job.uid, None) is not None:
                self.dirty.note_job(job.uid)
                self.columns.free_job(job)
            self._status_next_write.pop(job.uid, None)

    # ------------------------------------------------------------------
    # ingest: nodes (event_handlers.go:261-360)
    # ------------------------------------------------------------------
    def add_node(self, node: Node) -> None:
        with self._lock:
            if self._gate(self.add_node, node):
                return
            self.dirty.note_node(node.name)
            existing = self.nodes.get(node.name)
            if existing is None:
                info = NodeInfo(node, self.spec)
                self.nodes[node.name] = info
                self.columns.bind_node(info)
            else:
                existing.set_node(node)

    def update_node(self, node: Node) -> None:
        self.add_node(node)

    def delete_node(self, name: str) -> None:
        with self._lock:
            if self._gate(self.delete_node, name):
                return
            node = self.nodes.get(name)
            if node is None:
                return
            self.dirty.note_node(name)
            if node.tasks:
                # resident pods outlive the Node object: demote to the
                # nodeless placeholder, and a re-add replays their accounting
                node.demote_to_placeholder()
                return
            self.nodes.pop(name)
            self.columns.free_node(node)

    # ------------------------------------------------------------------
    # ingest: podgroups (event_handlers.go:362-481)
    # ------------------------------------------------------------------
    def add_pod_group(self, pg: PodGroup) -> None:
        with self._lock:
            if self._gate(self.add_pod_group, pg):
                return
            if not pg.queue:
                pg.queue = self.default_queue
            job_id = pg.key()
            self.dirty.note_job(job_id)
            job = self.jobs.get(job_id)
            if job is None:
                job = JobInfo(job_id, self.spec)
                self.jobs[job_id] = job
                self.columns.bind_job(job)
            job.set_pod_group(pg)
            self.columns.sync_job_minres(job)

    def update_pod_group(self, pg: PodGroup) -> None:
        self.add_pod_group(pg)

    def delete_pod_group(self, key: str) -> None:
        with self._lock:
            if self._gate(self.delete_pod_group, key):
                return
            self.dirty.note_job(key)
            job = self.jobs.get(key)
            if job is not None:
                job.pod_group = None
                self.columns.sync_job_minres(job)
                if not job.tasks and self.jobs.pop(key, None) is not None:
                    self.columns.free_job(job)
            self._status_next_write.pop(key, None)

    # ------------------------------------------------------------------
    # ingest: queues / priority classes (event_handlers.go:597-785)
    # ------------------------------------------------------------------
    def add_queue(self, queue: Queue) -> None:
        with self._lock:
            if self._gate(self.add_queue, queue):
                return
            self.dirty.mark_queues()
            qinfo = QueueInfo(queue)
            self.queues[queue.name] = qinfo
            self.columns.bind_queue(qinfo)

    def update_queue(self, queue: Queue) -> None:
        self.add_queue(queue)

    def delete_queue(self, name: str) -> None:
        with self._lock:
            if self._gate(self.delete_queue, name):
                return
            self.dirty.mark_queues()
            self.queues.pop(name, None)
            # a recreated queue gets a fresh status write
            self._queue_status_written.pop(name, None)
            self.columns.free_queue(name)

    def add_priority_class(self, pc: PriorityClass) -> None:
        if not self.resolve_priority:
            return  # informer not wired when disabled (cache.go:352,378)
        with self._lock:
            if self._gate(self.add_priority_class, pc):
                return
            self.dirty.mark_priority_classes()
            self.priority_classes[pc.name] = pc
            if pc.global_default:
                self.default_priority = pc.value

    def delete_priority_class(self, name: str) -> None:
        with self._lock:
            if self._gate(self.delete_priority_class, name):
                return
            self.dirty.mark_priority_classes()
            pc = self.priority_classes.pop(name, None)
            if pc is not None and pc.global_default:
                self.default_priority = 0

    # ------------------------------------------------------------------
    # egress: bind (cache.go:447-487)
    # ------------------------------------------------------------------
    def bind(self, task: TaskInfo, hostname: str) -> None:
        """Mark the task Binding in the cache, then call the binder.  In an
        exclusive session the caller (Statement / dispatch) already holds
        this very task and finishes the BINDING transition itself."""
        with self._lock:
            if not self._session_active:
                job = self.jobs.get(task.job)
                own = job.tasks.get(task.key()) if job is not None else None
                if own is not None:
                    job.update_task_status(own, TaskStatus.BINDING)
                    own.node_name = hostname
                    node = self.nodes.get(hostname)
                    if node is not None and own.key() not in node.tasks:
                        node.add_task(own)
            pod = self.pods.get(task.key())
        self._dispatch([(task, hostname, pod)])

    def bulk_bind(self, tasks_hosts) -> None:
        """bind() for a batch — the allocate replay's commit path with every
        placement of the cycle.  Within an exclusive session the replay
        already applied the job/node accounting on these very objects, so
        only the binder dispatch remains; ``task.pod`` is the stored pod
        (ingest is deferred while the session owns the cache)."""
        with self._lock:
            if not self._session_active:
                pairs = list(tasks_hosts)
                for task, hostname in pairs:
                    self.bind(task, hostname)
                return
        self._dispatch([(t, h, t.pod) for t, h in tasks_hosts])

    def _dispatch(self, staged) -> None:
        """Run the binder calls inline (the reference's async goroutine,
        cache.go:478-484, and the JAX package's dispatcher pool): one
        ``bind_many`` when the binder has it, else — or after it raised —
        one ``bind`` per pod.  The binder's ack makes the binding durable in
        the pod store.  A failed bind is logged; without the resync queue
        the task stays Binding until its pod is next updated or deleted."""
        pairs = [(pod, hostname) for _task, hostname, pod in staged
                 if pod is not None]
        bind_many = getattr(self.binder, "bind_many", None)
        if bind_many is not None:
            try:
                bind_many(pairs)
            except Exception:  # noqa: BLE001 — retried per pod below
                logger.exception("bind_many failed; retrying per pod")
            else:
                self._acked(pairs)
                return
        acked = []
        for pod, hostname in pairs:
            try:
                self.binder.bind(pod, hostname)
            except Exception as e:  # noqa: BLE001 — the egress boundary
                logger.error("bind of %s to %s failed: %s", pod.key(), hostname, e)
            else:
                acked.append((pod, hostname))
        self._acked(acked)

    def _acked(self, pairs) -> None:
        for pod, hostname in pairs:
            pod.node_name = hostname
        self.events.extend(("Scheduled", pod.key(), hostname)
                           for pod, hostname in pairs)

    # ------------------------------------------------------------------
    # egress: evict (cache.go:404-444)
    # ------------------------------------------------------------------
    def evict(self, task: TaskInfo, reason: str) -> None:
        """Mark the task Releasing in the cache, then call the evictor.  In
        an exclusive session the caller (Session / Statement) has already
        moved this very task to Releasing and re-accounted its node;
        charging it again here would count it twice.  A failed evict is
        logged, like a failed bind: the task stays Releasing until its pod
        is next updated or deleted."""
        with self._lock:
            if not self._session_active:
                job = self.jobs.get(task.job)
                own = job.tasks.get(task.key()) if job is not None else None
                if own is not None:
                    job.update_task_status(own, TaskStatus.RELEASING)
                    node = self.nodes.get(own.node_name) if own.node_name else None
                    if node is not None:
                        node.update_task(own)
            pod = self.pods.get(task.key())
        if pod is None:
            return
        try:
            self.evictor.evict(pod)
        except Exception as e:  # noqa: BLE001 — the egress boundary
            logger.error("evict of %s failed: %s", task.key(), e)
            return
        self.events.append(("Evict", task.key(), reason))

    # volume seams (cache.go:189-209; no-op fake by default)
    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        self.volume_binder.allocate_volumes(task, hostname)
        task.volume_ready = True

    def bind_volumes(self, task: TaskInfo) -> None:
        self.volume_binder.bind_volumes(task)

    def volume_feasible(self, task: TaskInfo, hostname: str) -> bool:
        probe = getattr(self.volume_binder, "volume_feasible", None)
        return probe(task, hostname) if probe is not None else True

    # ------------------------------------------------------------------
    # status egress (cache.go:688-736, job_updater.go)
    # ------------------------------------------------------------------
    def _task_unschedulable_key(self, key: str, message: str) -> None:
        """PodScheduled=False condition + FailedScheduling event for one
        task (cache.go:500-525), deduplicated like podConditionHaveUpdate
        (cache.go:151-173)."""
        cond = {"type": "PodScheduled", "status": "False",
                "reason": "Unschedulable", "message": message}
        with self._lock:
            if self.pod_conditions.get(key) == cond:
                return  # no-op update suppressed
            pod = self.pods.get(key)
            if pod is not None:
                self.pod_conditions[key] = cond
        if pod is not None:
            self.status_updater.update_pod_condition(pod, cond)
        self.events.append(("FailedScheduling", key, message))

    def record_job_status_event(self, job: JobInfo) -> None:
        """Unschedulable event for a Pending/Unknown PodGroup and fit-error
        conditions for its Allocated and Pending tasks (cache.go:688-719)."""
        self._apply_status_ops(self._render_job_status_ops(job))

    def _render_job_status_ops(self, job: JobInfo) -> list:
        """record_job_status_event's effects as value ops (("event", tuple)
        / ("cond", key, message)), rendered while the session's fit
        diagnostics are live."""
        pg = job.pod_group
        pg_unsched = (pg is not None and not pg.shadow
                      and pg.phase in (PodGroupPhase.PENDING, PodGroupPhase.UNKNOWN))
        has_stuck = (job.task_status_index.get(TaskStatus.ALLOCATED)
                     or job.task_status_index.get(TaskStatus.PENDING))
        if not (pg_unsched or has_stuck):
            return []
        base = job.job_fit_errors or job.fit_error()
        ops = []
        if pg_unsched:
            ops.append(("event", ("Unschedulable", job.uid, base)))
        for status in (TaskStatus.ALLOCATED, TaskStatus.PENDING):
            for task in job.task_status_index.get(status, {}).values():
                fe = job.nodes_fit_errors.get(task.uid)
                ops.append(("cond", task.key(), fe.error() if fe is not None else base))
        return ops

    def _apply_status_ops(self, ops) -> None:
        for op in ops:
            if op[0] == "event":
                self.events.append(op[1])
            else:
                self._task_unschedulable_key(op[1], op[2])

    def stage_status_flush(self, updates, qcounts=None) -> StatusFlush:
        """The derive half of the close-time status pass: ``updates`` is
        [(job, changed, need_record)].  A changed PodGroup is written; a
        condition-only update is rate-limited to one write per 60 s plus
        jitter (job_updater.go:20-31); events and conditions are rendered
        for every job that needs a record.  A changed job is marked dirty:
        the next delta open re-reads exactly these jobs' open state."""
        to_write, ops = [], []
        with self._lock:
            now = time.monotonic()
            next_write = self._status_next_write
            jitter = self._jitter.uniform(60.0, 90.0, size=len(updates)).tolist()
            note_job = self.dirty.note_job
            for i, (job, changed, need_record) in enumerate(updates):
                pg = job.pod_group
                if pg is None or self.jobs.get(job.uid) is None:
                    continue  # deleted mid-cycle: no write, no events
                if changed:
                    note_job(job.uid)
                if need_record:
                    ops.extend(self._render_job_status_ops(job))
                if not changed and now < next_write.get(job.uid, 0.0):
                    continue  # condition-only churn, rate-limited
                next_write[job.uid] = now + jitter[i]
                to_write.append(pg.clone())
            qwrites = self._stage_queue_statuses_locked(qcounts)
        return StatusFlush(to_write, ops, qwrites)

    def run_status_flush(self, flush: StatusFlush) -> None:
        """The egress half: PodGroup writes, rendered events and conditions,
        then the queue-status writes."""
        updater = self.status_updater
        for pg in flush.to_write:
            try:
                updater.update_pod_group(pg)
            except Exception:  # noqa: BLE001 — re-derived next close
                logger.exception("podgroup status write failed")
        self._apply_status_ops(flush.ops)
        write = getattr(updater, "update_queue_status", None)
        for name, c in flush.qwrites:
            try:
                write(name, c)
            except Exception as e:  # noqa: BLE001 — next close re-derives
                logger.error("queue status write %s failed: %s", name, e)
                with self._lock:
                    # un-record so the next close retries the delta
                    if self._queue_status_written.get(name) == c:
                        del self._queue_status_written[name]

    def _stage_queue_statuses_locked(self, counts) -> list:
        """The per-queue status deltas [(name, counts)] (caller holds the
        lock), recorded as written at stage time.  Queues written before but
        absent from this cycle's counts zero out."""
        if counts is None or getattr(self.status_updater, "update_queue_status",
                                     None) is None:
            return []
        zero = queue_phase_counts()
        qwrites = []
        for name in set(counts) | set(self._queue_status_written):
            if self.queues.get(name) is None:
                continue  # deleted mid-cycle
            c = counts.get(name, zero)
            if self._queue_status_written.get(name) == c:
                continue
            self._queue_status_written[name] = dict(c)
            qwrites.append((name, dict(c)))
        return qwrites

    def update_queue_statuses(self, counts: Dict[str, dict]) -> None:
        """Write changed per-queue PodGroup phase counts (QueueStatus,
        types.go:195-204) through the StatusUpdater seam."""
        with self._lock:
            qwrites = self._stage_queue_statuses_locked(counts)
        self.run_status_flush(StatusFlush([], [], qwrites))

    # ------------------------------------------------------------------
    # session view (cache.go:584-654)
    # ------------------------------------------------------------------
    def session_view(self) -> ClusterInfo:
        """The exclusive session's ClusterInfo: shallow views over the live
        objects — Ready nodes, every queue, and every job with a PodGroup in
        a known queue, its priority resolved from its PriorityClass
        (cache.go:610-633).  The caller holds the session gate."""
        with self._lock:
            ci = ClusterInfo(self.spec)
            ci.nodes = {name: n for name, n in self.nodes.items() if n.ready}
            ci.queues = dict(self.queues)
            pcs_get = self.priority_classes.get
            for uid, job in self.jobs.items():
                pg = job.pod_group
                if pg is None:
                    continue
                if job.queue not in self.queues:
                    logger.warning("job %s queue %s not found, skipped", uid, job.queue)
                    continue
                pc = pcs_get(pg.priority_class) if pg.priority_class else None
                job.priority = pc.value if pc is not None else self.default_priority
                ci.jobs[uid] = job
            return ci

    def take_dirty(self):
        """Consume the accumulated ingest churn (one session open's input).
        During the session the gate defers ingest, so no stamp lands
        mid-cycle except the cache's own status staging at close."""
        with self._lock:
            delta = self.dirty.take()
            self.last_open_version = delta.version
            return delta

    def session_view_delta(self, delta) -> ClusterInfo:
        """``session_view`` by delta: refresh only the dirty jobs in the
        persistent open cache (``cache/dirty.py``), then hand the session
        shallow copies.  The same membership filter and priority resolution
        run, only for the jobs whose inputs could have moved since the last
        open, so the result equals ``session_view``'s."""
        oc = self.open_cache
        with self._lock:
            ci = ClusterInfo(self.spec)
            ci.nodes = {name: n for name, n in self.nodes.items() if n.ready}
            ci.queues = dict(self.queues)
            jobs, pg_status = oc.jobs, oc.pg_status
            pcs_get = self.priority_classes.get
            for uid in delta.jobs:
                job = self.jobs.get(uid)
                member = job is not None and job.pod_group is not None
                if member and job.queue not in self.queues:
                    logger.warning("job %s queue %s not found, skipped", uid, job.queue)
                    member = False
                if not member:
                    jobs.pop(uid, None)
                    pg_status.pop(uid, None)
                    continue
                pg = job.pod_group
                pc = pcs_get(pg.priority_class) if pg.priority_class else None
                job.priority = pc.value if pc is not None else self.default_priority
                jobs[uid] = job
                pg_status[uid] = (pg.phase, pg.running, pg.failed, pg.succeeded)
            ci.jobs = dict(jobs)
            return ci

    def rebuild_open_cache(self, cluster: ClusterInfo, pg_status) -> None:
        """Reseed the open cache after a full session open: ``cluster.jobs``
        and ``pg_status`` are what the session was just handed."""
        oc = self.open_cache
        oc.jobs = dict(cluster.jobs)
        oc.pg_status = dict(pg_status)
        oc.gate_dropped_rows = set()
        oc.valid = True
        # the full open cleared every session job's fit diagnostics
        self.fit_state_jobs.clear()
