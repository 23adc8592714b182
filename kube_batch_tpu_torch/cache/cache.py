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

The cycle's binds go out through the async dispatcher (the reference's
``go func`` at cache.go:478): ``bulk_bind`` records each dispatch in
flight and hands the batch to one worker thread, whose binder ack writes
``pod.node_name``; ``flush_binds`` joins it.  A failed bind or evict parks
the task in the resync queue (``cache/resync.py``), which
``process_resync_tasks`` drains (the scheduler calls it every cycle;
``run()`` starts a background repair thread too), and
``rebuild_from_pod_store`` rebuilds every job and node from the pod store
after a cycle that died partway.  With ingest staging on (the pipelined
loop), the ingest handlers append to a staging buffer under a leaf lock
and ``drain_staged_ingest`` applies it under one acquisition of the big
lock; ``set_ingest_signal`` wakes the loop's trigger.  The close-time
status pass splits into ``stage_status_flush`` (everything the next open
depends on) and ``run_status_flush`` (the egress), which the pipelined
loop overlaps with the next cycle.

PodDisruptionBudgets are the legacy gang source (``add_pdb`` and its
kin): owner-linked pods plus a PDB form one gang in the default queue,
which gets events and no status writeback.  The volume seams feed any
binder; ``cache/volume.py`` holds the standalone PV ledger and the
k8s-backed ``K8sPVLedger``, and node ingest feeds them node labels.  ``snapshot()`` deep-clones the session's
view for an isolated session.

Each unbound pod's arrival → bind-decision clock starts at its first
ingest (or when it is staged), closes at the bind decision, is re-armed
when a dispatched bind fails and is dropped when the pod goes; each
cycle's decisions feed ``volcano_arrival_to_decision_latency_milliseconds``
and the cycle's trace record (``obs/trace.py``).  The resync queue's
parks and depth, the degraded cycles' shed status writes and each
collected job's series pruning feed ``metrics/`` as in the JAX package.

``failover_recover`` is the warm-standby takeover: the pod-store
rebuild, then ``ColumnStore.revalidate_resident`` under the cache lock,
the resync history reset and the leader-failover counter.  With ``--master`` the binder and evictor are
``k8s/bind.K8sBackend``, whose transport's breaker fails fast with
``CircuitOpenError`` (a parked decision, not a poison strike).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from kube_batch_tpu_torch import metrics
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
    is_allocated,
    queue_phase_counts,
)
from kube_batch_tpu_torch.cache.dirty import DirtyTracker, OpenCache
from kube_batch_tpu_torch.cache.fake import (
    FakeBinder,
    FakeEvictor,
    FakeStatusUpdater,
    FakeVolumeBinder,
)
from kube_batch_tpu_torch.cache.resync import ResyncQueue
from kube_batch_tpu_torch.k8s.transport import CircuitOpenError
from kube_batch_tpu_torch.utils import telemetry
from kube_batch_tpu_torch.utils.assertions import graft_assert
from kube_batch_tpu_torch.utils.switches import env_int, switch_on
from kube_batch_tpu_torch.utils.worker import SerialWorker

logger = logging.getLogger("kube_batch_tpu_torch")

#: retention of the cache's event record (the k8s recorder's queue is
#: bounded too; this is a diagnostic record, not a durable store)
MAX_EVENTS = 200_000


class StatusFlush:
    """One cycle's status egress, staged by ``stage_status_flush`` and
    written by ``run_status_flush`` (on the cycle thread, or on the
    pipelined loop's writeback worker).  It holds values only, no live
    session or job: PodGroup clones to write, rendered event / condition
    ops, the decided queue writes, the count of queue writes shed, and
    the degraded verdict taken at stage time."""

    __slots__ = ("to_write", "ops", "qwrites", "shed_queues", "degraded")

    def __init__(self, to_write, ops, qwrites, shed_queues=0, degraded=False):
        self.to_write = to_write
        self.ops = ops
        self.qwrites = qwrites
        self.shed_queues = shed_queues
        self.degraded = degraded

    def __bool__(self) -> bool:
        return bool(self.to_write or self.ops or self.qwrites or self.shed_queues)


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
        # the query plane, when one is attached (serve/plane.QueryPlane sets
        # it); the actions publish their what-if leases to it
        self.query_plane = None
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
        # failed bind / evict tasks awaiting repair (cache.go:559-581): a
        # bounded backoff queue with poison quarantine (cache/resync.py)
        self.resync = ResyncQueue(
            backoff_cap=env_int("KB_RESYNC_BACKOFF_CAP", 8),
            poison_after=env_int("KB_RESYNC_POISON", 5),
            max_entries=env_int("KB_RESYNC_MAX", 4096),
        )
        # degraded-cycle signal: while True (the scheduler's soft cycle
        # budget elapsed) or while the updater reports its writeback path
        # failing fast, close-time status flushes shed
        self.shed_status_writes = False
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
        # the async bind dispatcher (the ``go func`` at cache.go:478): one
        # worker, created at the first dispatch; its futures are guarded by
        # a leaf mutex, because the pipelined loop's writeback worker joins
        # them while the cycle thread stages the next cycle's batch
        self._dispatch_worker: Optional[SerialWorker] = None
        self._dispatch_futures: List = []
        self._dispatch_mu = threading.Lock()
        # dispatched batches whose worker call raised past its own handlers
        # (each is logged; a failed bind inside one parks for resync instead)
        self.dispatch_failures = 0
        # binds dispatched and not yet settled (pod key → hostname):
        # update_pod keeps such a placement when a client update arrives
        # before the ack (the pipelined loop widens that window to a stage)
        self._inflight_bind_hosts: Dict[str, str] = {}
        # arrival → bind-decision clocks (pod key → perf_counter): stamped
        # at the first ingest (or staging) of an unbound pod, popped at its
        # bind decision or deletion
        self._arrival_ts: Dict[str, float] = {}
        # close-time status-writeback pool for parallel-safe updaters
        # (jobUpdater's 16 workers, job_updater.go:18), created lazily
        self._status_pool = None
        # background repair loop (cache.go:342-384), started by run()
        self._repair_thread: Optional[threading.Thread] = None
        self._repair_stop = threading.Event()
        # initial-sync barrier (WaitForCacheSync, cache.go:363-384)
        self._synced = threading.Event()
        # read-side ingest staging (the pipelined loop's ingest stage): when
        # enabled, the ingest handlers append (fn, args) under a leaf lock
        # instead of contending on the big lock; the cycle applies the
        # buffer under one big-lock acquisition (drain_staged_ingest)
        self._ingest_lock = threading.Lock()
        self._ingest_staged: List = []
        self.ingest_staging = False
        # idents of the threads applying ingest directly (the drain, a
        # batched apply): their re-entrant handler calls must not re-stage.
        # Each thread adds and discards only its own ident.
        self._direct_apply_threads: set = set()
        # threads inside the cycle's own staged-ingest drain: their dirty
        # advances must not re-wake the trigger
        self._cycle_drain_threads: set = set()
        # the event-driven cycle trigger's wake callback (CycleTrigger.notify)
        self._ingest_listener = None
        self.dirty.on_advance = self._dirty_advanced

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
    # ingest staging and the event trigger (the pipelined loop's ingest stage)
    # ------------------------------------------------------------------
    def _dirty_advanced(self) -> None:
        """The dirty tracker's version-advance hook: wake the cycle trigger
        for churn outside a session (ingest, repair rebuilds, deferred
        events).  Advances inside a session are the cycle's own
        bookkeeping, and the cycle's own staged-ingest drain feeds the
        session about to open: neither wakes the trigger."""
        # kbt: allow[KBT301] lock-free wake hint — a stale read costs at
        # most one extra (cheap, idempotent) trigger wake, never a miss
        if self._session_active:
            return
        if threading.get_ident() in self._cycle_drain_threads:
            return
        fn = self._ingest_listener
        if fn is not None:
            fn()

    def set_ingest_signal(self, fn) -> None:
        """Register (or clear, ``fn=None``) the trigger's wake callback.
        It must never block: it runs under the big lock from dirty stamps
        and after the staging lock from ``_stage``."""
        self._ingest_listener = fn

    def enable_ingest_staging(self) -> None:
        with self._ingest_lock:
            self.ingest_staging = True

    def disable_ingest_staging(self) -> None:
        with self._ingest_lock:
            self.ingest_staging = False
        self.drain_staged_ingest()

    def _stage(self, fn, *args) -> bool:
        """Stage an ingest mutation instead of applying it (True when
        staged).  Off by default; a thread applying ingest directly never
        re-stages.  The wake signal fires outside the staging lock."""
        # kbt: allow[KBT301] double-checked peek — re-read under the lock
        if not self.ingest_staging:
            return False
        # kbt: allow[KBT301] own-ident set membership is GIL-atomic
        if threading.get_ident() in self._direct_apply_threads:
            return False
        with self._ingest_lock:
            if not self.ingest_staging:
                return False
            self._ingest_staged.append((fn, args))
        fn2 = self._ingest_listener
        if fn2 is not None:
            fn2()
        return True

    def _note_staged_arrival(self, obj) -> None:
        """Start a staged unbound pod's arrival clock when it is staged, not
        when the next cycle's drain applies it, so the latency covers the
        stage → drain wait; the apply-time stamp in _add_task keeps an
        earlier one.  setdefault on a dict is atomic under the GIL; other
        kinds are ignored."""
        if isinstance(obj, Pod) and obj.node_name is None:
            # kbt: allow[KBT301] setdefault on a plain dict is GIL-atomic
            self._arrival_ts.setdefault(obj.key(), telemetry.perf_counter())

    def drain_staged_ingest(self) -> int:
        """Apply every staged ingest event under one big-lock acquisition,
        in arrival order; a bad event is logged and skipped (informer
        handler semantics).  Returns the number of events drained."""
        with self._ingest_lock:
            staged, self._ingest_staged = self._ingest_staged, []
        if not staged:
            return 0
        ident = threading.get_ident()
        # kbt: allow[KBT301] own-ident set ops are GIL-atomic: each thread
        # only ever adds/discards ITS OWN ident, so no two threads contend
        # on the same element and a torn composite read is impossible
        nested = ident in self._direct_apply_threads
        # kbt: allow[KBT301] own-ident set add is GIL-atomic (see above)
        self._direct_apply_threads.add(ident)
        self._cycle_drain_threads.add(ident)
        try:
            with self._lock:
                for fn, args in staged:
                    try:
                        fn(*args)
                    except Exception:  # noqa: BLE001 — one bad event
                        logger.exception("staged ingest event failed")
        finally:
            self._cycle_drain_threads.discard(ident)
            if not nested:
                # kbt: allow[KBT301] own-ident set discard is GIL-atomic
                self._direct_apply_threads.discard(ident)
        return len(staged)

    def ingest_batch(self, ops) -> int:
        """Apply ``[(fn, obj)]`` ingest operations under one lock
        acquisition and one dirty-version advance; with staging on, the
        whole batch stages under one staging-lock acquisition and one
        wake.  Returns the number applied (or staged); a handler that
        raises drops only its own element."""
        if not ops:
            return 0
        # kbt: allow[KBT301] double-checked peek — re-read under the lock
        if (self.ingest_staging
                # kbt: allow[KBT301] own-ident set membership is GIL-atomic
                and threading.get_ident() not in self._direct_apply_threads):
            with self._ingest_lock:
                staged = self.ingest_staging
                if staged:
                    self._ingest_staged.extend((fn, (obj,)) for fn, obj in ops)
            if staged:
                for _fn, obj in ops:
                    self._note_staged_arrival(obj)
                fn2 = self._ingest_listener
                if fn2 is not None:
                    fn2()
                return len(ops)
        with self._lock:
            # a direct applier: a handler re-entered here never re-stages
            ident = threading.get_ident()
            nested = ident in self._direct_apply_threads
            self._direct_apply_threads.add(ident)
            self.dirty.hold_version()
            applied = 0
            try:
                for fn, obj in ops:
                    try:
                        fn(obj)
                        applied += 1
                    except Exception:  # noqa: BLE001 — one bad event
                        logger.exception("batched ingest event failed")
            finally:
                self.dirty.release_version()
                if not nested:
                    self._direct_apply_threads.discard(ident)
        return applied

    # ------------------------------------------------------------------
    # background repair loops (cache.go:342-384)
    # ------------------------------------------------------------------
    def run(self, resync_period: float = 1.0) -> None:
        """Start the background repair thread, the processResyncTask and
        processCleanupJob goroutines (cache.go:342-384, 533-581): every
        ``resync_period`` seconds it drains the resync queue and collects
        terminated jobs, until ``stop()``.  Idempotent."""
        if self._repair_thread is not None and self._repair_thread.is_alive():
            return
        self._repair_stop = threading.Event()
        stop = self._repair_stop

        def loop():
            while not stop.wait(resync_period):
                try:
                    self.process_resync_tasks()
                    self.process_cleanup_jobs()
                except Exception:  # noqa: BLE001 — repair must not die
                    logger.exception("cache repair iteration failed")

        self._repair_thread = threading.Thread(
            target=loop, name="kb-cache-repair", daemon=True)
        self._repair_thread.start()

    def mark_synced(self) -> None:
        """Signal that the initial cluster sync is complete (the informer
        HasSynced analog)."""
        self._synced.set()

    def wait_for_cache_sync(self, timeout: Optional[float] = None) -> bool:
        """WaitForCacheSync (cache.go:363-384): block until ``mark_synced``
        or ``timeout`` seconds; on a timeout the loop proceeds with what
        arrived (a late remainder converges like any other change)."""
        if timeout is None:
            return self._synced.is_set()
        ok = self._synced.wait(timeout)
        if not ok:
            logger.warning("cache sync signal not received within %.1fs; "
                           "scheduling over %d nodes / %d jobs as-is",
                           # kbt: allow[KBT301] log-only sizes — stale is fine
                           timeout, len(self.nodes), len(self.jobs))
        return ok

    def stop(self) -> None:
        """Stop the repair thread, then drain and retire the bind
        dispatcher and the status pool, each with a bounded join; a later
        dispatch starts a new worker."""
        self._repair_stop.set()
        if self._repair_thread is not None:
            self._repair_thread.join(timeout=5.0)
            self._repair_thread = None
        worker, self._dispatch_worker = self._dispatch_worker, None
        if worker is not None:
            worker.shutdown(timeout=30.0)
        with self._dispatch_mu:
            self._dispatch_futures = []
        spool, self._status_pool = self._status_pool, None
        if spool is not None:
            spool.shutdown(wait=True)
        close = getattr(self.volume_binder, "close", None)
        if close is not None:
            close()

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
        if job.pod_group is None and pod.group_name is None and job.pdb is None:
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
        if self._stage(self.add_pod, pod):
            self._note_staged_arrival(pod)
            return
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
        if task.node_name is None and task._key not in self._arrival_ts:
            # the arrival clock starts at the first ingest of an unbound
            # pod; status replays keep the first stamp
            self._arrival_ts[task._key] = telemetry.perf_counter()
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
        pod's binding, or the placement of a bind dispatched and not yet
        acked, so a client update cannot clobber a placement.  An external
        change releases a quarantined pod back into the ordinary flow."""
        if self._stage(self.update_pod, pod):
            self._note_staged_arrival(pod)
            return
        with self._lock:
            if self._gate(self.update_pod, pod):
                return
            stored = self.pods.get(pod.key())
            if stored is not None and not pod.node_name:
                pod.node_name = (stored.node_name
                                 or self._inflight_bind_hosts.get(pod.key()))
            # the rebuild below is the released pod's fresh resync
            self.resync.release(pod.key())
            # the arrival clock starts at the first ingest: a status replay
            # of a still-pending pod must not reset it through the rebuild
            t_arr = self._arrival_ts.get(pod.key())
            # keep a placeholder node alive across an update of its resident
            self._delete_pod_locked(pod, retire_placeholder=not self._owns(pod))
            if self._owns(pod):
                self._resolve_pod_priority(pod)
                self.pods[pod.key()] = pod
                self._add_task(TaskInfo(pod, self.spec), pod)
                if t_arr is not None and pod.key() in self._arrival_ts:
                    self._arrival_ts[pod.key()] = t_arr

    def delete_pod(self, pod: Pod) -> None:
        if self._stage(self.delete_pod, pod):
            return
        with self._lock:
            if self._gate(self.delete_pod, pod):
                return
            self._delete_pod_locked(pod)

    def _delete_pod_locked(self, pod: Pod, retire_placeholder: bool = True,
                           forget_resync: bool = True) -> None:
        self.pods.pop(pod.key(), None)
        self.pod_conditions.pop(pod.key(), None)  # fresh pod ⇒ fresh dedup
        self._arrival_ts.pop(pod.key(), None)
        self._inflight_bind_hosts.pop(pod.key(), None)
        if forget_resync:
            # an external change or delete: all repair bookkeeping, the
            # quarantine too, starts over.  The resync pass's own rebuild
            # passes False: it must keep the history its backoff counts.
            self.resync.forget(pod.key())
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
        tasks, no real (non-shadow) PodGroup and no PDB."""
        if (not job.tasks and (job.pod_group is None or job.pod_group.shadow)
                and job.pdb is None):
            if self.jobs.pop(job.uid, None) is not None:
                self.dirty.note_job(job.uid)
                self.columns.free_job(job)
                metrics.prune_job_series(job.uid)
            self._status_next_write.pop(job.uid, None)

    # ------------------------------------------------------------------
    # ingest: nodes (event_handlers.go:261-360)
    # ------------------------------------------------------------------
    def add_node(self, node: Node) -> None:
        if self._stage(self.add_node, node):
            return
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
            # a topology-restricted PV evaluates its node terms against
            # these labels in the volume ledger (cache/volume.py)
            set_labels = getattr(self.volume_binder, "set_node_labels", None)
            if set_labels is not None:
                set_labels(node.name, node.labels)

    def update_node(self, node: Node) -> None:
        self.add_node(node)

    def delete_node(self, name: str) -> None:
        if self._stage(self.delete_node, name):
            return
        with self._lock:
            if self._gate(self.delete_node, name):
                return
            node = self.nodes.get(name)
            if node is None:
                return
            self.dirty.note_node(name)
            # a gone node attaches no volume: the ledger fails closed for it
            forget = getattr(self.volume_binder, "forget_node_labels", None)
            if forget is not None:
                forget(name)
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
        if self._stage(self.add_pod_group, pg):
            return
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
        if self._stage(self.delete_pod_group, key):
            return
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
    # ingest: pod disruption budgets, the legacy gang source
    # (event_handlers.go:484-594)
    # ------------------------------------------------------------------
    def add_pdb(self, pdb) -> None:
        """setPDB: the job is keyed by the PDB's controller UID (the key
        owner-linked pods land on, cache/util.go:42-46); min-available
        comes from the PDB and the queue is always the default one (a PDB
        has no queue, event_handlers.go:497-498)."""
        if not pdb.owner:
            logger.error("PodDisruptionBudget %s has no controller; ignored", pdb.name)
            return
        if self._stage(self.add_pdb, pdb):
            return
        with self._lock:
            if self._gate(self.add_pdb, pdb):
                return
            job_id = f"{pdb.namespace}/{pdb.owner}"
            self.dirty.note_job(job_id)
            job = self.jobs.get(job_id)
            if job is None:
                job = JobInfo(job_id, self.spec)
                self.jobs[job_id] = job
                self.columns.bind_job(job)
            # a shadow PodGroup made for owner pods that arrived before their
            # PDB yields to the PDB as the gang source
            if job.pod_group is not None and job.pod_group.shadow:
                job.pod_group = None
            job.set_pdb(pdb)
            job.queue = self.default_queue

    def update_pdb(self, pdb) -> None:
        self.add_pdb(pdb)

    def delete_pdb(self, pdb) -> None:
        if not pdb.owner:
            return
        if self._stage(self.delete_pdb, pdb):
            return
        with self._lock:
            if self._gate(self.delete_pdb, pdb):
                return
            job = self.jobs.get(f"{pdb.namespace}/{pdb.owner}")
            if job is None:
                return
            self.dirty.note_job(job.uid)
            job.unset_pdb()
            if job.tasks and job.pod_group is None:
                # the owner's pods schedule as singletons again under the
                # shadow PodGroup the PDB displaced (the reference leaves the
                # job out of snapshots until its pods go, cache.go:625-633)
                any_pod = next(iter(job.tasks.values())).pod
                job.set_pod_group(PodGroup(
                    name=any_pod.name,
                    namespace=any_pod.namespace,
                    min_member=1,
                    queue=self.default_queue,
                    creation_index=any_pod.creation_index,
                    shadow=True,
                ))
            self._maybe_collect_job(job)

    # ------------------------------------------------------------------
    # ingest: queues / priority classes (event_handlers.go:597-785)
    # ------------------------------------------------------------------
    def add_queue(self, queue: Queue) -> None:
        if self._stage(self.add_queue, queue):
            return
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
        if self._stage(self.delete_queue, name):
            return
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
        if self._stage(self.add_priority_class, pc):
            return
        with self._lock:
            if self._gate(self.add_priority_class, pc):
                return
            self.dirty.mark_priority_classes()
            self.priority_classes[pc.name] = pc
            if pc.global_default:
                self.default_priority = pc.value

    def delete_priority_class(self, name: str) -> None:
        if self._stage(self.delete_priority_class, name):
            return
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
    def _own_task(self, task: TaskInfo) -> Optional[TaskInfo]:
        job = self.jobs.get(task.job)
        return job.tasks.get(task.key()) if job is not None else None

    def _mark_binding_locked(self, task: TaskInfo, hostname: str) -> None:
        """Outside a session, the Binding transition and its node
        accounting on the cache's own task (caller holds the lock).  In an
        exclusive session the caller (Statement / dispatch) holds this very
        task and finishes the transition itself."""
        own = self._own_task(task)
        if own is not None:
            self.jobs[task.job].update_task_status(own, TaskStatus.BINDING)
            own.node_name = hostname
            node = self.nodes.get(hostname)
            if node is not None and own.key() not in node.tasks:
                node.add_task(own)

    def bind(self, task: TaskInfo, hostname: str) -> None:
        """Mark the task Binding in the cache, then call the binder at once;
        its ack makes the binding durable in the pod store.  A failure
        parks the task for resync (a breaker refusal without charging its
        poison budget)."""
        with self._lock:
            if not self._session_active:
                self._mark_binding_locked(task, hostname)
            pod = self.pods.get(task.key())
            t0 = self._arrival_ts.pop(task.key(), None) if pod is not None else None
        if t0 is not None:
            self._observe_decisions([(telemetry.perf_counter() - t0) * 1e3])
        try:
            if pod is not None:
                self.binder.bind(pod, hostname)
                pod.node_name = hostname
                self.events.append(("Scheduled", task.key(), hostname))
                if self.resync.has_history():
                    with self._lock:
                        self.resync.note_success(task.key())
        except CircuitOpenError:
            logger.warning("bind of %s parked: egress breaker open", task.key())
            self.resync_task(task, reason="breaker-open")
        except Exception as e:  # noqa: BLE001 — the egress boundary
            logger.error("bind of %s to %s failed: %s", task.key(), hostname, e)
            self.resync_task(task)

    def bulk_bind(self, tasks_hosts, job_sums=None, node_sums=None) -> None:
        """bind() for a batch under one lock acquisition: the allocate
        replay's commit path with every placement of the cycle.  Within an
        exclusive session the replay already applied the job and node
        accounting on these very objects, and ``task.pod`` is the stored
        pod (ingest is deferred while the session owns the cache), so only
        the dispatch remains.  Outside one (an isolated session's tasks are
        clones) the cache's own tasks turn Binding groupwise
        (:meth:`_bulk_bind_locked`).  The binder calls run on the dispatch
        worker (:meth:`_dispatch_async`); :meth:`flush_binds` joins them."""
        with self._lock:
            if self._session_active:
                staged = [(t, h, t.pod) for t, h in tasks_hosts]
            else:
                staged = self._bulk_bind_locked(tasks_hosts, job_sums, node_sums)
            lat_ms = self._note_bind_decisions_locked(staged)
        if lat_ms:
            self._observe_decisions(lat_ms)
        # dispatched after the lock is released: the first dispatch starts
        # the worker thread, and no lock is held across a thread start
        self._dispatch_async(staged)

    def _bulk_bind_locked(self, tasks_hosts, job_sums, node_sums) -> list:
        """The Binding transition of the cache's own tasks for a batch,
        applied per job (``bulk_transition``) and per node
        (``bulk_add_tasks``) with presummed resreq; returns the staged
        dispatch.  ``job_sums`` / ``node_sums`` ({key: (count, vec)}) are
        the replay's segment sums, trusted only when the count matches the
        group applied here and every task's resreq is the very Resource the
        session cloned (a pod updated mid-cycle has a fresh one); otherwise
        the group is summed here."""
        pods_get = self.pods.get
        jobs_get = self.jobs.get
        nodes_get = self.nodes.get
        staged = []
        by_job: Dict[str, list] = {}
        by_node: Dict[str, list] = {}
        stale_jobs: set = set()
        stale_nodes: set = set()
        prev_job_uid = None
        job = None
        jlst: list = []
        for task, hostname in tasks_hosts:
            key = task._key
            if task.job != prev_job_uid:
                # the replay emits binds grouped by job
                prev_job_uid = task.job
                job = jobs_get(task.job)
                jlst = by_job.get(task.job)
                if jlst is None and job is not None:
                    jlst = by_job[task.job] = []
            own = job.tasks.get(key) if job is not None else None
            if own is not None:
                if own.resreq is not task.resreq:  # pod updated mid-cycle
                    stale_jobs.add(task.job)
                    stale_nodes.add(hostname)
                own.node_name = hostname
                jlst.append(own)
                node = nodes_get(hostname)
                if node is not None and key not in node.tasks:
                    by_node.setdefault(hostname, []).append(own)
            staged.append((task, hostname, pods_get(key)))
        nR = self.spec.n
        for job_uid, owns in by_job.items():
            job = self.jobs[job_uid]
            # bulk_transition needs one allocated-ness flip for the batch;
            # a rebound task may already carry an allocated status
            flip = [t for t in owns if not is_allocated(t.status)]
            noflip = [t for t in owns if is_allocated(t.status)]
            if flip:
                pre = None
                if job_sums is not None and not noflip and job_uid not in stale_jobs:
                    entry = job_sums.get(job_uid)
                    if entry is not None and entry[0] == len(flip):
                        pre = entry[1]
                if pre is None:
                    pre = np.zeros(nR)
                    for t in flip:
                        pre += t.resreq.vec
                pre_r = self.spec.wrap_vec(pre)
                job.bulk_transition(flip, TaskStatus.BINDING, pre_r, pending_sum=pre_r)
            if noflip:
                job.bulk_transition(noflip, TaskStatus.BINDING, self.spec.empty())
        for hostname, owns in by_node.items():
            node = self.nodes[hostname]
            pre = None
            if node_sums is not None and hostname not in stale_nodes:
                entry = node_sums.get(hostname)
                if entry is not None and entry[0] == len(owns):
                    pre = entry[1]
            if pre is None:
                pre = np.zeros(nR)
                for t in owns:
                    pre += t.resreq.vec
            node.bulk_add_tasks(owns, [], self.spec.wrap_vec(pre), self.spec.empty())
        return staged

    def _note_bind_decisions_locked(self, staged) -> list:
        """Mark every staged dispatch in flight (update_pod's guard for a
        bind not yet acked) and close the arrival clocks; returns the ms
        latencies (observed outside the lock)."""
        now = telemetry.perf_counter()
        pop_ts = self._arrival_ts.pop
        inflight = self._inflight_bind_hosts
        lat_ms = []
        for task, hostname, pod in staged:
            if pod is None:
                continue
            inflight[task._key] = hostname
            t0 = pop_ts(task._key, None)
            if t0 is not None:
                lat_ms.append((now - t0) * 1e3)
        return lat_ms

    def _observe_decisions(self, lat_ms: list) -> None:
        """Feed one batch of arrival → decision latencies to the histogram
        (and its sink) and to the cycle's trace record, whose SLO check may
        arm a flight dump."""
        metrics.observe_decision_latencies(lat_ms)
        tr = getattr(self, "tracer", None)
        if tr is not None:
            tr.note_decision_latencies(lat_ms)

    def _settle_inflight(self, entries, bound: bool) -> None:
        """Clear the in-flight markers of settled dispatches; ``entries`` is
        [(key, pod, hostname)].  For a FAILED dispatch, a placement that
        update_pod copied onto a replacement pod object is rolled back (the
        apiserver never bound it) and the pod is marked dirty, so the
        repair rebuild re-derives it as Pending.  A failed pod still in the
        store gets a new arrival clock, so its repaired decision is
        measured too."""
        now = telemetry.perf_counter()
        with self._lock:
            for key, pod, hostname in entries:
                if self._inflight_bind_hosts.get(key) == hostname:
                    del self._inflight_bind_hosts[key]
                if not bound:
                    cur = self.pods.get(key)
                    if cur is not None:
                        self._arrival_ts.setdefault(key, now)
                    if (cur is not None and cur is not pod
                            and cur.node_name == hostname):
                        cur.node_name = None
                        self.dirty.note_pod(key)
                        self.dirty.note_job(job_id_for_pod(cur))

    def _dispatch_async(self, staged) -> None:
        """Run the binder calls for ``staged`` [(task, hostname, pod)] on the
        dispatch worker (the reference's goroutine, cache.go:478-484): one
        ``bind_many`` when the binder has it, else (or after it raised, not
        for a breaker refusal) one ``bind`` per pod.  The ack writes
        ``pod.node_name``; a failed bind parks its task for resync.  The
        worker touches pods and the cache's host state only."""
        bind_many = getattr(self.binder, "bind_many", None)

        def run():
            if bind_many is not None:
                pairs = [(pod, hostname) for _t, hostname, pod in staged
                         if pod is not None]
                try:
                    bind_many(pairs)
                except CircuitOpenError:
                    # the egress fails fast: park the whole batch without a
                    # per-pod call, and without charging the poison budget
                    logger.warning("binder breaker open; parking %d binds "
                                   "for resync", len(pairs))
                    self._settle_inflight([(pod.key(), pod, h) for pod, h in pairs],
                                          bound=False)
                    for task, _h, pod in staged:
                        if pod is not None:
                            self.resync_task(task, reason="breaker-open")
                    return
                except Exception:  # noqa: BLE001 — retried per pod below
                    logger.exception("bind_many failed; retrying per pod")
                else:
                    for pod, hostname in pairs:
                        pod.node_name = hostname
                    self._settle_inflight([(pod.key(), pod, h) for pod, h in pairs],
                                          bound=True)
                    self.events.extend(("Scheduled", pod.key(), h) for pod, h in pairs)
                    if self.resync.has_history():
                        with self._lock:
                            for pod, _h in pairs:
                                self.resync.note_success(pod.key())
                    return
            breaker_parked = 0
            acked, failed = [], []
            for task, hostname, pod in staged:
                if pod is None:
                    continue
                try:
                    self.binder.bind(pod, hostname)
                except CircuitOpenError:
                    breaker_parked += 1
                    failed.append((task._key, pod, hostname))
                    self.resync_task(task, reason="breaker-open")
                except Exception as e:  # noqa: BLE001 — the resync repair path
                    logger.error("bind of %s to %s failed: %s", task._key, hostname, e)
                    failed.append((task._key, pod, hostname))
                    self.resync_task(task)
                else:
                    pod.node_name = hostname
                    acked.append((task._key, pod, hostname))
                    self.events.append(("Scheduled", task._key, hostname))
                    if self.resync.has_history():
                        with self._lock:
                            self.resync.note_success(task._key)
            if acked:
                self._settle_inflight(acked, bound=True)
            if failed:
                self._settle_inflight(failed, bound=False)
            if breaker_parked:
                logger.warning("binder breaker open; parked %d binds for resync",
                               breaker_parked)

        if self._dispatch_worker is None:
            self._dispatch_worker = SerialWorker("kb-dispatch")
        fut = self._dispatch_worker.submit(run)
        with self._dispatch_mu:
            self._prune_dispatched_locked()
            self._dispatch_futures.append(fut)

    def _prune_dispatched_locked(self) -> None:
        """Drop the settled dispatch futures (caller holds ``_dispatch_mu``),
        reading each one's outcome so no failure goes unseen."""
        pending = []
        for f in self._dispatch_futures:
            if not f.done():
                pending.append(f)
            elif f.exception() is not None:
                self.dispatch_failures += 1
                logger.error("bind dispatch failed", exc_info=f.exception())
        self._dispatch_futures = pending

    def flush_binds(self, timeout: Optional[float] = None) -> None:
        """Wait for every dispatched bind batch: the state after it is the
        state the binder acks leave.  A batch that raised is counted in
        ``dispatch_failures`` and logged."""
        with self._dispatch_mu:
            pending = list(self._dispatch_futures)
        for f in pending:
            f.exception(timeout=timeout)  # waits; raises only on a timeout
        with self._dispatch_mu:
            self._prune_dispatched_locked()

    # ------------------------------------------------------------------
    # egress: evict (cache.go:404-444)
    # ------------------------------------------------------------------
    def evict(self, task: TaskInfo, reason: str) -> None:
        """Mark the task Releasing in the cache, then call the evictor.  In
        an exclusive session the caller (Session / Statement) has already
        moved this very task to Releasing and re-accounted its node;
        charging it again here would count it twice.  A failed evict parks
        the task for resync."""
        with self._lock:
            if not self._session_active:
                own = self._own_task(task)
                if own is not None:
                    self.jobs[task.job].update_task_status(own, TaskStatus.RELEASING)
                    node = self.nodes.get(own.node_name) if own.node_name else None
                    if node is not None:
                        node.update_task(own)
            pod = self.pods.get(task.key())
        try:
            if pod is not None:
                self.evictor.evict(pod)
                self.events.append(("Evict", task.key(), reason))
        except CircuitOpenError:
            logger.warning("evict of %s parked: egress breaker open", task.key())
            self.resync_task(task, reason="breaker-open")
        except Exception as e:  # noqa: BLE001 — the egress boundary
            logger.error("evict of %s failed: %s", task.key(), e)
            self.resync_task(task)

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
    # repair: resync (cache.go:559-581, event_handlers.go:96-122)
    # ------------------------------------------------------------------
    @property
    def err_tasks(self) -> List[TaskInfo]:
        """The pending repair backlog (a read-only view of ``resync``)."""
        with self._lock:
            return self.resync.pending_tasks()

    def resync_task(self, task: TaskInfo, reason: str = "error") -> None:
        """Park a failed bind or evict for repair (cache.go:447-487).
        ``reason="breaker-open"`` marks a decision the egress breaker
        refused locally: it backs off but never counts toward the poison
        budget."""
        with self._lock:
            counted = self.resync.park(task, reason)
            depth, quarantined = len(self.resync), len(self.resync.quarantined)
        if counted:  # a quarantined key's park is a no-op
            metrics.register_resync_parked(reason)
        metrics.set_resync_depth(depth, quarantined)

    def _resync_one_locked(self, task: TaskInfo) -> None:
        """Re-sync one errored task from the pod store: gone → forget;
        present → rebuild (delete + add)."""
        pod = self.pods.get(task.key())
        if pod is None:
            self.resync.forget(task.key())
            return
        self._delete_pod_locked(pod, forget_resync=False)
        self.pods[pod.key()] = pod
        self._add_task(TaskInfo(pod, self.spec), pod)

    def process_resync_tasks(self) -> None:
        """One repair pass over the backoff queue: due tasks rebuild from
        the pod store (and are placed again next cycle); a task that used
        up its poison budget is shelved with a PodScheduled condition
        instead of retrying forever.  Skipped while a cycle owns the
        cache."""
        poisoned: List[TaskInfo] = []
        with self._lock:
            if self._session_active:
                return
            self.resync.apply(self._resync_one_locked, poisoned.append)
            depth, quarantined = len(self.resync), len(self.resync.quarantined)
        for task in poisoned:
            logger.error("task %s failed %d bind/evict repairs; quarantined until "
                         "an external change to its pod", task.key(),
                         self.resync.poison_after)
            self.task_unschedulable(
                task, f"bind/evict failed {self.resync.poison_after} times; "
                "quarantined pending an external pod change")
        metrics.set_resync_depth(depth, quarantined)

    def rebuild_from_pod_store(self) -> None:
        """Re-list recovery (the informer re-list, cache.go:342-384): rebuild
        every job's and node's task state from the pod store.  The loop
        calls it after a cycle died partway: an exclusive session mutates
        the cache's own objects, and a half-applied replay would otherwise
        leak phantom allocations.  Completed bindings survive (every binder
        ack writes ``pod.node_name``); binds not yet acked rebuild as
        Pending and are placed again.  The next open is full and the
        resident snapshot and warm carry see every row as changed."""
        with self._lock:
            self.dirty.mark_full()
            self.open_cache.invalidate()
            spec = self.spec
            for job in self.jobs.values():
                for task in job.tasks.values():
                    self.columns.free_task(task)
                job.tasks.clear()
                job.task_status_index.clear()
                # zeroed in place: the ledgers are views into the columns
                job.allocated.vec[:] = 0.0
                job.total_request.vec[:] = 0.0
                job.pending_request.vec[:] = 0.0
                job._note_alloc()
                if job._cols is not None:
                    job._cols.j_counts[job._row] = 0
                    job._cols.j_touched[job._row] = True
                job.nodes_fit_delta = {}
                job.nodes_fit_errors = {}
            for node in self.nodes.values():
                node.tasks.clear()
                node._acct.clear()
                if node._cols is not None:
                    node._cols.note_node_ledger(node._row)
                node.idle.vec[:] = node.allocatable.vec
                node.used.vec[:] = 0.0
                node.releasing.vec[:] = 0.0
                node._set_state()
                if node._cols is not None:
                    node._cols.sync_node_meta(node)
            for pod in list(self.pods.values()):
                if not self._owns(pod):
                    continue
                self._resolve_pod_priority(pod)
                self._add_task(TaskInfo(pod, spec), pod)
            for job in list(self.jobs.values()):
                self._maybe_collect_job(job)
            n_pods, n_jobs = len(self.pods), len(self.jobs)
        logger.warning("cache rebuilt from the pod store (%d pods, %d jobs)",
                       n_pods, n_jobs)

    def failover_recover(self) -> Dict:
        """Warm-standby takeover (leader failover): rebuild the host model
        from the pod store (the re-list a fresh leader performs anyway),
        then revalidate the surviving per-cycle device cache
        (``columns.revalidate_resident``: version token and
        ``check_consistency``).  On success the resident tensors are KEPT
        and the next cycle's mirror diffs absorb any divergence as
        ordinary scatter deltas; only a failed revalidation cold-starts
        the residency.  The resync queue's history and quarantine go too:
        the new leader's rebuilt state supersedes the old one's failures."""
        self.rebuild_from_pod_store()
        with self._lock:
            report = self.columns.revalidate_resident(self)
            self.resync.reset_history()
        metrics.register_leader_failover(report["mode"])
        logger.warning(
            "leader failover recovery: %s (resident tokens %s%s)",
            report["mode"], report["resident_tokens"],
            f"; errors: {report['errors']}" if report["errors"] else "",
        )
        return report

    def process_cleanup_jobs(self) -> None:
        """processCleanupJob (cache.go:533-557): collect jobs with no tasks
        and no real PodGroup.  Tasks leave through delete_pod, which
        collects too; this sweep catches a job that lost its last task on
        another path.  Skipped while a cycle owns the cache."""
        with self._lock:
            if self._session_active:
                return
            for job in list(self.jobs.values()):
                self._maybe_collect_job(job)

    # ------------------------------------------------------------------
    # status egress (cache.go:688-736, job_updater.go)
    # ------------------------------------------------------------------
    def task_unschedulable(self, task: TaskInfo, message: str) -> None:
        """PodScheduled=False condition and FailedScheduling event for one
        task (cache.go:500-525)."""
        self._task_unschedulable_key(task.key(), message)

    def _task_unschedulable_key(self, key: str, message: str,
                                require_pod: bool = False) -> None:
        """PodScheduled=False condition + FailedScheduling event for one
        task (cache.go:500-525), deduplicated like podConditionHaveUpdate
        (cache.go:151-173).  ``require_pod=True`` (a staged flush) records
        no dedup entry for a pod that has left the store since the stage,
        so a recreated pod's first write is not suppressed."""
        cond = {"type": "PodScheduled", "status": "False",
                "reason": "Unschedulable", "message": message}
        with self._lock:
            if self.pod_conditions.get(key) == cond:
                return  # no-op update suppressed
            pod = self.pods.get(key)
            if pod is not None or not require_pod:
                self.pod_conditions[key] = cond
        if pod is not None:
            self.status_updater.update_pod_condition(pod, cond)
        self.events.append(("FailedScheduling", key, message))

    def record_job_status_event(self, job: JobInfo) -> None:
        """Unschedulable event for a Pending/Unknown PodGroup, or a PDB job
        with Pending tasks, and fit-error conditions for its Allocated and
        Pending tasks (cache.go:688-719)."""
        self._apply_status_ops(self._render_job_status_ops(job))

    def _render_job_status_ops(self, job: JobInfo) -> list:
        """record_job_status_event's effects as value ops (("event", tuple)
        / ("cond", key, message)), rendered while the session's fit
        diagnostics are live."""
        pg = job.pod_group
        pg_unsched = (pg is not None and not pg.shadow
                      and pg.phase in (PodGroupPhase.PENDING, PodGroupPhase.UNKNOWN))
        pdb_unsched = job.pdb is not None and bool(
            job.task_status_index.get(TaskStatus.PENDING))
        has_stuck = (job.task_status_index.get(TaskStatus.ALLOCATED)
                     or job.task_status_index.get(TaskStatus.PENDING))
        if not (pg_unsched or pdb_unsched or has_stuck):
            return []
        base = job.job_fit_errors or job.fit_error()
        ops = []
        if pg_unsched or pdb_unsched:
            ops.append(("event", ("Unschedulable", job.uid, base)))
        for status in (TaskStatus.ALLOCATED, TaskStatus.PENDING):
            for task in job.task_status_index.get(status, {}).values():
                fe = job.nodes_fit_errors.get(task.uid)
                ops.append(("cond", task.key(), fe.error() if fe is not None else base))
        return ops

    def _apply_status_ops(self, ops, staged: bool = False) -> None:
        for op in ops:
            if op[0] == "event":
                self.events.append(op[1])
            else:
                self._task_unschedulable_key(op[1], op[2], require_pod=staged)

    def update_job_status(self, job: JobInfo, prev_status=None) -> None:
        """An isolated session's per-job status writeback (UpdatePodGroup,
        cache.go:722-736): the session's derived PodGroup status is copied
        onto the cache's own PodGroup and written; a condition-only update
        is rate-limited to one write per 60 s plus jitter
        (job_updater.go:20-31).  Events and conditions accompany every
        pass, rate-limited or not."""
        pg = job.pod_group
        if pg is None:
            return
        write = True
        with self._lock:
            own = self.jobs.get(job.uid)
            if own is None:
                return  # deleted mid-cycle
            own_pg = own.pod_group
            if prev_status is not None:
                condition_only = prev_status == (pg.phase, pg.running, pg.failed,
                                                 pg.succeeded)
            else:
                condition_only = (own_pg is not None and own_pg.phase == pg.phase
                                  and (own_pg.running, own_pg.failed, own_pg.succeeded)
                                  == (pg.running, pg.failed, pg.succeeded))
            # kbt: allow[KBT001] status-write rate-limit cadence is wall-clock
            # by design (job_updater.go:20-31); scheduling decisions never read it
            now = time.monotonic()
            if condition_only and now < self._status_next_write.get(job.uid, 0.0):
                write = False
            if write:
                self._status_next_write[job.uid] = (
                    now + float(self._jitter.uniform(60.0, 90.0)))
                if own_pg is not None:
                    own_pg.phase = pg.phase
                    own_pg.conditions = list(pg.conditions)
                    own_pg.running = pg.running
                    own_pg.failed = pg.failed
                    own_pg.succeeded = pg.succeeded
                # the cache's PodGroup changed: the next delta open re-reads it
                self.dirty.note_job(job.uid)
        if write:
            if self._status_degraded():
                metrics.register_status_writes_shed(1)
            else:
                self.status_updater.update_pod_group(pg)
        self.record_job_status_event(job)

    def update_job_statuses_bulk(self, updates) -> None:
        """The close's status pass for ``updates`` [(job, changed,
        need_record)]: stage and run back to back, the serial close's
        form."""
        self.run_status_flush(self.stage_status_flush(updates))

    def stage_status_flush(self, updates, qcounts=None) -> StatusFlush:
        """The derive half of the close-time status pass: everything the
        next session open depends on happens here, before the cycle ends.
        ``updates`` is [(job, changed, need_record)].  A changed job is
        marked dirty (the next delta open re-reads exactly these jobs); a
        changed PodGroup is written; a condition-only update is
        rate-limited to one write per 60 s plus jitter
        (job_updater.go:20-31); events and conditions are rendered for
        every job that needs a record; the queue-status deltas are decided
        and the degraded verdict taken.  What it returns holds values
        only: PodGroup clones, rendered ops and decided queue writes."""
        to_write, ops = [], []
        with self._lock:
            # kbt: allow[KBT001] same wall-clock rate-limit cadence as
            # update_job_status above — write-stream pacing, not scenario time
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
            qwrites, shed_queues = self._stage_queue_statuses_locked(qcounts)
        return StatusFlush(to_write, ops, qwrites, shed_queues, self._status_degraded())

    def run_status_flush(self, flush: StatusFlush) -> None:
        """The egress half: PodGroup writes, the rendered events and
        conditions, then the queue-status writes.  It reads only the
        flush's values and the updater and event seams, so it runs on the
        cycle thread or on the writeback worker alike.  A degraded flush
        sheds its PodGroup writes (to the async pool for a parallel-safe
        updater, else skipped): every close re-derives them.  One failing
        write never stops the others."""
        updater = self.status_updater
        to_write = flush.to_write
        parallel_safe = getattr(updater, "parallel_safe", False)
        if to_write and flush.degraded:
            metrics.register_status_writes_shed(len(to_write))
            logger.warning("degraded cycle: shedding %d status writes%s", len(to_write),
                           " to the async pool" if parallel_safe else "")
            if parallel_safe:
                self._update_pod_groups_pooled(to_write, wait=False)
        elif len(to_write) > 16 and parallel_safe:
            try:
                self._update_pod_groups_pooled(to_write)
            except Exception:  # noqa: BLE001 — re-derived next close
                logger.exception("pooled podgroup status writes failed")
        else:
            for pg in to_write:
                try:
                    updater.update_pod_group(pg)
                except Exception:  # noqa: BLE001 — re-derived next close
                    logger.exception("podgroup status write failed")
        self._apply_status_ops(flush.ops, staged=True)
        if flush.shed_queues:
            metrics.register_status_writes_shed(flush.shed_queues)
        write = getattr(updater, "update_queue_status", None)
        for name, c in flush.qwrites:
            try:
                write(name, c)
            except Exception as e:  # noqa: BLE001 — next close re-derives
                logger.error("queue status write %s failed: %s", name, e)
                with self._lock:
                    # un-record so the next close retries the delta
                    # kbt: allow[KBT002] dict .get on the delta-record map
                    # (the "queue" in its name is QueueStatus, not a Queue)
                    if self._queue_status_written.get(name) == c:
                        del self._queue_status_written[name]

    def _stage_queue_statuses_locked(self, counts) -> tuple:
        """The per-queue status deltas (caller holds the lock): returns
        ([(name, counts)], shed count), recorded as written at stage time so
        the next cycle's decisions never race the flush (a failed write
        un-records).  A degraded cycle writes none; the unwritten counts
        land at the next healthy close.  Queues written before but absent
        from this cycle's counts zero out."""
        if counts is None:
            return [], 0
        if getattr(self.status_updater, "update_queue_status", None) is None:
            return [], 0
        if self._status_degraded():
            return [], len(counts)
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
        return qwrites, 0

    def update_queue_statuses(self, counts: Dict[str, dict]) -> None:
        """Write changed per-queue PodGroup phase counts (QueueStatus,
        types.go:195-204) through the StatusUpdater seam."""
        with self._lock:
            qwrites, shed = self._stage_queue_statuses_locked(counts)
        self.run_status_flush(StatusFlush([], [], qwrites, shed, False))

    def _status_degraded(self) -> bool:
        """Should close-time status flushes shed?  True while the scheduler
        flagged a blown cycle budget, or while the updater reports its
        writeback path failing fast (a ``degraded()`` probe)."""
        if self.shed_status_writes:
            return True
        probe = getattr(self.status_updater, "degraded", None)
        return bool(probe()) if probe is not None else False

    def _update_pod_groups_pooled(self, pgs, wait: bool = True) -> None:
        """16-worker status writeback (the jobUpdater's ParallelizeUntil,
        job_updater.go:18,51-53); a failed write is logged and re-derived
        next cycle.  ``wait=False`` is a degraded cycle's shed: the writes
        drain on the pool behind the loop (``stop()`` reaps them)."""
        from concurrent.futures import ThreadPoolExecutor

        if self._status_pool is None:
            self._status_pool = ThreadPoolExecutor(max_workers=16,
                                                   thread_name_prefix="kb-status")
        update = self.status_updater.update_pod_group

        def write(pg):
            try:
                update(pg)
            except Exception as e:  # noqa: BLE001
                logger.error("podgroup status write %s/%s failed: %s",
                             pg.namespace, pg.name, e)

        if wait:
            list(self._status_pool.map(write, pgs))
        else:
            for pg in pgs:
                self._status_pool.submit(write, pg)

    # ------------------------------------------------------------------
    # session view (cache.go:584-654)
    # ------------------------------------------------------------------
    def _job_in_session(self, uid: str, job: JobInfo) -> bool:
        """The session membership filter: a job enters with a PodGroup or a
        PDB (cache.go:625-633) and a known queue."""
        if job.pod_group is None and job.pdb is None:
            return False
        if job.queue not in self.queues:
            logger.warning("job %s queue %s not found, skipped", uid, job.queue)
            return False
        return True

    def _resolve_job_priority(self, job: JobInfo) -> int:
        """PriorityClass resolution (cache.go:610-620): the named class if
        it exists, else the global default."""
        pg = job.pod_group
        pc = (self.priority_classes.get(pg.priority_class)
              if pg is not None and pg.priority_class else None)
        return pc.value if pc is not None else self.default_priority

    def snapshot(self) -> ClusterInfo:
        """An isolated session's ClusterInfo: deep clones of the Ready
        nodes, every queue, and every session job (``_job_in_session``),
        each job's priority resolved.  Clones are never column-bound, and
        dict order is the cache's."""
        with self._lock:
            ci = ClusterInfo(self.spec)
            for name, node in self.nodes.items():
                if node.ready:
                    ci.nodes[name] = node.clone()
            for name, q in self.queues.items():
                ci.queues[name] = q.clone()
            for uid, job in self.jobs.items():
                if not self._job_in_session(uid, job):
                    continue
                clone = job.clone()
                clone.priority = self._resolve_job_priority(job)
                ci.jobs[uid] = clone
            return ci

    def session_view(self) -> ClusterInfo:
        """The exclusive session's ClusterInfo: shallow views over the live
        objects — Ready nodes, every queue, and every job with a PodGroup or
        a PDB in a known queue, its priority resolved from its
        PriorityClass (cache.go:610-633).  The caller holds the session
        gate."""
        with self._lock:
            ci = ClusterInfo(self.spec)
            ci.nodes = {name: n for name, n in self.nodes.items() if n.ready}
            ci.queues = dict(self.queues)
            pcs_get = self.priority_classes.get
            for uid, job in self.jobs.items():
                pg = job.pod_group
                if pg is None and job.pdb is None:
                    continue
                if job.queue not in self.queues:
                    logger.warning("job %s queue %s not found, skipped", uid, job.queue)
                    continue
                pc = pcs_get(pg.priority_class) if pg is not None and pg.priority_class else None
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
                member = job is not None and (job.pod_group is not None
                                              or job.pdb is not None)
                if member and job.queue not in self.queues:
                    logger.warning("job %s queue %s not found, skipped", uid, job.queue)
                    member = False
                if not member:
                    jobs.pop(uid, None)
                    pg_status.pop(uid, None)
                    continue
                pg = job.pod_group
                pc = pcs_get(pg.priority_class) if pg is not None and pg.priority_class else None
                job.priority = pc.value if pc is not None else self.default_priority
                jobs[uid] = job
                if pg is not None:
                    pg_status[uid] = (pg.phase, pg.running, pg.failed, pg.succeeded)
                else:
                    pg_status.pop(uid, None)
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
