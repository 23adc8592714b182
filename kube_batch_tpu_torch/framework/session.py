"""Session — the per-cycle runtime (framework/session.go,
session_plugins.go, statement.go, framework.go).

Mirrors ``kube_batch_tpu/framework/session.py``.  By default the session
is exclusive: it takes the cache's own objects for the cycle (the cache
defers ingest until close), the tier-configured plugins register their
callbacks, and the mutation verbs (Allocate / Pipeline / Evict) feed the
binder and the evictor.  ``open_session(..., isolated=True)`` is the
reference's deep-cloned session instead: it works on ``cache.snapshot()``
clones, bound to no column (``ssn.columns is None``), so the plugins and
actions take their object branches and the allocate solve reads
``api/snapshot.build_snapshot``; its decisions reach the cache only
through the binder, evictor and status seams.  The hot allocate path does not use the per-task verbs: it
solves on the device and replays the assignment (``actions/allocate.py``);
the verbs serve the replay's per-task Statement path, backfill, reclaim
and preempt.

Across cycles, as the JAX package's defaults do: when churn is low the
open is a delta against the previous cycle's open state (``cache/dirty.py``):
only dirty jobs are re-derived, and only jobs recorded by
``note_fit_state`` have last cycle's fit diagnostics cleared.  The close's
status pass visits only rows whose inputs moved (``j_touched``) plus the
jobs that must report.  The full forms stay as the oracles behind the JAX
package's switches: ``cache.delta_enabled = False`` (``KB_SNAPSHOT_DELTA=0``)
and ``KB_DELTA_CLOSE=0``.

A job defined by a PodDisruptionBudget alone has no PodGroup: the close
records its events (Unschedulable while tasks stay Pending) and writes no
status (job_updater.go:108-111).

Each plugin's OnSessionOpen and OnSessionClose runs in a span of the
cache's tracer (``plugin:<name>.open`` / ``.close``, ``obs/trace.py``),
whose stamps feed the plugin latency histogram.
"""

from __future__ import annotations

import uuid
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kube_batch_tpu_torch.api.cluster_info import ClusterInfo
from kube_batch_tpu_torch.api.columns import (
    CODE_PHASE,
    N_PHASES,
    PHASE_CODE,
    VALID_STATUSES,
)
from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.pod import PodGroupCondition
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.api.types import (
    PodGroupPhase,
    TaskStatus,
    queue_phase_counts,
)
from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.framework.conf import Tier
from kube_batch_tpu_torch.ops.scoring import ScoreWeights
from kube_batch_tpu_torch.utils.switches import switch_on
from kube_batch_tpu_torch.utils import telemetry

# fn-kind names used in the per-plugin registries
JOB_ORDER, QUEUE_ORDER, TASK_ORDER = "job_order", "queue_order", "task_order"
JOB_READY, JOB_PIPELINED, JOB_VALID = "job_ready", "job_pipelined", "job_valid"
JOB_ENQUEUEABLE, OVERUSED = "job_enqueueable", "overused"
PREEMPTABLE, RECLAIMABLE = "preemptable", "reclaimable"
PREDICATE, NODE_ORDER = "predicate", "node_order"

_ENABLE_FIELD = {
    JOB_ORDER: "enabled_job_order",
    QUEUE_ORDER: "enabled_queue_order",
    TASK_ORDER: "enabled_task_order",
    JOB_READY: "enabled_job_ready",
    JOB_PIPELINED: "enabled_job_pipelined",
    JOB_VALID: None,  # JobValid has no enable switch (session_plugins.go:244)
    JOB_ENQUEUEABLE: None,
    OVERUSED: None,
    PREEMPTABLE: "enabled_preemptable",
    RECLAIMABLE: "enabled_reclaimable",
    PREDICATE: "enabled_predicate",
    NODE_ORDER: "enabled_node_order",
}


class Event:
    """Allocate/Deallocate event (framework/event.go:24-32)."""

    def __init__(self, task: TaskInfo):
        self.task = task


class EventHandler:
    """Allocate/Deallocate hooks (framework/event.go:24-32).

    ``columnar_allocate_func(cols, job_sums)`` is the vectorized form the
    column-session allocate replay fires once with the [capJ, R]
    per-job-row resreq sums; ``batch_allocate_func(job, tasks,
    total_resreq)`` the object-session replay's one call per job with the
    presummed resreq (a handler without it gets per-task events); the
    per-task funcs serve the Statement verbs."""

    def __init__(self, allocate_func=None, deallocate_func=None,
                 batch_allocate_func=None, columnar_allocate_func=None):
        self.allocate_func = allocate_func
        self.deallocate_func = deallocate_func
        self.batch_allocate_func = batch_allocate_func
        self.columnar_allocate_func = columnar_allocate_func


class FitFailure(Exception):
    """A predicate rejection with a reason (api.FitError analog)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class Session:
    def __init__(self, cache, cluster: ClusterInfo, tiers: List[Tier],
                 device: torch.device, exclusive: bool = True, open_reuse=None,
                 dirty_jobs=frozenset()):
        self.uid = str(uuid.uuid4())
        self.cache = cache
        # where the session's device programs run; ``mesh`` (set by
        # open_session) is where they run sharded once the node axis
        # reaches parallel/mesh.SHARD_MIN_NODES
        self.device = device
        self.mesh = None
        self.spec = cluster.spec
        # exclusive: the cache's own objects (no clone), and the close unwinds
        # what is session-only (pipelined and unready-allocated placements);
        # isolated: clones, which die with the session
        self.jobs: Dict[str, JobInfo] = cluster.jobs
        self.nodes: Dict[str, NodeInfo] = cluster.nodes
        self.queues: Dict[str, QueueInfo] = cluster.queues
        self.exclusive = exclusive
        # the cache's ColumnStore; None for an isolated session, whose
        # clones are not column-bound
        self.columns = cache.columns if exclusive else None
        # every task Pipelined / set ALLOCATED this session — reverted at
        # close unless it became durable (the reference's clone takes such
        # state to the grave)
        self.pipelined_tasks: List[TaskInfo] = []
        self.allocated_tasks: List[TaskInfo] = []
        self.tiers = tiers
        self.plugins: List = []
        # plugin-fn registries: kind → {plugin_name: fn}
        self._fns: Dict[str, Dict[str, Callable]] = {}
        self.event_handlers: List[EventHandler] = []
        # device-solve knobs populated by plugins at session open
        self.score_weights = ScoreWeights()
        # set by plugins whose predicates the device mask cannot encode;
        # forces per-placement host re-validation for every job
        self.host_only_predicates = False
        # nodes a plugin excludes for the whole session (pressure gates),
        # folded into the snapshot's node_sched
        self.session_excluded_nodes: set = set()
        # PodGroup statuses at open (session.go:102-105): the status pass
        # compares against them, since the session mutates the PodGroup in
        # place.  The same pass clears last cycle's fit diagnostics, or the
        # stale fit errors would replay forever.  ``open_reuse`` (the
        # cache's OpenCache) is its delta form: the cache kept the at-open
        # statuses across cycles, and only jobs recorded by note_fit_state,
        # or dirty, pay the clearing visit.
        self.pod_group_status_at_open: Dict[str, tuple] = {}
        if open_reuse is not None:
            fit_jobs = cache.fit_state_jobs
            for uid in fit_jobs | set(dirty_jobs):
                job = self.jobs.get(uid)
                if job is not None:
                    _clear_fit_state(job)
            fit_jobs.clear()
            self.pod_group_status_at_open = dict(open_reuse.pg_status)
        else:
            at_open = self.pod_group_status_at_open
            for job in self.jobs.values():
                if exclusive:
                    _clear_fit_state(job)  # a clone starts clean
                pg = job.pod_group
                if pg is not None:
                    at_open[job.uid] = (pg.phase, pg.running, pg.failed, pg.succeeded)
        # set once the ColumnStore's session job rows are synced
        self.rows_synced = False
        self._total_alloc_cache = None
        # job uids given an Unschedulable=True condition THIS session
        self.unschedulable_marked: set = set()
        # jobs the open gate dropped (gang-invalid, session.go:107-124):
        # their podgroups still count in the queue phase counts
        self.gate_dropped_jobs: List[JobInfo] = []
        # jobs whose placements the allocate replay discarded host-side
        self.host_discards = 0
        # the configured action names in order, set by the scheduler loop;
        # None when actions are driven directly (reclaim's idle-fit gate
        # then fails closed)
        self.action_names: Optional[List[str]] = None
        # the StatusFlush a staged close returned (close_session), kept so
        # a close whose own finally raised after the stage loses nothing
        self.staged_flush = None
        # an isolated open's cache.snapshot() wall ms (0 when exclusive)
        self.clone_ms = 0.0

    def drop_job(self, uid: str) -> None:
        del self.jobs[uid]

    def note_fit_state(self, job: JobInfo) -> None:
        """Record that ``job`` now carries fit diagnostics (nodes_fit_delta,
        nodes_fit_errors, job_fit_errors): the delta open clears exactly
        these jobs.  Every write site of those fields calls this."""
        self.cache.fit_state_jobs.add(job.uid)

    def session_rows(self):
        """(rows, jobs) of the session job set, from the synced j_sess
        column."""
        cols = self.columns
        rows = np.flatnonzero(cols.j_sess)
        job_by_row = cols.job_by_row
        return rows, [job_by_row[r] for r in rows.tolist()]

    def total_allocatable(self):
        """Σ allocatable over the session's nodes (the drf / proportion
        cluster total, drf.go:57-62), computed once per session."""
        if self._total_alloc_cache is not None:
            return self._total_alloc_cache
        cols = self.columns
        total = self.spec.empty()
        # the session's nodes are exactly the Ready rows; a mismatch (or an
        # isolated session) takes the object loop
        if (cols is not None and len(self.nodes) > 64
                and int(cols.n_valid.sum()) == len(self.nodes)):
            total.vec = cols.n_alloc[cols.n_valid].sum(axis=0)
        else:
            for node in self.nodes.values():
                total.add_(node.allocatable)
        self._total_alloc_cache = total
        return total

    # ---- registration (session_plugins.go:25-97) ------------------------
    def add_fn(self, kind: str, plugin_name: str, fn: Callable) -> None:
        self._fns.setdefault(kind, {})[plugin_name] = fn

    def add_score_row(self, name: str, fn: Callable, weight: float = 1.0) -> None:
        """Register a device score row: ``fn(snap) -> [T, N]`` float32 on
        the snapshot's device, summed into the solve's score plane with
        ``weight`` — the NodeOrderFn / BatchNodeOrderFn surface
        (session_plugins.go:392-492) at the tensor level.  A plugin whose
        policy also matters on the host replay paths registers a host
        scorer through ``add_fn(NODE_ORDER, ...)`` too.  Use a module-level
        function."""
        self.score_weights = self.score_weights._replace(
            extra_rows=self.score_weights.extra_rows + ((name, fn, weight),))

    def add_event_handler(self, handler: EventHandler) -> None:
        self.event_handlers.append(handler)

    def _enabled(self, kind: str, opt) -> bool:
        field = _ENABLE_FIELD[kind]
        return True if field is None else getattr(opt, field)

    def _iter_fns(self, kind: str):
        """fns of enabled plugins of ``kind``, in tier order."""
        fns = self._fns.get(kind, {})
        for tier in self.tiers:
            for opt in tier.plugins:
                fn = fns.get(opt.name)
                if fn is not None and self._enabled(kind, opt):
                    yield fn

    def plugin_enabled(self, name: str) -> bool:
        return any(opt.name == name for tier in self.tiers for opt in tier.plugins)

    def conf_flag(self, key: str, default: bool = False) -> bool:
        """A boolean argument searched across every tier's plugin arguments
        (arguments.go:26-66): the conf surface of action-level switches
        (``reclaim.referenceExact``, ``preempt.referenceExact``,
        ``backfill.realRequests``)."""
        for tier in self.tiers:
            for opt in tier.plugins:
                v = opt.arguments.get(key)
                if v is not None:
                    return str(v).strip().lower() in ("1", "true", "yes")
        return default

    def ordered_enabled_plugins(self, kind: str) -> List[str]:
        """Names of plugins with an enabled fn of ``kind``, in tiered
        dispatch order — the significance order of enqueue's columnar
        ordering keys."""
        fns = self._fns.get(kind, {})
        return [opt.name for tier in self.tiers for opt in tier.plugins
                if opt.name in fns and self._enabled(kind, opt)]

    def enabled_plugin_names(self, kind: str) -> set:
        """Names of plugins with an enabled fn of ``kind`` — lets the allocate
        replay prove the gang arithmetic is the only JobReady veto."""
        return set(self.ordered_enabled_plugins(kind))

    # ---- tiered dispatch ------------------------------------------------
    def _order(self, kind: str, l, r, l_info: Tuple, r_info: Tuple) -> bool:
        """First non-zero verdict wins; fallback creation-then-UID
        (session_plugins.go:281-305)."""
        for fn in self._iter_fns(kind):
            v = fn(l, r)
            if v != 0:
                return v < 0
        return l_info < r_info

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        return self._order(JOB_ORDER, l, r, (l.creation_index, l.uid),
                           (r.creation_index, r.uid))

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        return self._order(QUEUE_ORDER, l, r, (l.name,), (r.name,))

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        return self._order(TASK_ORDER, l, r, (l.pod.creation_index, l.uid),
                           (r.pod.creation_index, r.uid))

    def task_order_plugin_verdict(self, l: TaskInfo, r: TaskInfo) -> int:
        """The tiered task-order verdict alone (< 0: ``l`` first, 0: no
        plugin voted), without the creation fallback — preempt's phase-2
        gate tells "a plugin prefers l" from a mere tie-break."""
        for fn in self._iter_fns(TASK_ORDER):
            v = fn(l, r)
            if v != 0:
                return v
        return 0

    def _veto(self, kind: str, obj) -> bool:
        """Every enabled plugin must pass (session_plugins.go:202-220)."""
        return all(fn(obj) for fn in self._iter_fns(kind))

    def job_ready(self, job: JobInfo) -> bool:
        return self._veto(JOB_READY, job)

    def job_pipelined(self, job: JobInfo) -> bool:
        return self._veto(JOB_PIPELINED, job)

    def job_enqueueable(self, job: JobInfo) -> bool:
        return self._veto(JOB_ENQUEUEABLE, job)

    def job_valid(self, job: JobInfo) -> Optional[str]:
        """First failing plugin's reason, None = valid
        (session_plugins.go:244-260)."""
        for fn in self._iter_fns(JOB_VALID):
            reason = fn(job)
            if reason is not None:
                return reason
        return None

    def overused(self, queue: QueueInfo) -> bool:
        """Any plugin saying overused wins (session_plugins.go:185-199)."""
        return any(fn(queue) for fn in self._iter_fns(OVERUSED))

    def _victims(self, kind: str, actor: TaskInfo, candidates: List[TaskInfo]):
        """Per-tier intersection; the first tier with a verdict wins
        (session_plugins.go:100-182).  None = no plugin in any tier voted."""
        for tier in self.tiers:
            victims: Optional[List[TaskInfo]] = None
            init = False
            for opt in tier.plugins:
                fn = self._fns.get(kind, {}).get(opt.name)
                if fn is None or not self._enabled(kind, opt):
                    continue
                cand = fn(actor, candidates)
                if not init:
                    victims, init = cand, True
                elif victims is not None:
                    cand_uids = {c.uid for c in (cand or [])}
                    victims = [v for v in victims if v.uid in cand_uids]
            if victims is not None:
                return victims
        return None

    def preemptable(self, preemptor: TaskInfo, preemptees: List[TaskInfo]):
        return self._victims(PREEMPTABLE, preemptor, preemptees)

    def reclaimable(self, reclaimer: TaskInfo, reclaimees: List[TaskInfo]):
        return self._victims(RECLAIMABLE, reclaimer, reclaimees)

    def predicate(self, task: TaskInfo, node: NodeInfo) -> None:
        """Every enabled predicate must pass; raises FitFailure
        (session_plugins.go:372-389)."""
        for fn in self._iter_fns(PREDICATE):
            fn(task, node)

    def node_order(self, task: TaskInfo, node: NodeInfo) -> float:
        """Additive score (session_plugins.go:392-412)."""
        return sum(fn(task, node) for fn in self._iter_fns(NODE_ORDER))

    # ---- verbs (session.go:199-363) -------------------------------------
    def _fire(self, allocate: bool, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            fn = eh.allocate_func if allocate else eh.deallocate_func
            if fn is not None:
                fn(Event(task))

    def fire_batch_allocations(self, job: JobInfo, tasks, total_resreq) -> None:
        """Allocate events for ``tasks`` (all of ``job``): one call per
        handler with the batch form, per-task events for the others."""
        for eh in self.event_handlers:
            if eh.batch_allocate_func is not None:
                eh.batch_allocate_func(job, tasks, total_resreq)
            elif eh.allocate_func is not None:
                for t in tasks:
                    eh.allocate_func(Event(t))

    def fire_columnar_allocations(self, cols, job_sums) -> None:
        """One vectorized allocate-event pass for the whole replay."""
        for eh in self.event_handlers:
            if eh.columnar_allocate_func is not None:
                eh.columnar_allocate_func(cols, job_sums)

    def all_handlers_columnar(self) -> bool:
        """Every handler with allocate-side effects has the columnar form —
        the allocate replay's gate for its vectorized path."""
        return all(eh.columnar_allocate_func is not None
                   or (eh.allocate_func is None and eh.batch_allocate_func is None)
                   for eh in self.event_handlers)

    def _place(self, task: TaskInfo, hostname: str, status: TaskStatus) -> None:
        job = self.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, status)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is not None:
            node.add_task(task)

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        self._place(task, hostname, TaskStatus.PIPELINED)
        self.pipelined_tasks.append(task)
        self._fire(True, task)

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """Allocate, and when the job turns ready dispatch every Allocated
        task to the binder (session.go:252-296)."""
        self.cache.allocate_volumes(task, hostname)
        self._place(task, hostname, TaskStatus.ALLOCATED)
        self.allocated_tasks.append(task)
        self._fire(True, task)
        job = self.jobs.get(task.job)
        if job is not None and self.job_ready(job):
            for t in list(job.task_status_index.get(TaskStatus.ALLOCATED, {}).values()):
                self.dispatch(t)

    def dispatch(self, task: TaskInfo) -> None:
        self.cache.bind_volumes(task)
        self.cache.bind(task, task.node_name)
        _mark_binding(self, task)

    def evict(self, task: TaskInfo, reason: str) -> None:
        """Evict at once, outside any Statement (reclaim, reclaim.go:166-179):
        the evictor is called, the task turns Releasing on its job and
        node, and the deallocate events fire."""
        self.cache.evict(task, reason)
        _mark_releasing(self, task)
        self._fire(False, task)

    def statement(self) -> "Statement":
        return Statement(self)

    def update_job_condition(self, job: JobInfo, condition: PodGroupCondition) -> None:
        """Upsert by type (session.go:366-388)."""
        if job.pod_group is None:
            return
        if (condition.type == "Unschedulable" and condition.status == "True"
                and condition.transition_id == self.uid):
            self.unschedulable_marked.add(job.uid)
        cols = self.columns
        if cols is not None and job._cols is cols and job._row >= 0:
            # conditions feed the close pass's need-record set and its
            # touched-row visit: the delta close must see this write
            cols.j_has_conds[job._row] = True
            cols.j_touched[job._row] = True
        for i, c in enumerate(job.pod_group.conditions):
            if c.type == condition.type:
                job.pod_group.conditions[i] = condition
                return
        job.pod_group.conditions.append(condition)


class Statement:
    """All-or-nothing op log (statement.go:29-337): the verbs mutate session
    state at once and log an op; commit sends the evictions and allocations
    out in order, discard undoes in reverse."""

    def __init__(self, ssn: Session):
        self.ssn = ssn
        self.operations: List[Tuple[str, tuple]] = []

    def evict(self, task: TaskInfo, reason: str) -> None:
        """Releasing in the session now; the evictor is called at commit."""
        ssn = self.ssn
        _mark_releasing(ssn, task)
        ssn._fire(False, task)
        self.operations.append(("evict", (task, reason)))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        ssn = self.ssn
        ssn._place(task, hostname, TaskStatus.PIPELINED)
        ssn.pipelined_tasks.append(task)
        ssn._fire(True, task)
        self.operations.append(("pipeline", (task, hostname)))

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        ssn = self.ssn
        ssn.cache.allocate_volumes(task, hostname)
        ssn._place(task, hostname, TaskStatus.ALLOCATED)
        ssn.allocated_tasks.append(task)
        ssn._fire(True, task)
        self.operations.append(("allocate", (task, hostname)))

    def commit(self) -> None:
        """Send the operations out: without evictions every allocation
        binds in one batch; with them, evictions and binds go out in
        order.  A pipeline op is session-only state and needs nothing."""
        ssn = self.ssn
        if not any(name == "evict" for name, _ in self.operations):
            allocs = [args for name, args in self.operations if name == "allocate"]
            if allocs:
                for task, _ in allocs:
                    ssn.cache.bind_volumes(task)
                ssn.cache.bulk_bind([(task, task.node_name) for task, _ in allocs])
                for task, _ in allocs:
                    _mark_binding(ssn, task)
            self.operations = []
            return
        for name, (task, arg) in self.operations:
            if name == "evict":
                ssn.cache.evict(task, arg)
            elif name == "allocate":
                ssn.cache.bind_volumes(task)
                ssn.cache.bind(task, task.node_name)
                _mark_binding(ssn, task)
        self.operations = []

    def discard(self) -> None:
        for name, (task, _) in reversed(self.operations):
            if name == "evict":
                # unevict: Running again on its job and node
                job = self.ssn.jobs.get(task.job)
                if job is not None:
                    job.update_task_status(task, TaskStatus.RUNNING)
                node = self.ssn.nodes.get(task.node_name)
                if node is not None:
                    node.update_task(task)
                self.ssn._fire(True, task)
                continue
            # an allocate frees its volume reservation; a pipeline held none
            _undo_placement(self.ssn, task, release_volumes=(name == "allocate"))
            self.ssn._fire(False, task)
        self.operations = []


def _clear_fit_state(job: JobInfo) -> None:
    if job.nodes_fit_delta:
        job.nodes_fit_delta = {}
    if job.nodes_fit_errors:
        job.nodes_fit_errors = {}
    if job.job_fit_errors:
        job.job_fit_errors = ""


# ---- session lifecycle (framework/framework.go:30-62) -------------------

def open_session(cache, tiers: List[Tier], device=None,
                 isolated: bool = False, mesh=None) -> Session:
    """Open a scheduling session: by default an exclusive one — take the
    cache's gate, view its live objects, sync the column job rows — then
    run every plugin's OnSessionOpen and drop gang-invalid jobs, marking
    them Unschedulable (session.go:107-124).  ``device`` is where the
    session's device programs run (None means CUDA; see
    ``kube_batch_tpu_torch.device``); ``mesh`` (``parallel/mesh.py``) is
    where they run sharded, the actions deciding per node axis as the JAX
    package's do (``should_shard``).  ``isolated=True`` is the reference's
    deep-cloned session (``cache.snapshot()``): no gate, no column rows,
    the objects' branches throughout, and nothing of the session's own
    state reaches the cache — what-if callers inspect it freely.

    The open is incremental when churn allows: with the delta enabled, a
    valid open cache, no queue or priority-class change and at most
    ``max(32, threshold × jobs)`` dirty jobs, the membership view, the
    at-open statuses, the fit-state clears and the column job rows are
    deltas keyed on the cache's dirty sets; otherwise the full rebuild
    runs and reseeds the open cache.  Any exception invalidates the open
    cache, so the next open is full."""
    from kube_batch_tpu_torch.framework.interface import get_plugin_builder

    dev = resolve_device(device)
    if isolated:
        t0 = telemetry.perf_counter()
        cluster = cache.snapshot()
        clone_ms = (telemetry.perf_counter() - t0) * 1e3
        ssn = Session(cache, cluster, tiers, dev, exclusive=False)
        ssn.mesh = mesh
        ssn.clone_ms = clone_ms
        _open_plugins_and_gate(ssn, tiers, get_plugin_builder)
        return ssn
    cache.begin_exclusive_session()
    oc = cache.open_cache
    try:
        delta = cache.take_dirty()
        use_delta = (cache.delta_enabled and oc.valid
                     and not (delta.full or delta.queues_changed
                              or delta.priority_classes_changed)
                     and len(delta.jobs) <= max(
                         32, cache.delta_churn_threshold * len(oc.jobs)))
        if use_delta:
            cache.last_open_path = "delta"
            cache.last_churn = delta.churn_fraction(len(oc.jobs))
            cluster = cache.session_view_delta(delta)
        else:
            cache.last_open_path = "full"
            cache.last_churn = delta.churn_fraction(len(cache.jobs))
            cluster = cache.session_view()
        ssn = Session(cache, cluster, tiers, dev,
                      open_reuse=oc if use_delta else None,
                      dirty_jobs=delta.jobs if use_delta else frozenset())
        ssn.mesh = mesh
        if not use_delta:
            # reseed the open cache from this full rebuild, before the gate
            # mutates ssn.jobs (the same dict as cluster.jobs)
            cache.rebuild_open_cache(cluster, ssn.pod_group_status_at_open)
        cols = ssn.columns
        # the job rows (j_sess membership, j_min, j_queue, ...) before the
        # plugin opens: proportion's open, the gang gate, the snapshot and
        # the close status pass all read them
        if use_delta:
            cols.sync_session_rows(ssn, dirty_uids=delta.jobs,
                                   restore_rows=oc.gate_dropped_rows)
        else:
            cols.sync_session_rows(ssn)
        ssn.rows_synced = True
        oc.gate_dropped_rows = _open_plugins_and_gate(ssn, tiers, get_plugin_builder)
    except BaseException:
        # a half-opened session may have consumed dirty marks without
        # refreshing the open cache: the next open rebuilds from scratch
        oc.invalidate()
        cache.dirty.mark_full()
        cache.end_exclusive_session()
        raise
    return ssn


def _open_plugins_and_gate(ssn: Session, tiers: List[Tier], get_plugin_builder) -> set:
    """Run every plugin's OnSessionOpen, then the gang-validity gate
    (session.go:107-124), after the plugins registered their JobValid fns.
    Returns the column rows the gate dropped.  In a column session where
    gang is the only voter its verdict IS the count compare, so one
    counts-matrix expression finds the (normally sparse) invalid set and
    only those jobs take the full dispatch for their reason string."""
    from kube_batch_tpu_torch.obs.trace import tracer_of

    tracer = tracer_of(ssn.cache)
    for tier in tiers:
        for opt in tier.plugins:
            plugin = get_plugin_builder(opt.name)(opt.arguments)
            ssn.plugins.append(plugin)
            # the span is the measurement: the plugin latency histogram
            # reads its stamps
            with tracer.span("plugin:" + opt.name + ".open") as sp:
                plugin.on_session_open(ssn)
            metrics.observe_plugin_latency(opt.name, "OnSessionOpen", sp.dur_us)
    cols = ssn.columns
    valid_voters = set(ssn._fns.get(JOB_VALID, {}))
    if cols is not None and ssn.rows_synced and valid_voters <= {"gang"} and ssn.jobs:
        gate_jobs = []
        if valid_voters:
            rows, jobs_list = ssn.session_rows()
            valid_num = cols.j_counts[rows][:, VALID_STATUSES].sum(axis=1)
            gate_jobs = [(jobs_list[i].uid, jobs_list[i])
                         for i in np.flatnonzero(valid_num < cols.j_min[rows])]
    else:
        gate_jobs = list(ssn.jobs.items())
    dropped_rows = set()
    for uid, job in gate_jobs:
        reason = ssn.job_valid(job)
        if reason is not None:
            ssn.update_job_condition(job, PodGroupCondition(
                type="Unschedulable",
                status="True",
                transition_id=ssn.uid,
                reason="NotEnoughPods",
                message=reason,
            ))
            ssn.cache.record_job_status_event(job)
            ssn.gate_dropped_jobs.append(job)
            ssn.drop_job(uid)
            if cols is not None and job._cols is cols and job._row >= 0:
                # the dropped job leaves the snapshot too; its row is kept
                # so the next delta open re-admits it to the vote
                cols.j_sess[job._row] = False
                dropped_rows.add(job._row)
    return dropped_rows


def job_status(ssn: Session, job: JobInfo) -> None:
    """Derive and set the PodGroup phase and counts (session.go:151-189):
    the object form of the close's columnar pass.  A shadow PodGroup (made
    for a plain pod, cache/util.go:42-60) carries no durable phase."""
    pg = job.pod_group
    if pg is None:
        return
    if pg.shadow:
        pg.running = len(job.task_status_index.get(TaskStatus.RUNNING, {}))
        pg.failed = len(job.task_status_index.get(TaskStatus.FAILED, {}))
        pg.succeeded = len(job.task_status_index.get(TaskStatus.SUCCEEDED, {}))
        return
    unschedulable = any(c.type == "Unschedulable" and c.status == "True"
                        and c.transition_id == ssn.uid for c in pg.conditions)
    running = len(job.task_status_index.get(TaskStatus.RUNNING, {}))
    if running and unschedulable:
        pg.phase = PodGroupPhase.UNKNOWN
    else:
        allocated = job.task_num(TaskStatus.BOUND, TaskStatus.BINDING,
                                 TaskStatus.RUNNING, TaskStatus.ALLOCATED)
        if allocated >= pg.min_member:
            pg.phase = PodGroupPhase.RUNNING
        elif pg.phase != PodGroupPhase.INQUEUE:
            pg.phase = PodGroupPhase.PENDING
    pg.running = running
    pg.failed = len(job.task_status_index.get(TaskStatus.FAILED, {}))
    pg.succeeded = len(job.task_status_index.get(TaskStatus.SUCCEEDED, {}))


def _mark_releasing(ssn: Session, task: TaskInfo) -> None:
    """Releasing on the task's job and re-accounted on its node."""
    job = ssn.jobs.get(task.job)
    if job is not None:
        job.update_task_status(task, TaskStatus.RELEASING)
    node = ssn.nodes.get(task.node_name)
    if node is not None:
        node.update_task(task)


def _mark_binding(ssn: Session, task: TaskInfo) -> None:
    job = ssn.jobs.get(task.job)
    if job is not None:
        job.update_task_status(task, TaskStatus.BINDING)


def _undo_placement(ssn: Session, task: TaskInfo, release_volumes: bool) -> None:
    """The shared placement undo: status → PENDING, node removal, node_name
    cleared, and (for allocations) the volume reservation released."""
    job = ssn.jobs.get(task.job)
    if job is not None and task.key() in job.tasks:
        job.update_task_status(task, TaskStatus.PENDING)
    node = ssn.nodes.get(task.node_name) if task.node_name else None
    if node is not None and task.key() in node.tasks:
        node.remove_task(task)
    task.node_name = None
    if release_volumes:
        task.volume_ready = False
        release = getattr(ssn.cache.volume_binder, "release_task", None)
        if release is not None:
            release(task.uid)


def _revert_residue(ssn: Session, tasks: List[TaskInfo], expected: TaskStatus,
                    release_volumes: bool) -> None:
    """Revert session-only placements still in ``expected`` status to
    PENDING (idempotent: dispatched or discarded tasks are skipped)."""
    for task in tasks:
        if task.status == expected:
            _undo_placement(ssn, task, release_volumes)


def _close_status_columnar(ssn: Session):
    """The close-session status pass over the counts matrix: the phase
    derivation of job_status (session.go:151-189) as arithmetic, and a
    per-job visit only for jobs that changed or have something to report.
    Returns ([(job, changed, need_record)], per-queue phase counts).

    Delta form: every count write, session row re-sync and mid-cycle phase
    or condition write stamps ``cols.j_touched``.  A row not stamped since
    the last close has the same derivation inputs (counts, phase,
    min_member, unschedulable marks), so its phase and count writes would
    be no-ops and its at-open compare would read unchanged: the visit
    covers the touched rows plus the standing need-record set (stuck
    tasks, Pending or Unknown phases, jobs with conditions), and the
    per-queue counts are one bincount over every session row's j_phase.
    ``KB_DELTA_CLOSE=0`` visits every row."""
    cols = ssn.columns
    rows_all = np.flatnonzero(cols.j_sess)
    if switch_on("KB_DELTA_CLOSE") and rows_all.size:
        jc = cols.j_counts
        phase_codes = cols.j_phase[rows_all]
        visit = (cols.j_touched[rows_all]
                 | ((jc[rows_all, int(TaskStatus.PENDING)]
                     + jc[rows_all, int(TaskStatus.ALLOCATED)]) > 0)
                 | (phase_codes == PHASE_CODE[PodGroupPhase.PENDING])
                 | (phase_codes == PHASE_CODE[PodGroupPhase.UNKNOWN])
                 | cols.j_has_conds[rows_all]
                 # PDB jobs with Pending tasks report every close
                 | (~cols.j_has_pg[rows_all] & cols.j_pdb[rows_all]
                    & (jc[rows_all, int(TaskStatus.PENDING)] > 0)))
        rows = rows_all[visit]
    else:
        rows = rows_all
    jobs_list = [cols.job_by_row[r] for r in rows.tolist()]
    counts = cols.j_counts[rows]
    running_l = counts[:, int(TaskStatus.RUNNING)].tolist()
    failed_l = counts[:, int(TaskStatus.FAILED)].tolist()
    succ_l = counts[:, int(TaskStatus.SUCCEEDED)].tolist()
    pending_l = counts[:, int(TaskStatus.PENDING)].tolist()
    # phase derives from pg.min_member, not job.min_available, which a PDB
    # overwrites on a job that has both (session.go:151-189)
    alloc_l = (counts[:, int(TaskStatus.BOUND)] + counts[:, int(TaskStatus.BINDING)]
               + counts[:, int(TaskStatus.RUNNING)]
               + counts[:, int(TaskStatus.ALLOCATED)]).tolist()
    # tasks stuck Pending/Allocated → fit-error conditions must be written
    # (cache.go:704-719)
    stuck_l = (counts[:, int(TaskStatus.PENDING)]
               + counts[:, int(TaskStatus.ALLOCATED)]).tolist()
    prev_get = ssn.pod_group_status_at_open.get
    unsched_marked = ssn.unschedulable_marked
    RUNNING, PENDING, UNKNOWN, INQUEUE = (PodGroupPhase.RUNNING, PodGroupPhase.PENDING,
                                          PodGroupPhase.UNKNOWN, PodGroupPhase.INQUEUE)
    updates = []
    rows_l = rows.tolist()
    j_phase = cols.j_phase
    record_event = ssn.cache.record_job_status_event
    for i, job in enumerate(jobs_list):
        pg = job.pod_group
        if pg is None:
            # a PDB-defined job: events only (job_updater.go:108-111)
            if job.pdb is not None and pending_l[i]:
                record_event(job)
            continue
        r, f, s = running_l[i], failed_l[i], succ_l[i]
        if pg.shadow:
            # synthesized groups carry no durable phase; changed counts
            # still write
            pg.running, pg.failed, pg.succeeded = r, f, s
            changed = prev_get(job.uid) != (pg.phase, r, f, s)
            if changed or stuck_l[i]:
                updates.append((job, changed, bool(stuck_l[i])))
            continue
        if r and job.uid in unsched_marked:
            phase = UNKNOWN
        elif alloc_l[i] >= pg.min_member:
            phase = RUNNING
        elif pg.phase != INQUEUE:
            phase = PENDING
        else:
            phase = pg.phase
        pg.phase, pg.running, pg.failed, pg.succeeded = phase, r, f, s
        j_phase[rows_l[i]] = PHASE_CODE[phase]
        changed = prev_get(job.uid) != (phase, r, f, s)
        need_record = bool(stuck_l[i]) or phase is PENDING or phase is UNKNOWN
        if changed or need_record or pg.conditions:
            updates.append((job, changed, need_record))
    # per-queue podgroup-phase counts (QueueStatus): one bincount over every
    # session row's phase code — visited rows were just rewritten, and an
    # unvisited row's phase could not move this cycle
    qcounts: Dict[str, dict] = {}
    sel = rows_all[cols.j_has_pg[rows_all] & ~cols.j_shadow[rows_all]]
    pcodes = cols.j_phase[sel]
    ok = pcodes >= 0
    sel, pcodes = sel[ok], pcodes[ok]
    if sel.size:
        pairs = cols.j_queue[sel].astype(np.int64) * N_PHASES + pcodes
        bc = np.bincount(pairs, minlength=cols.queues.cap * N_PHASES).reshape(
            cols.queues.cap, N_PHASES)
        for qi in np.flatnonzero(bc.any(axis=1)).tolist():
            qc = queue_phase_counts()
            for code in range(N_PHASES):
                qc[CODE_PHASE[code].value.lower()] = int(bc[qi, code])
            qcounts[cols.queue_names[qi]] = qc
    _count_gate_dropped(ssn, qcounts)
    # consumed: ingest applied after this point (deferred mutations, the
    # residue reverts) stamps rows for the next cycle's visit
    cols.j_touched[:] = False
    return updates, qcounts


def _count_gate_dropped(ssn: Session, qcounts: Dict[str, dict]) -> None:
    """Fold the podgroups of gang-invalid jobs (dropped by the open gate)
    into the queue phase counts: QueueStatus counts podgroups by phase,
    not by session membership."""
    for job in ssn.gate_dropped_jobs:
        pg = job.pod_group
        if pg is None or pg.shadow or job.queue not in ssn.queues:
            continue
        qc = qcounts.get(job.queue)
        if qc is None:
            qc = qcounts[job.queue] = queue_phase_counts()
        qc[(pg.phase or PodGroupPhase.PENDING).value.lower()] += 1


def close_session(ssn: Session, stage_flush: bool = False):
    """Plugin close hooks, then the job-status pass (framework.go:55-62 +
    job_updater.go:33-122); then unwind the session-only placements, join
    the bind dispatcher, and release the cache gate, which applies the
    deferred ingest.

    ``stage_flush=True`` is the pipelined cycle's close: the status pass
    still derives everything the next open depends on (phases, dirty
    stamps, rate-limit windows, queue deltas, the degraded verdict), but
    the egress half is returned as a ``StatusFlush`` (also kept in
    ``ssn.staged_flush``) for the writeback stage, and the bind drain is
    left to that stage too (the cache's in-flight bind map protects
    deferred ingest in the meantime).  An empty session stages its queue
    zero-outs the same way.  A serial close returns None."""
    from kube_batch_tpu_torch.obs.trace import tracer_of

    tracer = tracer_of(ssn.cache)
    flush = None
    try:
        for plugin in ssn.plugins:
            with tracer.span("plugin:" + plugin.name + ".close") as sp:
                plugin.on_session_close(ssn)
            metrics.observe_plugin_latency(plugin.name, "OnSessionClose", sp.dur_us)
        if ssn.columns is None:
            # an isolated session: the per-job object pass, each PodGroup's
            # derived status copied onto the cache's own
            qcounts: Dict[str, dict] = {}
            for job in ssn.jobs.values():
                if job.pod_group is None:
                    # PDB-defined jobs: events only (job_updater.go:108-111;
                    # unschedulable while tasks stay Pending, cache.go:699)
                    if job.pdb is not None and job.task_status_index.get(
                            TaskStatus.PENDING):
                        ssn.cache.record_job_status_event(job)
                    continue
                job_status(ssn, job)
                pg = job.pod_group
                if not pg.shadow and pg.phase is not None:
                    qc = qcounts.setdefault(job.queue, queue_phase_counts())
                    qc[pg.phase.value.lower()] += 1
                ssn.cache.update_job_status(
                    job, prev_status=ssn.pod_group_status_at_open.get(job.uid))
            _count_gate_dropped(ssn, qcounts)
            if stage_flush:
                flush = ssn.staged_flush = ssn.cache.stage_status_flush((), qcounts)
            else:
                ssn.cache.update_queue_statuses(qcounts)
        elif ssn.jobs:
            updates, qcounts = _close_status_columnar(ssn)
            flush = ssn.staged_flush = ssn.cache.stage_status_flush(updates, qcounts)
            if not stage_flush:
                ssn.cache.run_status_flush(flush)
                flush = ssn.staged_flush = None
        else:
            qcounts: Dict[str, dict] = {}
            _count_gate_dropped(ssn, qcounts)
            if stage_flush:
                # not inline: the previous cycle's writeback may be running
                flush = ssn.staged_flush = ssn.cache.stage_status_flush((), qcounts)
            else:
                ssn.cache.update_queue_statuses(qcounts)
    finally:
        if ssn.exclusive:
            # Pipelined placements exist only inside a session, and a task
            # still ALLOCATED belongs to a job that never turned ready: both
            # revert, so they leak no accounting onto the cache (an isolated
            # session's clones just die)
            _revert_residue(ssn, ssn.pipelined_tasks, TaskStatus.PIPELINED,
                            release_volumes=False)
            _revert_residue(ssn, ssn.allocated_tasks, TaskStatus.ALLOCATED,
                            release_volumes=True)
            if not stage_flush:
                # the binder acks land before the deferred ingest applies: a
                # deferred pod update must see this cycle's bindings
                ssn.cache.flush_binds()
            ssn.cache.end_exclusive_session()
        ssn.jobs = {}
        ssn.nodes = {}
        ssn.queues = {}
        ssn.plugins = []
        ssn.pipelined_tasks = []
        ssn.allocated_tasks = []
    return flush
