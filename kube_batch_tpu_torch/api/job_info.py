"""JobInfo — a gang (PodGroup) of tasks with status-indexed accounting.

Mirrors ``kube_batch_tpu/api/job_info.py`` (the reference's
job_info.go:127-418 and unschedule_info.go:22-112): the per-status task
index, the allocated / total / pending ledgers, the MinAvailable gang
threshold, Ready()/Pipelined(), and the fit-error bookkeeping.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

from kube_batch_tpu_torch.api.pod import PodGroup
from kube_batch_tpu_torch.api.resources import Resource, ResourceSpec
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.api.types import TaskStatus, is_allocated
from kube_batch_tpu_torch.utils.assertions import graft_assert


class FitError:
    """Why one task failed on one node (unschedule_info.go:40-71)."""

    def __init__(self, task: TaskInfo, node_name: str, reasons: List[str]):
        self.task_namespace = task.namespace
        self.task_name = task.name
        self.node_name = node_name
        self.reasons = reasons

    def error(self) -> str:
        return (f"task {self.task_namespace}/{self.task_name} on node "
                f"{self.node_name} fit failed: {', '.join(self.reasons)}")


class FitErrors:
    """Per-task node→FitError map with a reason-histogram rendering
    (unschedule_info.go:74-112): per-node errors from host predicate loops,
    or a reason histogram straight from the device."""

    def __init__(self):
        self.nodes: Dict[str, FitError] = {}
        self._hist: Dict[str, int] = {}
        self._n_nodes = 0

    def set_node_error(self, node_name: str, err: FitError) -> None:
        self.nodes[node_name] = err

    def set_histogram(self, counts: Dict[str, int], n_nodes: int) -> None:
        self._hist = {r: int(n) for r, n in counts.items() if n}
        self._n_nodes = n_nodes

    def error(self) -> str:
        hist: Dict[str, int] = defaultdict(int, self._hist)
        for fe in self.nodes.values():
            for r in fe.reasons:
                hist[r] += 1
        n = max(len(self.nodes), self._n_nodes)
        reasons = "; ".join(f"{n_} {r}" for r, n_ in sorted(hist.items(),
                                                             key=lambda kv: kv[0]))
        return f"0/{n} nodes are available, {reasons}." if hist else ""


class JobInfo:
    def __init__(self, uid: str, spec: ResourceSpec,
                 pod_group: Optional[PodGroup] = None):
        self.uid = uid
        self.spec = spec
        self.name = ""
        self.namespace = ""
        self.queue: str = ""
        self.priority: int = 0
        self.min_available: int = 0
        self.tasks: Dict[str, TaskInfo] = {}
        # TaskStatusIndex (job_info.go:141): status → {taskKey: task}
        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = defaultdict(dict)
        self.allocated: Resource = spec.empty()
        self.total_request: Resource = spec.empty()
        # sum of Pending tasks' resreq (proportion's request, proportion.go:87-99)
        self.pending_request: Resource = spec.empty()
        self.nodes_fit_delta: Dict[str, Resource] = {}
        self.nodes_fit_errors: Dict[str, FitErrors] = {}  # taskUID → FitErrors
        self.job_fit_errors: str = ""
        self.pod_group: Optional[PodGroup] = None
        self.pdb = None  # the legacy gang source (job_info.go:199-212 SetPDB)
        self.creation_index: int = 0
        # ColumnStore binding (api/columns.py): when bound, the three ledger
        # Resources are views into the store's [J, R] matrices and the index
        # choke points mirror per-status counts into j_counts
        self._cols = None
        self._row: int = -1
        if pod_group is not None:
            self.set_pod_group(pod_group)

    def set_pod_group(self, pg: PodGroup) -> None:
        """(job_info.go:171-208)"""
        self.name = pg.name
        self.namespace = pg.namespace
        self.min_available = pg.min_member
        self.queue = pg.queue
        self.creation_index = pg.creation_index
        self.pod_group = pg

    def set_pdb(self, pdb) -> None:
        """(job_info.go:199-212)"""
        self.name = pdb.name
        self.namespace = pdb.namespace
        self.min_available = pdb.min_available
        self.creation_index = pdb.creation_index
        self.pdb = pdb

    def unset_pdb(self) -> None:
        self.pdb = None

    def _note_alloc(self) -> None:
        """The allocated-ledger choke point: ``allocated`` is a view of the
        store's j_alloc row, so every add_ / sub_ marks the row for the
        float32 twin's refresh (``columns.job_alloc32``)."""
        if self._cols is not None and self._row >= 0:
            self._cols.note_job_alloc(self._row)

    # -- task bookkeeping (job_info.go:211-263) ---------------------------
    def _index_add(self, task: TaskInfo) -> None:
        self.task_status_index[task.status][task.key()] = task
        if self._cols is not None:
            self._cols.j_counts[self._row, int(task.status)] += 1
            self._cols.j_touched[self._row] = True

    def _index_remove(self, task: TaskInfo) -> None:
        bucket = self.task_status_index.get(task.status)
        if bucket is not None:
            popped = bucket.pop(task.key(), None)
            if not bucket:
                del self.task_status_index[task.status]
            if popped is not None and self._cols is not None:
                self._cols.j_counts[self._row, int(task.status)] -= 1
                self._cols.j_touched[self._row] = True

    def add_task(self, task: TaskInfo) -> None:
        key = task.key()
        graft_assert(key not in self.tasks, f"duplicate task {key} in job {self.uid}")
        self.tasks[key] = task
        self._index_add(task)
        if is_allocated(task.status):
            self.allocated.add_(task.resreq)
            self._note_alloc()
        elif task.status == TaskStatus.PENDING:
            self.pending_request.add_(task.resreq)
        self.total_request.add_(task.resreq)

    def delete_task(self, task: TaskInfo) -> None:
        key = task.key()
        existing = self.tasks.get(key)
        graft_assert(existing is not None, f"task {key} not in job {self.uid}")
        if existing is None:
            return
        if is_allocated(existing.status):
            self.allocated.sub_(existing.resreq)
            self._note_alloc()
        elif existing.status == TaskStatus.PENDING:
            self.pending_request.sub_(existing.resreq)
        self.total_request.sub_(existing.resreq)
        self._index_remove(existing)
        del self.tasks[key]

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """delete + re-add under the new status so the index and ledgers
        stay consistent (job_info.go:250-263)."""
        if task.key() in self.tasks:
            self.delete_task(task)
        task.status = status
        self.add_task(task)

    def bulk_transition(self, tasks, status: TaskStatus, resreq_sum,
                        pending_sum=None) -> None:
        """update_task_status for a batch of this job's tasks, for the
        object-session allocate replay: ``resreq_sum`` is the presummed
        Resource over the tasks whose allocated-ness flips (all of them or
        none), ``pending_sum`` that of the tasks leaving or entering
        Pending (summed here when absent).  The end state is the per-task
        loop's."""
        if not tasks:
            return
        new_alloc = is_allocated(status)
        idx = self.task_status_index
        new_bucket = idx[status]
        pend_delta = None  # resreq sum of the tasks leaving Pending
        cols = self._cols
        src_status = tasks[0].status
        src_bucket = idx.get(src_status)
        if (not new_bucket and src_bucket is not None
                and len(src_bucket) == len(tasks) and src_status != status
                and all(t.status == src_status for t in tasks)):
            # a whole source bucket moves into an empty one: rebind it
            del idx[src_status]
            idx[status] = src_bucket
            if cols is not None:
                counts = cols.j_counts[self._row]
                counts[int(src_status)] -= len(tasks)
                counts[int(status)] += len(tasks)
                cols.j_touched[self._row] = True
            flipped = len(tasks) if is_allocated(src_status) != new_alloc else 0
            pend_src = src_status == TaskStatus.PENDING
            new_pend = status == TaskStatus.PENDING
            for task in tasks:
                task.status = status
            if pend_src != new_pend:
                acc = pending_sum
                if acc is None:
                    acc = self.spec.empty()
                    for task in tasks:
                        acc.add_(task.resreq)
                if pend_src:
                    pend_delta = acc
                else:
                    self.pending_request.add_(acc)
        else:
            flipped = 0
            new_pend = status == TaskStatus.PENDING
            pend_acc = None
            counts = cols.j_counts[self._row] if cols is not None else None
            if cols is not None:
                cols.j_touched[self._row] = True
            for task in tasks:
                key = task._key
                was_pend = task.status == TaskStatus.PENDING
                bucket = idx.get(task.status)
                if bucket is not None:
                    popped = bucket.pop(key, None)
                    if not bucket and bucket is not new_bucket:
                        del idx[task.status]
                    if popped is not None and counts is not None:
                        counts[int(task.status)] -= 1
                if counts is not None:
                    counts[int(status)] += 1
                if is_allocated(task.status) != new_alloc:
                    flipped += 1
                if was_pend != new_pend:
                    if new_pend:
                        self.pending_request.add_(task.resreq)
                    else:
                        if pend_acc is None:
                            pend_acc = self.spec.empty()
                        pend_acc.add_(task.resreq)
                task.status = status
                new_bucket[key] = task
            if pend_acc is not None:
                pend_delta = pend_acc
        if pend_delta is not None:
            self.pending_request.sub_(pend_delta)
        if flipped:
            graft_assert(flipped == len(tasks),
                         f"bulk_transition: mixed allocated-ness flip in job {self.uid}")
            if new_alloc:
                self.allocated.add_(resreq_sum)
            else:
                self.allocated.sub_(resreq_sum)
            self._note_alloc()

    def rebucket_moved(self, tasks, status: TaskStatus) -> None:
        """Status-index bucket moves only, for the columnar allocate replay:
        ledgers, counts, ``j_touched`` and the t_status column were already
        updated by whole-matrix ops, so this touches the bucket dicts and
        the raw ``_status`` attributes."""
        if not tasks:
            return
        idx = self.task_status_index
        new_bucket = idx[status]
        src_status = tasks[0]._status
        src_bucket = idx.get(src_status)
        if (not new_bucket and src_bucket is not None
                and len(src_bucket) == len(tasks) and src_status != status):
            # the whole source bucket moves into an empty one: rebind it
            del idx[src_status]
            idx[status] = src_bucket
            for t in tasks:
                t._status = status
        else:
            for t in tasks:
                b = idx.get(t._status)
                if b is not None:
                    b.pop(t._key, None)
                    if not b and b is not new_bucket:
                        del idx[t._status]
                t._status = status
                new_bucket[t._key] = t

    # -- gang predicates (job_info.go:367-418) ----------------------------
    def task_num(self, *statuses: TaskStatus) -> int:
        idx = self.task_status_index
        return sum(len(idx[s]) for s in statuses if s in idx)

    @property
    def ready_task_num(self) -> int:
        """ReadyTaskNum (job_info.go:367-380): allocated statuses plus
        Succeeded."""
        return self.task_num(TaskStatus.BOUND, TaskStatus.BINDING,
                             TaskStatus.RUNNING, TaskStatus.ALLOCATED,
                             TaskStatus.SUCCEEDED)

    @property
    def waiting_task_num(self) -> int:
        """Pipelined tasks (job_info.go:383-391)."""
        return self.task_num(TaskStatus.PIPELINED)

    @property
    def valid_task_num(self) -> int:
        """ValidTaskNum (job_info.go:394-409): allocated statuses, Succeeded,
        Pipelined and Pending."""
        return self.task_num(TaskStatus.PENDING, TaskStatus.ALLOCATED,
                             TaskStatus.PIPELINED, TaskStatus.BINDING,
                             TaskStatus.BOUND, TaskStatus.RUNNING,
                             TaskStatus.SUCCEEDED)

    def ready(self) -> bool:
        return self.ready_task_num >= self.min_available

    def pipelined(self) -> bool:
        return self.ready_task_num + self.waiting_task_num >= self.min_available

    def fit_error(self) -> str:
        """Histogram of task statuses (job_info.go:347-364)."""
        counts = {s.name: len(m) for s, m in sorted(self.task_status_index.items())}
        body = ", ".join(f"{n} {s}" for s, n in counts.items())
        return f"job is not ready, {body}"

    def clone(self) -> "JobInfo":
        """A copy for an isolated session: never column-bound, its tasks
        cloned in the same order, its ledgers copied, its per-session
        diagnostics empty (job_info.go:295-329)."""
        j = JobInfo.__new__(JobInfo)
        j._cols = None
        j._row = -1
        j.uid = self.uid
        j.spec = self.spec
        j.name = self.name
        j.namespace = self.namespace
        j.queue = self.queue
        j.priority = self.priority
        j.min_available = self.min_available
        j.creation_index = self.creation_index
        j.pod_group = self.pod_group.clone() if self.pod_group else None
        j.pdb = self.pdb  # not mutated after ingest
        j.nodes_fit_delta = {}
        j.nodes_fit_errors = {}
        j.job_fit_errors = ""
        new_tasks = {key: t.clone() for key, t in self.tasks.items()}
        j.tasks = new_tasks
        j.task_status_index = defaultdict(dict)
        for status, bucket in self.task_status_index.items():
            if bucket:
                j.task_status_index[status] = {k: new_tasks[k] for k in bucket}
        j.allocated = self.allocated.clone()
        j.total_request = self.total_request.clone()
        j.pending_request = self.pending_request.clone()
        return j

    def __repr__(self) -> str:
        return (f"JobInfo({self.uid} queue={self.queue} min={self.min_available} "
                f"tasks={len(self.tasks)} ready={self.ready_task_num})")
