"""proportion plugin (plugins/proportion/proportion.go) — weighted max-min
fair queue capacity.

Mirrors ``kube_batch_tpu/plugins/proportion.py`` in its columnar form:
registers QueueOrder (lower share first), Reclaimable (the victim's queue
must stay at or above its deserved share), Overused, JobEnqueueable (the
capability cap), and event handlers keeping each queue's allocation
current.  The deserved waterfill is the host twin of
``ops/fairness.proportion_deserved``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.resources import Resource
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.framework import session as fw
from kube_batch_tpu_torch.framework.interface import Plugin


class _QueueAttr:
    __slots__ = ("queue", "weight", "deserved", "allocated", "request",
                 "_share", "_dirty", "_gen")

    def __init__(self, queue: QueueInfo, spec):
        self.queue = queue
        self.weight = queue.weight
        self.deserved = spec.empty()
        self.allocated = spec.empty()
        self.request = spec.empty()
        self._share = 0.0
        self._dirty = True
        self._gen = 0


class ProportionPlugin(Plugin):
    name = "proportion"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.total: Resource | None = None
        self.queue_attrs: Dict[str, _QueueAttr] = {}
        # [capQ, R] allocated matrix the attrs wrap, and the session's job
        # rows with their queue rows, for the vectorized allocate events
        self._qalloc = None
        self._jq_rows = None
        self._jq_vals = None
        self._generation = 0

    def _share(self, attr: _QueueAttr) -> float:
        """Dominant allocated/deserved (proportion.go:265-277), lazily."""
        if attr._dirty or attr._gen != self._generation:
            attr._share = attr.allocated.share(attr.deserved)
            attr._dirty = False
            attr._gen = self._generation
        return attr._share

    def on_session_open(self, ssn: fw.Session) -> None:
        spec = ssn.spec
        self.total = ssn.total_allocatable().clone()
        cols = ssn.columns
        if cols is not None and ssn.rows_synced:
            # queue attrs are one segment sum over the job ledger matrices
            # of the synced session rows (proportion.go:67-99)
            rows = np.flatnonzero(cols.j_sess)
            qrows = cols.j_queue[rows]
            capQ = cols.queues.cap
            alloc_m = np.zeros((capQ, spec.n))
            request_m = np.zeros((capQ, spec.n))
            np.add.at(alloc_m, qrows, cols.j_alloc[rows])
            np.add.at(request_m, qrows, cols.j_alloc[rows] + cols.j_pend[rows])
            self._qalloc, self._jq_rows, self._jq_vals = alloc_m, rows, qrows
            wrap = spec.wrap_vec
            for qi in np.unique(qrows).tolist():
                qinfo = ssn.queues.get(cols.queue_names[qi])
                if qinfo is None:
                    continue
                attr = _QueueAttr(qinfo, spec)
                attr.allocated = wrap(alloc_m[qi])
                attr.request = wrap(request_m[qi])
                self.queue_attrs[qinfo.name] = attr
        else:
            # an isolated session: queue attrs from the session's jobs,
            # request = allocated + pending off each job's ledgers
            for job in ssn.jobs.values():
                if job.queue not in ssn.queues:
                    continue
                attr = self.queue_attrs.get(job.queue)
                if attr is None:
                    attr = self.queue_attrs[job.queue] = _QueueAttr(
                        ssn.queues[job.queue], spec)
                attr.allocated.add_(job.allocated)
                attr.request.add_(job.allocated)
                attr.request.add_(job.pending_request)
        self._waterfill(spec)

        def queue_order(l: QueueInfo, r: QueueInfo) -> int:
            la, ra = self.queue_attrs.get(l.name), self.queue_attrs.get(r.name)
            ls = self._share(la) if la else 0.0
            rs = self._share(ra) if ra else 0.0
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        def reclaimable(reclaimer: TaskInfo, reclaimees: List[TaskInfo]) -> List[TaskInfo]:
            """(proportion.go:171-196) victim OK if its queue stays at or
            above deserved."""
            victims: List[TaskInfo] = []
            allocations: Dict[str, Resource] = {}
            for ee in reclaimees:
                job = ssn.jobs.get(ee.job)
                if job is None or job.queue not in self.queue_attrs:
                    continue
                attr = self.queue_attrs[job.queue]
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                alloc = allocations[job.queue]
                if not ee.resreq.less_equal(alloc):
                    continue
                alloc.sub_(ee.resreq)
                if attr.deserved.less_equal_semantic(alloc):
                    victims.append(ee)
            return victims

        def overused_fn(queue: QueueInfo) -> bool:
            attr = self.queue_attrs.get(queue.name)
            if attr is None:
                return False
            return attr.deserved.less_equal_semantic(attr.allocated)

        def job_enqueueable(job: JobInfo) -> bool:
            """(proportion.go:211-233) capability quota not exceeded."""
            queue = ssn.queues.get(job.queue)
            attr = self.queue_attrs.get(job.queue)
            if queue is None or attr is None:
                return True
            capability = queue.queue.capability
            if not capability:
                return True
            cap = spec.empty()
            for name, v in capability.items():
                if name in spec:
                    cap.vec[spec.index(name)] = float(v)
            min_res = spec.empty()
            for name, v in (job.pod_group.min_resources or {}).items():
                if name in spec:
                    min_res.vec[spec.index(name)] = float(v)
            return min_res.add(attr.allocated).less_equal(cap)

        def on_allocate(event: fw.Event) -> None:
            job = ssn.jobs.get(event.task.job)
            if job and job.queue in self.queue_attrs:
                attr = self.queue_attrs[job.queue]
                attr.allocated.add_(event.task.resreq)
                attr._dirty = True

        def on_deallocate(event: fw.Event) -> None:
            job = ssn.jobs.get(event.task.job)
            if job and job.queue in self.queue_attrs:
                attr = self.queue_attrs[job.queue]
                attr.allocated.sub_(event.task.resreq)
                attr._dirty = True

        def on_batch_allocate(job: JobInfo, tasks, total_resreq) -> None:
            # linear in resreq: one presummed add per job
            if job.queue in self.queue_attrs:
                attr = self.queue_attrs[job.queue]
                attr.allocated.add_(total_resreq)
                attr._dirty = True

        def on_columnar_allocate(cols, job_sums) -> None:
            # one segment sum for the whole replay
            np.add.at(self._qalloc, self._jq_vals, job_sums[self._jq_rows])
            self._generation += 1

        ssn.add_fn(fw.QUEUE_ORDER, self.name, queue_order)
        ssn.add_fn(fw.RECLAIMABLE, self.name, reclaimable)
        ssn.add_fn(fw.OVERUSED, self.name, overused_fn)
        ssn.add_fn(fw.JOB_ENQUEUEABLE, self.name, job_enqueueable)
        ssn.add_event_handler(fw.EventHandler(
            allocate_func=on_allocate, deallocate_func=on_deallocate,
            batch_allocate_func=on_batch_allocate,
            columnar_allocate_func=(on_columnar_allocate
                                    if self._qalloc is not None else None)))

    def _waterfill(self, spec) -> None:
        """Deserved by weighted max-min (proportion.go:101-154)."""
        attrs = list(self.queue_attrs.values())
        if not attrs:
            return
        remaining = self.total.vec.copy()
        met = [False] * len(attrs)
        for _ in range(max(len(attrs) * 2, 16)):
            if not np.any(remaining > 1e-6) or all(met):
                break
            weights = np.array([a.weight if not m else 0.0 for a, m in zip(attrs, met)])
            tw = weights.sum()
            if tw <= 0:
                break
            for i, attr in enumerate(attrs):
                if met[i]:
                    continue
                new = attr.deserved.vec + remaining * (weights[i] / tw)
                if np.all(attr.request.vec <= new + 1e-6):
                    new = np.minimum(new, attr.request.vec)
                    met[i] = True
                attr.deserved = spec.from_vec(new)
            granted = sum(a.deserved.vec for a in attrs)
            remaining = np.maximum(self.total.vec - granted, 0.0)

    def on_session_close(self, ssn: fw.Session) -> None:
        self.total = None
        self.queue_attrs = {}
        self._qalloc = self._jq_rows = self._jq_vals = None
