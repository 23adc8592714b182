"""drf plugin (plugins/drf/drf.go) — dominant-resource fairness per job.

Mirrors ``kube_batch_tpu/plugins/drf.py``: registers
Preemptable (the preemptor's share after allocation must stay at or below
the victim job's share after eviction), JobOrder (lower share first), and
event handlers keeping each job's allocated resources current through the
session (drf.go:135-154).  The device solve orders jobs by the same shares
(ops/ordering.py).  A column session seeds the shares from one copy of
the job ledger matrix; an isolated session from each job's ledger.
"""

from __future__ import annotations

from typing import Dict, List

from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.resources import Resource
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.framework import session as fw
from kube_batch_tpu_torch.framework.interface import Plugin

SHARE_DELTA = 1e-6  # drf.go:33


class _JobAttr:
    __slots__ = ("allocated", "_share", "_dirty", "_gen")

    def __init__(self, allocated: Resource):
        self.allocated = allocated
        self._share = 0.0
        self._dirty = True
        self._gen = 0


class DrfPlugin(Plugin):
    name = "drf"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.total: Resource | None = None
        self.job_attrs: Dict[str, _JobAttr] = {}
        # per-job-row allocated matrix the attrs' Resources are views of;
        # _generation invalidates every cached share after a vectorized update
        self._arr = None
        self._generation = 0

    def _share(self, attr: _JobAttr) -> float:
        # recomputed lazily on read: nothing reads a share during the
        # allocate replay
        if attr._dirty or attr._gen != self._generation:
            attr._share = attr.allocated.share(self.total)
            attr._dirty = False
            attr._gen = self._generation
        return attr._share

    def on_session_open(self, ssn: fw.Session) -> None:
        self.total = ssn.total_allocatable().clone()
        cols = ssn.columns
        if cols is not None:
            # one matrix copy seeds every job's allocated state; attrs are
            # built lazily on first read, wrapping rows zero-copy
            self._arr = cols.j_alloc.copy()
        else:
            # an isolated session: job.allocated IS the allocated tasks' sum
            for job in ssn.jobs.values():
                self.job_attrs[job.uid] = _JobAttr(job.allocated.clone())
        wrap = ssn.spec.wrap_vec

        def attr_for(uid: str):
            attr = self.job_attrs.get(uid)
            if attr is None and self._arr is not None:
                job = ssn.jobs.get(uid)
                if job is not None and job._row >= 0:
                    attr = self.job_attrs[uid] = _JobAttr(wrap(self._arr[job._row]))
            return attr

        def preemptable(preemptor: TaskInfo, preemptees: List[TaskInfo]) -> List[TaskInfo]:
            """(drf.go:85-110)"""
            lattr = attr_for(preemptor.job)
            if lattr is None:
                return []
            ls = lattr.allocated.add(preemptor.resreq).share(self.total)
            allocations: Dict[str, Resource] = {}
            victims: List[TaskInfo] = []
            for ee in preemptees:
                rattr = attr_for(ee.job)
                if rattr is None:
                    continue
                if ee.job not in allocations:
                    allocations[ee.job] = rattr.allocated.clone()
                ralloc = allocations[ee.job]
                if not ee.resreq.less_equal(ralloc):
                    continue
                ralloc.sub_(ee.resreq)
                rs = ralloc.share(self.total)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(ee)
            return victims

        def job_order(l: JobInfo, r: JobInfo) -> int:
            """(drf.go:114-132) lower dominant share first."""
            la, ra = attr_for(l.uid), attr_for(r.uid)
            ls = self._share(la) if la is not None else 0.0
            rs = self._share(ra) if ra is not None else 0.0
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        def on_allocate(event: fw.Event) -> None:
            attr = attr_for(event.task.job)
            if attr is not None:
                attr.allocated.add_(event.task.resreq)
                attr._dirty = True

        def on_deallocate(event: fw.Event) -> None:
            attr = attr_for(event.task.job)
            if attr is not None:
                attr.allocated.sub_(event.task.resreq)
                attr._dirty = True

        def on_batch_allocate(job: JobInfo, tasks, total_resreq) -> None:
            # linear in resreq: one presummed add per job
            attr = attr_for(job.uid)
            if attr is not None:
                attr.allocated.add_(total_resreq)
                attr._dirty = True

        def on_columnar_allocate(cols, job_sums) -> None:
            # one matrix add for the whole replay
            self._arr += job_sums
            self._generation += 1

        ssn.add_fn(fw.PREEMPTABLE, self.name, preemptable)
        ssn.add_fn(fw.JOB_ORDER, self.name, job_order)
        ssn.add_event_handler(fw.EventHandler(
            allocate_func=on_allocate, deallocate_func=on_deallocate,
            batch_allocate_func=on_batch_allocate,
            columnar_allocate_func=(on_columnar_allocate
                                    if self._arr is not None else None)))

    def on_session_close(self, ssn: fw.Session) -> None:
        self.total = None
        self.job_attrs = {}
        self._arr = None
