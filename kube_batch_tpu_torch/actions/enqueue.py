"""enqueue action (actions/enqueue/enqueue.go) — the Inqueue gatekeeper.

Mirrors ``kube_batch_tpu/actions/enqueue.py``.  Cluster idle is
Σ allocatable × 1.2 − used (20 % overcommit, enqueue.go:78-81); Pending
PodGroups are admitted in queue, then job, order: one without MinResources
turns Inqueue at once; one with MinResources needs JobEnqueueable
(proportion's capability check) and MinResources ≤ idle, which it then
deducts (enqueue.go:102-117).

The columnar path decides with no per-job Python loop: candidates come off
the job-row columns, the capability check and the ordering keys are
vectorized over them, and the sequential admission is the gate of
``ops/admission.py`` (the CUDA kernel on the card) with one readback of the
admitted mask; only promoted jobs touch Python objects.  The session's
queue order is a strict total order (plugin verdicts fall back to the
queue name), so the reference's pop-process-push heap walk drains one
queue fully before the next: the gate sorts the few queues once and
concatenates each queue's candidates in tiered job order, derived per
voter for priority, gang and drf.  Any other JOB_ORDER or JOB_ENQUEUEABLE
voter takes the object walk (``_walk_decisions``), which is also the
oracle the tests hold the columnar path against.

Not ported: the guard's gate sentinel and sampled shadow audit, tracing,
and the mesh dispatch of the gate.
"""

from __future__ import annotations

from functools import cmp_to_key

import numpy as np
import torch

from kube_batch_tpu_torch.api.columns import PHASE_CODE, READY_STATUSES
from kube_batch_tpu_torch.api.types import PodGroupPhase
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import JOB_ENQUEUEABLE, JOB_ORDER
from kube_batch_tpu_torch.ops.admission import enqueue_gate
from kube_batch_tpu_torch.utils.priority_queue import PriorityQueue

OVERCOMMIT_FACTOR = 1.2

#: JOB_ORDER voters the columnar gate derives keys for
_COLUMNAR_JOB_ORDER = {"priority", "gang", "drf"}


class EnqueueAction(Action):
    name = "enqueue"

    def __init__(self):
        # the path the last execute() took: "columnar" or "walk"
        self.last_path = "walk"
        # candidates the last columnar gate walked (0: no gate ran)
        self.last_gate_rows = 0

    def execute(self, ssn) -> None:
        self.last_gate_rows = 0
        if (ssn.rows_synced
                and ssn.enabled_plugin_names(JOB_ENQUEUEABLE) <= {"proportion"}
                and ssn.enabled_plugin_names(JOB_ORDER) <= _COLUMNAR_JOB_ORDER):
            self.last_path = "columnar"
            if self._execute_columnar(ssn, ssn.columns):
                return
        self.last_path = "walk"
        for job in self._walk_decisions(ssn):
            self._promote(ssn.columns, job)

    # ------------------------------------------------------------------
    @staticmethod
    def _promote(cols, job) -> None:
        """Pending → Inqueue, written through to the job-row columns: the
        snapshot's schedulability row was synced at session open, so this
        cycle's allocate would otherwise still skip the job."""
        job.pod_group.phase = PodGroupPhase.INQUEUE
        if job._cols is cols and job._row >= 0:
            cols.j_sched[job._row] = True
            cols.j_phase[job._row] = PHASE_CODE[PodGroupPhase.INQUEUE]

    def _promote_rows(self, cols, rows) -> None:
        job_by_row = cols.job_by_row
        for r in rows:
            self._promote(cols, job_by_row[r])

    # ------------------------------------------------------------------
    def _execute_columnar(self, ssn, cols) -> bool:
        """The column gate; False when an exactness guard trips (the caller
        then runs the object walk).  Promotions are applied at the end, so
        a False return leaves the walk an unmutated session."""
        spec = ssn.spec
        cand = cols.j_sess & ~cols.j_sched & cols.j_has_pg
        if not cand.any():
            return True
        # the walk skips jobs whose queue left the session's queue dict
        qok = np.zeros(cols.queues.cap, bool)
        for name, qi in cols.queue_rows.items():
            if name in ssn.queues:
                qok[qi] = True
        cand &= qok[cols.j_queue]
        if not cand.any():
            return True
        job_by_row = cols.job_by_row
        # unconditional promotions (enqueue.go:102-105): a job that consumes
        # no budget is admitted whatever the order
        uncond_rows = np.flatnonzero(cand & ~cols.j_has_minres).tolist()
        minres_rows = np.flatnonzero(cand & cols.j_has_minres)
        if minres_rows.size == 0:
            self._promote_rows(cols, uncond_rows)
            return True

        # idle = Σ allocatable × 1.2 − used (enqueue.go:74-81) over the
        # session's nodes, which are exactly the Ready rows
        if int(cols.n_valid.sum()) != len(ssn.nodes):
            return False
        nv = cols.n_valid
        if nv.any():
            total = spec.from_vec(cols.n_alloc[nv].sum(axis=0))
            used = spec.from_vec(cols.n_used[nv].sum(axis=0))
        else:
            total, used = spec.empty(), spec.empty()
        idle = total.multi(OVERCOMMIT_FACTOR)
        if used.less_equal(idle):
            idle.sub_(used)
        else:
            idle = spec.empty()

        # JobEnqueueable (proportion.go:211-233): MinResources plus the
        # queue's live allocation within its capability, per queue over the
        # candidate rows, read off the proportion plugin's own queue attrs
        enq_ok = np.ones(minres_rows.size, bool)
        qrows_of = cols.j_queue[minres_rows]
        if "proportion" in ssn.enabled_plugin_names(JOB_ENQUEUEABLE):
            prop = next(p for p in ssn.plugins if p.name == "proportion")
            minr64 = cols.j_minres[minres_rows].astype(np.float64)
            for qi in np.unique(qrows_of).tolist():
                qinfo = ssn.queues.get(cols.queue_names[qi])
                attr = prop.queue_attrs.get(cols.queue_names[qi])
                # a missing queue or attr, or no capability: enqueueable
                if qinfo is None or attr is None or not qinfo.queue.capability:
                    continue
                capv = np.zeros(spec.n)
                for name, v in qinfo.queue.capability.items():
                    if name in spec:
                        capv[spec.index(name)] = float(v)
                sel = qrows_of == qi
                need = minr64[sel] + attr.allocated.vec
                ok = np.all((need <= capv) | (need - capv < spec.quanta), axis=1)
                enq_ok[np.flatnonzero(sel)[~ok]] = False

        # admission order: queues drained in tiered queue order, jobs within
        # a queue by the tiered job-order keys
        qset = sorted({int(qi) for qi in np.unique(qrows_of)})
        queue_objs = [ssn.queues[cols.queue_names[qi]] for qi in qset]
        queue_objs.sort(key=cmp_to_key(
            lambda a, b: -1 if ssn.queue_order_fn(a, b) else 1))
        rank_by_qi = np.zeros(cols.queues.cap, np.int32)
        for pos, q in enumerate(queue_objs):
            rank_by_qi[cols.queue_rows[q.name]] = pos
        keys = []
        for name in ssn.ordered_enabled_plugins(JOB_ORDER):
            if name == "priority":
                keys.append(-cols.j_prio[minres_rows])
            elif name == "gang":
                # starved (not ready) gangs first (gang.go:96-121)
                ready = (cols.j_counts[minres_rows][:, READY_STATUSES].sum(axis=1)
                         >= cols.j_min[minres_rows])
                keys.append(ready.astype(np.int8))
            else:  # drf: lower dominant share first (drf.go:114-132)
                m = spec.semantic_mask
                t = ssn.total_allocatable().vec[m]
                alloc = cols.j_alloc[minres_rows][:, m]
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratios = np.where(t > 0, alloc / t, 0.0)
                keys.append(ratios.max(axis=1) if ratios.shape[1]
                            else np.zeros(minres_rows.size))
        creation = cols.j_creation[minres_rows]
        sort_keys = []
        if np.unique(creation).size != creation.size:
            # creation ties fall back to the uid (job_order_fn's last key)
            sort_keys.append(np.array([job_by_row[r].uid for r in minres_rows.tolist()]))
        sort_keys.append(creation)
        sort_keys.extend(reversed(keys))
        sort_keys.append(rank_by_qi[qrows_of])
        order = np.lexsort(tuple(sort_keys))
        ordered = minres_rows[order]

        # the gate at the padded job capacity, walked up to k rows, with
        # one readback of the admitted mask
        capJ, k = cols.jobs.cap, ordered.size
        minr = np.zeros((capJ, spec.n), np.float32)
        minr[:k] = cols.j_minres[ordered]
        candv = np.zeros(capJ, bool)
        candv[:k] = enq_ok[order]
        dev = ssn.device
        admitted = enqueue_gate(
            torch.from_numpy(minr).to(dev), torch.from_numpy(candv).to(dev),
            torch.from_numpy(idle.vec.astype(np.float32)).to(dev),
            torch.from_numpy(spec.quanta.astype(np.float32)).to(dev),
            n_rows=k,
        ).cpu().numpy()[:k]
        self.last_gate_rows = k
        self._promote_rows(cols, uncond_rows + ordered[admitted].tolist())
        return True

    # ------------------------------------------------------------------
    def _walk_decisions(self, ssn) -> list:
        """The reference walk's admissions (enqueue.go:74-117), in walk
        order, without mutating anything."""
        decisions = []
        queues = PriorityQueue(less=ssn.queue_order_fn)
        queue_set = set()
        jobs_map = {}
        any_min_res = False
        for job in ssn.jobs.values():
            if job.queue not in ssn.queues:
                continue
            if job.pod_group is None or job.pod_group.phase != PodGroupPhase.PENDING:
                continue
            if job.pod_group.min_resources is None:
                # no budget consumed: the order is unobservable
                decisions.append(job)
                continue
            any_min_res = True
            queue = ssn.queues[job.queue]
            if queue.name not in queue_set:
                queue_set.add(queue.name)
                queues.push(queue)
            jobs_map.setdefault(queue.name, PriorityQueue(less=ssn.job_order_fn)).push(job)
        if not any_min_res:
            return decisions

        total = ssn.spec.empty()
        used = ssn.spec.empty()
        for node in ssn.nodes.values():
            total.add_(node.allocatable)
            used.add_(node.used)
        idle = total.multi(OVERCOMMIT_FACTOR)
        if used.less_equal(idle):
            idle.sub_(used)
        else:
            idle = ssn.spec.empty()

        while queues:
            queue = queues.pop()
            jobs = jobs_map.get(queue.name)
            if not jobs:
                continue
            job = jobs.pop()
            min_req = ssn.spec.empty()
            for name, v in job.pod_group.min_resources.items():
                if name in ssn.spec:
                    min_req.vec[ssn.spec.index(name)] = float(v)
            if ssn.job_enqueueable(job) and min_req.less_equal(idle):
                decisions.append(job)
                idle.sub_(min_req)
            queues.push(queue)
        return decisions
