"""gang plugin (plugins/gang/gang.go) — gang-integrity policy.

Mirrors ``kube_batch_tpu/plugins/gang.py``.  Registers JobValid (minMember
check), Preemptable/Reclaimable (never shrink a gang below minAvailable),
JobOrder (starved gangs first), JobReady and JobPipelined; on close it
writes Unschedulable conditions and fit errors for still-unready jobs
(gang.go:132-175), and counts a job still unschedulable since an earlier
session in ``volcano_job_retry_counts``.  The device solve enforces the
same commit gate; this host plugin is authoritative for the session
bookkeeping.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.api.columns import READY_STATUSES
from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.pod import PodGroupCondition
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.framework import session as fw
from kube_batch_tpu_torch.framework.interface import Plugin


class GangPlugin(Plugin):
    name = "gang"

    def on_session_open(self, ssn: fw.Session) -> None:
        def job_valid(job: JobInfo):
            """(gang.go:48-69) valid iff enough potentially-runnable tasks."""
            valid = job.valid_task_num
            if valid < job.min_available:
                return (f"Not enough valid tasks for gang-scheduling, "
                        f"valid: {valid}, min: {job.min_available}")
            return None

        def evictable(evictor: TaskInfo, evictees: List[TaskInfo]) -> List[TaskInfo]:
            """(gang.go:71-94) a task is a victim only if its job stays at or
            above minAvailable after the victims so far; jobs with
            MinAvailable <= 1 are not gangs and always evictable."""
            victims: List[TaskInfo] = []
            occupied: Dict[str, int] = {}
            for ee in evictees:
                job = ssn.jobs.get(ee.job)
                if job is None:
                    continue
                if job.min_available <= 1:
                    victims.append(ee)
                    continue
                if job.uid not in occupied:
                    occupied[job.uid] = job.ready_task_num
                if occupied[job.uid] > job.min_available:
                    occupied[job.uid] -= 1
                    victims.append(ee)
            return victims

        def job_order(l: JobInfo, r: JobInfo) -> int:
            """(gang.go:96-121) starved (not ready) gangs first."""
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready == r_ready:
                return 0
            return 1 if l_ready else -1

        ssn.add_fn(fw.JOB_VALID, self.name, job_valid)
        ssn.add_fn(fw.PREEMPTABLE, self.name, evictable)
        ssn.add_fn(fw.RECLAIMABLE, self.name, evictable)
        ssn.add_fn(fw.JOB_ORDER, self.name, job_order)
        ssn.add_fn(fw.JOB_READY, self.name, lambda job: job.ready())
        ssn.add_fn(fw.JOB_PIPELINED, self.name, lambda job: job.pipelined())

    def on_session_close(self, ssn: fw.Session) -> None:
        """(gang.go:132-175) mark still-unready jobs Unschedulable.  In a
        column session one counts-matrix expression finds the (normally
        sparse) unready set."""
        if not ssn.jobs:
            return
        cols = ssn.columns
        if cols is not None and ssn.rows_synced:
            rows, jobs_list = ssn.session_rows()
            counts = cols.j_counts[rows]
            ready = counts[:, READY_STATUSES].sum(axis=1) >= cols.j_min[rows]
            has_tasks = counts.sum(axis=1) > 0
            candidates = [jobs_list[i] for i in np.flatnonzero(~ready & has_tasks)]
        else:
            candidates = [job for job in ssn.jobs.values()
                          if not job.ready() and job.tasks]
        for job in candidates:
            # still unschedulable with an Unschedulable condition from an
            # earlier session: a retry of a failed job (job_retry_counts,
            # metrics.go:113-121, declared but never written there)
            if job.pod_group is not None and any(
                    c.type == "Unschedulable" and c.status == "True"
                    and c.transition_id != ssn.uid
                    for c in job.pod_group.conditions):
                metrics.register_job_retry(job.uid)
            fit_errors = [fe.error() for fe in job.nodes_fit_errors.values()]
            message = job.fit_error() + (f"; {fit_errors[0]}" if fit_errors else "")
            job.job_fit_errors = message  # read by record_job_status_event
            ssn.note_fit_state(job)
            ssn.update_job_condition(job, PodGroupCondition(
                type="Unschedulable",
                status="True",
                transition_id=ssn.uid,
                reason="NotEnoughResources",
                message=message,
            ))
