"""priority plugin (plugins/priority/priority.go:27-82): orders tasks by pod
priority and jobs by PodGroup PriorityClass value (resolved in the cache's
session view, cache.go:610-620).  Mirrors ``kube_batch_tpu/plugins/priority.py``."""

from __future__ import annotations

from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework import session as fw


class PriorityPlugin(Plugin):
    name = "priority"

    def on_session_open(self, ssn: fw.Session) -> None:
        def task_order(l: TaskInfo, r: TaskInfo) -> int:
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        def job_order(l: JobInfo, r: JobInfo) -> int:
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_fn(fw.TASK_ORDER, self.name, task_order)
        ssn.add_fn(fw.JOB_ORDER, self.name, job_order)
