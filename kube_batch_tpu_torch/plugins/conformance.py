"""conformance plugin (plugins/conformance/conformance.go:42-59): never evict
critical pods — system-cluster-critical / system-node-critical priority
classes or anything in kube-system.  Mirrors
``kube_batch_tpu/plugins/conformance.py``; its hooks serve the evicting
actions."""

from __future__ import annotations

from typing import List

from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.api.types import CRITICAL_NAMESPACE, CRITICAL_PRIORITY_CLASSES
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework import session as fw


class ConformancePlugin(Plugin):
    name = "conformance"

    def on_session_open(self, ssn: fw.Session) -> None:
        def evictable(evictor: TaskInfo, evictees: List[TaskInfo]) -> List[TaskInfo]:
            victims = []
            for ee in evictees:
                if (
                    ee.pod.priority_class in CRITICAL_PRIORITY_CLASSES
                    or ee.namespace == CRITICAL_NAMESPACE
                ):
                    continue
                victims.append(ee)
            return victims

        ssn.add_fn(fw.PREEMPTABLE, self.name, evictable)
        ssn.add_fn(fw.RECLAIMABLE, self.name, evictable)
