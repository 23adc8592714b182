"""TaskInfo — the scheduler's view of one pod.

Mirrors ``kube_batch_tpu/api/task_info.py`` (the reference's
job_info.go:36-124): UID, owning job, Resreq (sum of container requests),
InitResreq (max of that sum with each init container, pod_info.go:53-73),
NodeName, Status, Priority and the ingested Pod.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Set, Tuple

from kube_batch_tpu_torch.api.pod import Pod
from kube_batch_tpu_torch.api.resources import PODS, Resource, ResourceSpec
from kube_batch_tpu_torch.api.types import TaskStatus, pod_phase_to_status

logger = logging.getLogger("kube_batch_tpu_torch")
_warned_unknown_scalars: Set[Tuple[Tuple[str, ...], str]] = set()


def job_id_for_pod(pod: Pod) -> str:
    """JobID for a pod (job_info.go:56-66): namespace/group-name when the
    group annotation is set; else the pod's controller UID
    (cache/util.go:42-46); else the pod's own namespace/name (a shadow
    single-task job is synthesized)."""
    group = pod.group_name
    if group:
        return f"{pod.namespace}/{group}"
    if pod.owner:
        return f"{pod.namespace}/{pod.owner}"
    return f"{pod.namespace}/{pod.name}"


def _requests_to_resource(requests: Dict[str, float], spec: ResourceSpec) -> Resource:
    vec = spec.empty()
    for name, v in requests.items():
        if name in spec:
            vec.vec[spec.index(name)] = float(v)
        else:
            # the axis is fixed at cache construction: an unmodelled scalar
            # cannot gate placement — warn once per (spec, name)
            key = (spec.names, name)
            if key not in _warned_unknown_scalars:
                _warned_unknown_scalars.add(key)
                logger.warning("dropping request for resource %r not in "
                               "cluster ResourceSpec %s", name, spec.names)
    vec.vec[spec.index(PODS)] = 1.0  # every task occupies one pod slot
    return vec


class TaskInfo:
    __slots__ = ("uid", "job", "name", "namespace", "resreq", "init_resreq",
                 "_node_name", "_status", "priority", "volume_ready", "pod",
                 "_key", "_row", "_store")

    def __init__(self, pod: Pod, spec: ResourceSpec):
        # column binding first: the status/node_name setters mirror into the
        # cache's ColumnStore once bound (api/columns.py)
        self._row: int = -1
        self._store = None
        self.uid: str = pod.uid
        self.job: str = job_id_for_pod(pod)
        self.name: str = pod.name
        self.namespace: str = pod.namespace
        self.resreq: Resource = _requests_to_resource(pod.requests, spec)
        # InitResreq = max(Resreq, each init container); without init
        # containers it IS Resreq (requests are frozen at ingest)
        if pod.init_requests:
            self.init_resreq: Resource = self.resreq.clone()
            self.init_resreq.set_max_(_requests_to_resource(pod.init_requests, spec))
        else:
            self.init_resreq = self.resreq
        self._node_name: Optional[str] = pod.node_name
        self._status: TaskStatus = pod_phase_to_status(pod.phase, pod.node_name,
                                                       pod.deleting)
        self.priority: int = pod.priority
        self.volume_ready: bool = False
        self.pod: Pod = pod
        self._key: str = f"{pod.namespace}/{pod.name}"

    # ---- column-mirrored mutable state ----------------------------------
    # every write of status / node_name goes through these setters, which
    # keep the ColumnStore's t_status / t_node columns current
    @property
    def status(self) -> TaskStatus:
        return self._status

    @status.setter
    def status(self, value: TaskStatus) -> None:
        self._status = value
        store = self._store
        if store is not None:
            store.t_status[self._row] = int(value)

    @property
    def node_name(self) -> Optional[str]:
        return self._node_name

    @node_name.setter
    def node_name(self, value: Optional[str]) -> None:
        self._node_name = value
        store = self._store
        if store is not None:
            store.task_node_changed(self._row, value)

    @property
    def best_effort(self) -> bool:
        """BestEffort = empty InitResreq — skipped by allocate
        (allocate.go:126-129)."""
        return self.init_resreq.is_empty()

    @property
    def needs_host_predicate(self) -> bool:
        """True when the task carries constraints the device mask only
        approximates: host ports, inter-pod (anti-)affinity, or node-affinity
        terms richer than one single-value In term.  The allocate replay
        re-validates only these."""
        pod = self.pod
        if pod.host_ports:
            return True
        aff = pod.affinity
        if aff is None:
            return False
        if aff.pod_affinity or aff.pod_anti_affinity:
            return True
        terms = aff.node_terms
        if not terms:
            return False
        if len(terms) > 1:
            return True
        return any(op != "In" or len(values) != 1 for (_, op, values) in terms[0])

    def clone(self) -> "TaskInfo":
        """A copy with its own status and node_name.  The request vectors
        are shared: they are frozen at ingest, and every ledger change
        happens on the job and node ledgers."""
        t = TaskInfo.__new__(TaskInfo)
        t._row = -1       # clones are never column-bound (isolated sessions)
        t._store = None
        t.uid = self.uid
        t.job = self.job
        t.name = self.name
        t.namespace = self.namespace
        t.resreq = self.resreq
        t.init_resreq = self.init_resreq
        t._node_name = self._node_name
        t._status = self._status
        t.priority = self.priority
        t.volume_ready = self.volume_ready
        t.pod = self.pod
        t._key = self._key
        return t

    def key(self) -> str:
        return self._key

    def __repr__(self) -> str:
        return (f"TaskInfo({self.namespace}/{self.name} job={self.job} "
                f"status={self.status.name} node={self.node_name} req={self.resreq})")
