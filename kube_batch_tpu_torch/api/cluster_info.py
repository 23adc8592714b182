"""ClusterInfo — the per-session view triple (cluster_info.go:22-26).
Mirrors ``kube_batch_tpu/api/cluster_info.py``."""

from __future__ import annotations

from typing import Dict

from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.resources import ResourceSpec


class ClusterInfo:
    def __init__(self, spec: ResourceSpec):
        self.spec = spec
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}

    def __repr__(self) -> str:
        return (f"ClusterInfo(jobs={len(self.jobs)}, nodes={len(self.nodes)}, "
                f"queues={len(self.queues)})")
