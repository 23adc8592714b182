"""Test fakes (the reference's util/test_utils.go:94-163), mirroring
``kube_batch_tpu/cache/fake.py``: each records its effects."""

from __future__ import annotations

from typing import Dict, List

from kube_batch_tpu_torch.api.pod import Pod


class FakeBinder:
    def __init__(self):
        self.binds: Dict[str, str] = {}  # "ns/name" → node
        self.channel: List[str] = []

    def bind(self, pod: Pod, hostname: str) -> None:
        key = f"{pod.namespace}/{pod.name}"
        self.binds[key] = hostname
        self.channel.append(key)

    def bind_many(self, pairs) -> None:
        """Batch bind, all-or-nothing (see ``cache/interface.Binder``)."""
        keys = [f"{pod.namespace}/{pod.name}" for pod, _ in pairs]
        self.binds.update(zip(keys, (h for _, h in pairs)))
        self.channel.extend(keys)


class FakeStatusUpdater:
    def __init__(self):
        self.pod_conditions: List[tuple] = []
        self.pod_groups: List[object] = []
        self.queue_statuses: dict = {}  # queue name → last written counts

    def update_pod_condition(self, pod, condition) -> None:
        self.pod_conditions.append((f"{pod.namespace}/{pod.name}", condition))

    def update_pod_group(self, pod_group) -> None:
        self.pod_groups.append(pod_group)

    def update_queue_status(self, name: str, counts: dict) -> None:
        self.queue_statuses[name] = dict(counts)


class FakeVolumeBinder:
    # lets the allocate replay skip the per-task volume calls wholesale
    noop = True

    def allocate_volumes(self, task, hostname) -> None:
        pass

    def bind_volumes(self, task) -> None:
        pass
