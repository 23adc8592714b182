"""Test fakes (the reference's util/test_utils.go:94-163), mirroring
``kube_batch_tpu/cache/fake.py``: each records its effects, and the binder
and evictor set an ``event`` so a test can wait for an async bind."""

from __future__ import annotations

import threading
from typing import Dict, List

from kube_batch_tpu_torch.api.pod import Pod


class FakeBinder:
    def __init__(self):
        self.binds: Dict[str, str] = {}  # "ns/name" → node
        self.channel: List[str] = []
        self.event = threading.Event()  # set on every bind

    def bind(self, pod: Pod, hostname: str) -> None:
        key = f"{pod.namespace}/{pod.name}"
        self.binds[key] = hostname
        self.channel.append(key)
        if not self.event.is_set():  # set() takes a lock: skip when already up
            self.event.set()

    def bind_many(self, pairs) -> None:
        """Batch bind, all-or-nothing (see ``cache/interface.Binder``)."""
        keys = [f"{pod.namespace}/{pod.name}" for pod, _ in pairs]
        self.binds.update(zip(keys, (h for _, h in pairs)))
        self.channel.extend(keys)
        if not self.event.is_set():
            self.event.set()


class FakeEvictor:
    def __init__(self):
        self.evicts: List[str] = []  # "ns/name", in eviction order
        self.event = threading.Event()

    def evict(self, pod: Pod) -> None:
        self.evicts.append(f"{pod.namespace}/{pod.name}")
        self.event.set()


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
