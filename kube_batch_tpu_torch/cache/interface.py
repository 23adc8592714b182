"""Cache side-effect seams (cache/interface.go:27-78), mirroring
``kube_batch_tpu/cache/interface.py``.

These are the process boundary: everything above them is in-memory
scheduling state; implementations talk to whatever runs pods (an apiserver
adapter, a synthetic backend, or the test fakes in ``cache/fake.py``)."""

from __future__ import annotations

from typing import Protocol

from kube_batch_tpu_torch.api.pod import Pod


class Binder(Protocol):
    """A binder MAY also expose ``bind_many(pairs)``, a batch path the
    cache prefers when present.  Its contract is all-or-nothing: raising
    must mean no pod of the batch was bound, because the cache then retries
    the batch pod by pod through ``bind``."""

    def bind(self, pod: Pod, hostname: str) -> None:
        """Place the pod; raise to signal failure."""


class Evictor(Protocol):
    def evict(self, pod: Pod) -> None:
        """Delete or evict the pod; raise to signal failure."""


class StatusUpdater(Protocol):
    def update_pod_condition(self, pod: Pod, condition: dict) -> None: ...

    def update_pod_group(self, pod_group) -> None: ...


class VolumeBinder(Protocol):
    """Scheduling-side volume seam (AllocateVolumes / BindVolumes).  A
    binder whose ``noop`` attribute is true lets the allocate replay skip
    the per-task volume calls."""

    def allocate_volumes(self, task, hostname: str) -> None: ...

    def bind_volumes(self, task) -> None: ...
