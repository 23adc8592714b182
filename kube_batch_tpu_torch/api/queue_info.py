"""QueueInfo (the reference's queue_info.go:29-48): name, weight and the
Queue object, whose Capability caps the queue.  Mirrors
``kube_batch_tpu/api/queue_info.py``."""

from __future__ import annotations

from kube_batch_tpu_torch.api.pod import Queue


class QueueInfo:
    def __init__(self, queue: Queue):
        self.uid: str = queue.name
        self.name: str = queue.name
        self.weight: int = max(int(queue.weight), 1)
        self.queue: Queue = queue
        self._cols = None  # ColumnStore binding (api/columns.py)
        self._row: int = -1

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)

    def __repr__(self) -> str:
        return f"QueueInfo({self.name} weight={self.weight})"
