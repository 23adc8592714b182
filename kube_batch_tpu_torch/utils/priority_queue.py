"""A priority queue ordered by a caller's ``less`` function.

Mirrors ``kube_batch_tpu/utils/priority_queue.py`` (the reference's
pkg/scheduler/util/priority_queue.go:26-94, a container/heap over an
api.LessFn).  The enqueue walk orders queues and jobs with it, and preempt
orders its victims.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, Iterable


class PriorityQueue:
    """Heap ordered by ``less(a, b)`` (True: ``a`` pops before ``b``);
    ties break by insertion order."""

    def __init__(self, less: Callable[[Any, Any], bool], items: Iterable[Any] = ()):
        self._less = less
        self._counter = itertools.count()
        self._heap: list = []
        for it in items:
            self.push(it)

    def push(self, item: Any) -> None:
        heapq.heappush(self._heap, _Entry(item, next(self._counter), self._less))

    def pop(self) -> Any:
        return heapq.heappop(self._heap).item

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class _Entry:
    __slots__ = ("item", "seq", "less")

    def __init__(self, item: Any, seq: int, less: Callable[[Any, Any], bool]):
        self.item = item
        self.seq = seq
        self.less = less

    def __lt__(self, other: "_Entry") -> bool:
        if self.less(self.item, other.item):
            return True
        if self.less(other.item, self.item):
            return False
        return self.seq < other.seq
