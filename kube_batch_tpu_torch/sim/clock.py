"""Virtual time for the cluster simulator.

Two pieces: a `VirtualClock` the runner (and the L1 `Scheduler`, via its
injected-clock seam) reads, and an `EventHeap` — a time-ordered heap of
pending `SimEvent`s built on `utils/priority_queue.PriorityQueue`, whose
stable insertion-order tie-break is exactly what trace determinism needs:
two events scheduled for the same instant always pop in scheduling order.

Virtual seconds have no relation to wall time: a 500-cycle day replays in
however long the 500 scheduling cycles take to compute.

Mirrors ``kube_batch_tpu/sim/clock.py``.
"""

from __future__ import annotations

from typing import List, Optional

from kube_batch_tpu_torch.sim.events import SimEvent
from kube_batch_tpu_torch.utils.priority_queue import PriorityQueue


class VirtualClock:
    """Monotone virtual time. `monotonic()`/`sleep()` match the subset of
    the `time` module the Scheduler's clock seam uses, so a Scheduler
    constructed with this clock paces its loop in simulated seconds."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def monotonic(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._now += seconds

    def advance_to(self, t: float) -> None:
        if t > self._now:
            self._now = t


class EventHeap:
    """Pending simulator events ordered by (virtual time, insertion order)."""

    def __init__(self):
        self._pq = PriorityQueue(less=lambda a, b: a.time < b.time)

    def push(self, event: SimEvent) -> None:
        self._pq.push(event)

    def push_all(self, events) -> None:
        for ev in events:
            self.push(ev)

    def next_time(self) -> Optional[float]:
        return None if self._pq.empty() else self._pq.peek().time

    def pop_due(self, now: float) -> List[SimEvent]:
        """All events with time <= now, in deterministic order."""
        due: List[SimEvent] = []
        while not self._pq.empty() and self._pq.peek().time <= now:
            due.append(self._pq.pop())
        return due

    def __len__(self) -> int:
        return len(self._pq)

    def __bool__(self) -> bool:
        return bool(self._pq)
