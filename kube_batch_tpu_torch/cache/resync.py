"""Bounded resync/repair queue with per-task backoff and poison
quarantine, mirroring ``kube_batch_tpu/cache/resync.py``.

The reference repairs failed binds and evictions through a rate-limited
workqueue (cache.go:559-581 over client-go's default item backoff).  This
queue keeps that discipline, deterministically:

- Entries are keyed by task; the per-key attempt history SURVIVES a drain,
  so a task that keeps failing escalates its backoff across park cycles
  instead of restarting from attempt 1 each time.
- Backoff is counted in repair TICKS, not wall seconds: ``tick()`` is
  called once per repair pass, so the behaviour is the same whatever the
  clock.  A task parked for the n-th time waits
  ``min(2^(n-1), backoff_cap)`` ticks before its next repair.
- Parks whose reason is ``breaker-open`` (the egress breaker failing
  fast: the decision never reached the server) back off but do NOT count
  toward the poison budget.
- A task that accumulates ``poison_after`` REAL failures is quarantined:
  shelved out of the retry flow with a condition for the operator,
  holding its claimed state, until an external change to its pod
  (update or delete) releases it.
- The pending backlog is bounded: beyond ``max_entries`` the OLDEST
  backlog is forced due (bounded *delay*, never dropped repair work).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("kube_batch_tpu_torch")

#: park reasons
REASON_ERROR = "error"            # the bind/evict call actually failed
REASON_BREAKER = "breaker-open"   # egress failing fast; never attempted


class _Entry:
    __slots__ = ("task", "attempts", "real_failures", "due_tick", "reason",
                 "pending")

    def __init__(self, task):
        self.task = task
        self.attempts = 0
        self.real_failures = 0
        self.due_tick = 0
        self.reason = REASON_ERROR
        self.pending = False


class ResyncQueue:
    """Deterministic per-task backoff queue for the cache's repair loop.

    Not thread-safe by itself: the owning SchedulerCache serialises all
    access under its lock."""

    def __init__(self, backoff_cap: int = 8, poison_after: int = 5,
                 max_entries: int = 4096):
        self.backoff_cap = max(1, backoff_cap)
        self.poison_after = max(1, poison_after)
        self.max_entries = max(1, max_entries)
        self._tick = 0
        self._entries: Dict[str, _Entry] = {}
        self.quarantined: Dict[str, _Entry] = {}
        # lifetime counters (``stats()``)
        self.parked_total = 0
        self.parked_by_reason: Dict[str, int] = {}
        self.quarantined_total = 0
        self.released_total = 0

    def __len__(self) -> int:
        """Pending (awaiting-repair) depth."""
        return sum(1 for e in self._entries.values() if e.pending)

    def pending_tasks(self) -> List[object]:
        return [e.task for e in self._entries.values() if e.pending]

    def has_history(self) -> bool:
        """Cheap lock-free hint: is there ANY per-key bookkeeping that a
        successful bind should clear? (Empty in the steady state, so the
        bulk ack path pays nothing.)"""
        return bool(self._entries)

    # -- intake ----------------------------------------------------------
    def park(self, task, reason: str = REASON_ERROR) -> bool:
        """Admit (or re-admit) a failed decision; returns False when the
        park was a no-op (the key is quarantined) so callers don't count
        it. Each park of the same key escalates its backoff; breaker-open
        parks never escalate the poison budget (the call was refused
        locally, not rejected)."""
        key = task.key()
        if key in self.quarantined:
            # shelved: an external change releases it, not a re-park
            return False
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _Entry(task)
        e.task = task
        e.attempts += 1
        e.real_failures += int(reason != REASON_BREAKER)
        e.reason = reason
        e.pending = True
        e.due_tick = self._tick + min(2 ** (e.attempts - 1), self.backoff_cap)
        self.parked_total += 1
        self.parked_by_reason[reason] = self.parked_by_reason.get(reason, 0) + 1
        return True

    # -- per-repair-pass drain -------------------------------------------
    def tick(self) -> Tuple[List[object], List[object]]:
        """Advance one repair tick; returns (due_tasks, newly_poisoned).

        Poisoned tasks leave the retry flow here — the caller writes their
        condition and shelves their state. Overflow beyond max_entries
        forces the oldest pending backlog due regardless of backoff."""
        self._tick += 1
        due: List[object] = []
        poisoned: List[object] = []
        overflow = len(self) - self.max_entries
        # dict preserves insertion order → the oldest entries come first
        for key, e in list(self._entries.items()):
            if not e.pending:
                continue
            if e.real_failures >= self.poison_after:
                del self._entries[key]
                self.quarantined[key] = e
                self.quarantined_total += 1
                poisoned.append(e.task)
                continue
            if e.due_tick <= self._tick or overflow > 0:
                if e.due_tick > self._tick:
                    overflow -= 1  # forced due by the bound
                e.pending = False
                due.append(e.task)
        return due, poisoned

    # -- lifecycle hooks --------------------------------------------------
    def forget(self, key: str) -> None:
        """The pod left the store (deleted) — drop all bookkeeping."""
        self._entries.pop(key, None)
        if self.quarantined.pop(key, None) is not None:
            self.released_total += 1

    def release(self, key: str) -> Optional[object]:
        """An external change touched a quarantined pod: give it a fresh
        start (returns the shelved task for an immediate resync)."""
        e = self.quarantined.pop(key, None)
        if e is None:
            return None
        self.released_total += 1
        return e.task

    def note_success(self, key: str) -> None:
        """A later attempt for this key landed — clear the backoff history
        so a future unrelated failure starts from attempt 1."""
        self._entries.pop(key, None)

    def reset_history(self) -> None:
        """Wholesale fresh start: drop every pending entry and attempt
        history and release the whole quarantine."""
        self.released_total += len(self.quarantined)
        self.quarantined.clear()
        self._entries.clear()

    # -- observability ----------------------------------------------------
    def stats(self) -> Dict:
        return {
            "depth": len(self),
            "quarantined": len(self.quarantined),
            "parked_total": self.parked_total,
            "parked_by_reason": dict(self.parked_by_reason),
            "quarantined_total": self.quarantined_total,
            "released_total": self.released_total,
        }

    def apply(self, resync_one: Callable[[object], None],
              quarantine_one: Callable[[object], None]) -> int:
        """One repair pass: tick, resync every due task, shelve the newly
        poisoned. Returns the number of tasks resynced."""
        due, poisoned = self.tick()
        for task in poisoned:
            quarantine_one(task)
        for task in due:
            resync_one(task)
        return len(due)
