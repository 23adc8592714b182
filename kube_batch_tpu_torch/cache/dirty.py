"""Cross-cycle dirty tracking for the SchedulerCache.

Mirrors ``kube_batch_tpu/cache/dirty.py``.  The reference never rebuilds
its cache from scratch: informers mutate it incrementally and only the
once-a-cycle snapshot pays a full walk (event_handlers.go).  This module
keeps the bookkeeping that lets the session open go incremental too:

- ``DirtyTracker``: a monotonic ingest version plus per-kind dirty sets
  (job uids, node names, pod keys) and coarse invalidation flags (queue
  row space changed, priority-class universe changed, full rebuild
  forced).  Every ingest handler stamps it; ``take()`` hands the
  accumulated delta to the next session open and resets the accumulators.

- ``OpenCache``: the previous cycle's session-open state, kept across
  cycles so a low-churn open hands the session a delta instead of
  re-deriving every per-job structure: the membership-filtered jobs dict
  (priorities resolved), the PodGroup statuses as they stood at open, and
  the rows the gang gate dropped last cycle (restored before this cycle's
  gate re-votes).

The contract is bit-exact equivalence: a delta-opened session and its
snapshot are indistinguishable from a full rebuild, and the full rebuild
stays the fallback for high churn, row-space changes and a cold cache.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, NamedTuple, Set


class DirtyDelta(NamedTuple):
    """The immutable churn record one session open consumes."""

    version: int
    jobs: FrozenSet[str]
    nodes: FrozenSet[str]
    pods: FrozenSet[str]
    queues_changed: bool
    priority_classes_changed: bool
    full: bool

    def churn_fraction(self, n_jobs: int) -> float:
        """Dirty-job fraction against the previous cycle's session size."""
        if self.full or self.queues_changed or self.priority_classes_changed:
            return 1.0
        return len(self.jobs) / max(n_jobs, 1)


_EMPTY: FrozenSet[str] = frozenset()


class DirtyTracker:
    """Accumulates ingest churn between session opens.  Every mutation entry
    point runs under the cache's lock, so plain sets suffice.

    ``on_advance`` (optional) is called on every version bump, under the
    cache's lock, and must never block.  ``hold_version()`` /
    ``release_version()`` bracket a batched ingest: the dirty sets still
    accumulate per item, but the version advances once for the batch."""

    __slots__ = ("version", "jobs", "nodes", "pods", "queues_changed",
                 "priority_classes_changed", "full", "on_advance", "_held",
                 "_held_pending")

    def __init__(self) -> None:
        self.version = 0
        self.jobs: Set[str] = set()
        self.nodes: Set[str] = set()
        self.pods: Set[str] = set()
        self.queues_changed = False
        self.priority_classes_changed = False
        # a cold tracker reads as "everything changed": the first open after
        # construction (or after a forced invalidation) rebuilds fully
        self.full = True
        self.on_advance = None
        self._held = False
        self._held_pending = False

    def _advance(self) -> None:
        if self._held:
            self._held_pending = True
            return
        self.version += 1
        if self.on_advance is not None:
            self.on_advance()

    def hold_version(self) -> None:
        self._held = True
        self._held_pending = False

    def release_version(self) -> None:
        self._held = False
        if self._held_pending:
            self._held_pending = False
            self._advance()

    # -- stamps (called from the cache's ingest and status choke points) ----
    def note_job(self, uid: str) -> None:
        self.jobs.add(uid)
        self._advance()

    def note_node(self, name: str) -> None:
        self.nodes.add(name)
        self._advance()

    def note_pod(self, key: str) -> None:
        self.pods.add(key)
        self._advance()

    def mark_queues(self) -> None:
        self.queues_changed = True
        self._advance()

    def mark_priority_classes(self) -> None:
        self.priority_classes_changed = True
        self._advance()

    def mark_full(self) -> None:
        self.full = True
        self._advance()

    # -- consumption --------------------------------------------------------
    def take(self) -> DirtyDelta:
        """Snapshot and reset: the caller owns the returned delta; new churn
        accumulates toward the next open."""
        delta = DirtyDelta(
            version=self.version,
            jobs=frozenset(self.jobs) if self.jobs else _EMPTY,
            nodes=frozenset(self.nodes) if self.nodes else _EMPTY,
            pods=frozenset(self.pods) if self.pods else _EMPTY,
            queues_changed=self.queues_changed,
            priority_classes_changed=self.priority_classes_changed,
            full=self.full,
        )
        self.jobs.clear()
        self.nodes.clear()
        self.pods.clear()
        self.queues_changed = False
        self.priority_classes_changed = False
        self.full = False
        return delta


class OpenCache:
    """The previous cycle's session-open state (module docstring).

    ``jobs`` holds the membership-passed live JobInfo objects with their
    priorities resolved; each open hands the session a shallow dict copy,
    so gate drops (``Session.drop_job``) never mutate it.  ``pg_status``
    mirrors ``Session.pod_group_status_at_open``; the cache's status writes
    mark the jobs they change dirty, and the delta open re-reads exactly
    the dirty uids."""

    __slots__ = ("valid", "jobs", "pg_status", "gate_dropped_rows")

    def __init__(self) -> None:
        self.valid = False
        self.jobs: Dict[str, object] = {}
        self.pg_status: Dict[str, tuple] = {}
        # rows the gang gate cleared from j_sess last cycle, restored before
        # this cycle's gate re-votes (a job that regained validity must
        # re-enter the snapshot)
        self.gate_dropped_rows: Set[int] = set()

    def invalidate(self) -> None:
        self.valid = False
        self.jobs = {}
        self.pg_status = {}
        self.gate_dropped_rows = set()
