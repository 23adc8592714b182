"""SnapshotLease — the query plane's consistent read handle.

Mirrors ``kube_batch_tpu/serve/lease.py``:

- the cycle publishes a lease after its swap (the snapshot the solve
  consumed, whole), stamped with the dirty-tracker version token of the
  open that built it;
- probe dispatches run inside :meth:`LeaseBroker.dispatch`, which counts
  the dispatch as an in-flight reader until its readback is done;
- the cycle's swap runs inside :meth:`LeaseBroker.swap_guard`, which keeps
  new dispatches out for the swap's duration.

Where the port differs, and why: the JAX package retires the lease and
waits out readers only on backends whose swaps donate the resident
buffers (not on the CPU, where the old lease stays valid).  The port's
swaps rewrite the resident tensors in place on every device, the CPU
included (``api/resident.py``): a lease kept across a swap would read the
next cycle's values, half-written.  So :meth:`LeaseBroker.swap_guard`
always waits out in-flight readers and retires the published lease.
Answers per lease version are unchanged by this; serving is dark only
from a swap to the re-arm that follows it (every swapping action
republishes right after its dispatch, ``actions/allocate.py``
``republish_query_lease``).

The broker's condition lock is held only for bookkeeping, never across a
device round-trip, so the cycle's publish cannot stall behind a dispatch.
Version tokens are monotonic: a query answered against lease N reports
``snapshot_version: N``, and N never decreases across responses.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional


class SnapshotLease(NamedTuple):
    """One published read handle: everything a probe dispatch needs."""

    snap: object          # DeviceSnapshot — the resident tensors
    meta: object          # SnapshotMeta — decode tables (names, bit maps)
    version: int          # dirty-tracker version token at the open
    config: object        # AllocateConfig the session implies
    evict_config: object  # EvictConfig (preempt) for the eviction probe
    mesh: object          # the solve mesh (None = single-device)
    probe_rows: tuple     # next-free task rows (the tie-hash rows)
    queue_rows: Dict[str, int]  # queue name → row
    #: preempt victim gates of the session's conf that the eviction probe
    #: does not model (drf, proportion), surfaced per response
    unmodeled_gates: tuple = ()
    #: the replication stream's sequence number of this lease's state;
    #: 0 = unreplicated
    seq: int = 0


class LeaseBroker:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._lease: Optional[SnapshotLease] = None
        self._readers = 0       # in-flight probe dispatches
        self._swapping = False  # a resident swap holds exclusivity
        self.published = 0   # publish count
        self.retired = 0     # retirements (swaps and guard heals)
        # what serving loses to the cycle, in seconds: the swaps' waits for
        # in-flight readers, and the dark time from each retirement to the
        # publish after it (total and longest; a dispatch that waits longer
        # than its timeout for a lease fails)
        self.swap_wait_s = 0.0
        self.dark_s = 0.0
        self.dark_longest_s = 0.0
        self._dark_since: Optional[float] = None

    # ---- write side (the cycle) -----------------------------------------
    def publish(self, lease: SnapshotLease) -> None:
        """Install a new lease.  A version below the live lease's is a stale
        publisher and is dropped (the dirty tracker is monotonic)."""
        with self._cond:
            if self._lease is not None and lease.version < self._lease.version:
                return
            self._lease = lease
            self.published += 1
            if self._dark_since is not None:
                dark = time.monotonic() - self._dark_since
                self.dark_s += dark
                self.dark_longest_s = max(self.dark_longest_s, dark)
                self._dark_since = None
            self._cond.notify_all()

    def retire(self) -> None:
        """Drop the published lease without a swap: the guard plane's heal.
        A solve whose sentinel tripped must not keep serving what-ifs from
        the tensors it condemned; new dispatches wait for the next clean
        cycle's publish (or time out)."""
        with self._cond:
            self._retire_locked()

    def _retire_locked(self) -> None:
        if self._lease is not None:
            self._lease = None
            self.retired += 1
            self._dark_since = time.monotonic()

    @contextmanager
    def swap_guard(self):
        """The resident swap's exclusion region (``ColumnStore.
        resident_swap_guard``): new dispatches park for its duration; the
        swap first waits out in-flight readers and retires the published
        lease, whose tensors it is about to rewrite in place (module
        docstring).  The cycle republishes after its dispatch."""
        with self._cond:
            self._cond.wait_for(lambda: not self._swapping)
            self._swapping = True
            t = time.monotonic()
            self._cond.wait_for(lambda: self._readers == 0)
            self.swap_wait_s += time.monotonic() - t
            self._retire_locked()
        try:
            yield
        finally:
            with self._cond:
                self._swapping = False
                self._cond.notify_all()

    # ---- read side (the batcher's flush) --------------------------------
    def current(self, timeout: Optional[float] = None) -> Optional[SnapshotLease]:
        """The live lease, waiting up to ``timeout`` for one (None on
        timeout)."""
        with self._cond:
            if self._lease is None and timeout:
                self._cond.wait_for(lambda: self._lease is not None, timeout=timeout)
            return self._lease

    @contextmanager
    def dispatch(self, timeout: Optional[float] = None):
        """The probe-dispatch region: yields the lease (None on timeout)
        registered as an in-flight reader, so no swap rewrites its tensors
        mid-read.  The lock is not held across the device round-trip."""
        with self._cond:
            if timeout:
                self._cond.wait_for(
                    lambda: self._lease is not None and not self._swapping,
                    timeout=timeout,
                )
            # a swap in flight parks the dispatch regardless of the timeout
            self._cond.wait_for(lambda: not self._swapping)
            lease = self._lease
            if lease is not None:
                self._readers += 1
        try:
            yield lease
        finally:
            if lease is not None:
                with self._cond:
                    self._readers -= 1
                    self._cond.notify_all()
