"""The leader side of the replication stream.

Mirrors ``kube_batch_tpu/replicate/publisher.py``.  A
:class:`ReplicationPublisher` hangs off the scheduler cache
(``cache.replication``); ``QueryPlane.publish_session`` calls
:meth:`ReplicationPublisher.publish_cycle` after the resident swap and
before the broker install, so the lease it installs carries the record's
sequence number.

The call has two phases, overlapped like the scheduler's writeback stage:
the cycle thread allocates the seq, captures the snapshot's host arrays
and joins the previous record's encode; the diff and the frame's encode
run on a one-thread worker while the cycle goes on.
``Scheduler.drain_pipeline`` joins the encode in flight through
:meth:`barrier`.

Where the port differs, and why: the capture copies every host array.
The port's host snapshot hands several live column arrays through as they
are (``ColumnStore.device_snapshot``), and the cycle mutates them after
the publish: allocate publishes before its readback, and its replay then
binds tasks in place, while the worker may still be diffing.  A frame
must describe exactly the lease it stamps, so the worker reads only the
copies.

The publisher keeps host mirrors of every snapshot field and diffs them
with the port's :func:`~kube_batch_tpu_torch.api.resident.changed_rows`,
the resident cache's own diff, so the wire deltas are row-exact.  For the
per-cycle fields it takes the resident swap's delta record
(``ColumnStore.export_delta_record``) as a fast path when the swap
version advanced by exactly one since the last publish; any other cadence
diffs against the mirrors.  A delta whose payload would reach the whole
field's bytes ships whole (``PerCycleDeviceCache._payload_bytes``, the
scatter's break-even).  The mirrors are also the source of the full frame
synthesized for a follower whose ``since`` fell off the ring.

The JAX package's metrics and tracer span are not ported (ROADMAP items
8 and 9); the counters stay on the object (:meth:`counters`), with the
cycle thread's and the worker's times beside them.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from kube_batch_tpu_torch.replicate import stream
from kube_batch_tpu_torch.utils.switches import env_int

logger = logging.getLogger("kube_batch_tpu_torch")

#: encoded frames kept for delta serving; a follower further behind than
#: the ring gets a synthesized full frame instead
RING_SIZE = env_int("KB_REPL_RING", 64)


def _lease_wire(lease) -> dict:
    """The lease's extras a follower cannot derive from the arrays: the
    configurations, probe rows, queue rows, unmodeled gates and the
    resource axis's scalar names."""
    config = lease.config
    evict = lease.evict_config
    if config.weights.extra_rows:
        # host callables cannot cross the wire
        config = config._replace(weights=config.weights._replace(extra_rows=()))
    if evict.weights.extra_rows:
        evict = evict._replace(weights=evict.weights._replace(extra_rows=()))
    return {
        "config": stream.config_to_wire(config),
        "evict_config": stream.config_to_wire(evict),
        "probe_rows": [int(r) for r in lease.probe_rows],
        "queue_rows": {k: int(v) for k, v in lease.queue_rows.items()},
        "unmodeled_gates": list(lease.unmodeled_gates),
        "scalar_names": list(lease.meta.spec.names[3:]),
    }


class ReplicationPublisher:
    def __init__(self, ring_size: Optional[int] = None) -> None:
        self.ring_size = RING_SIZE if ring_size is None else ring_size
        self._lock = threading.RLock()
        self._mirror: Dict[str, np.ndarray] = {}
        self._meta_tables: Optional[dict] = None
        self._lease_wire: Optional[dict] = None
        self._ring: deque = deque()     # (seq, frame bytes)
        self._full_cache: Optional[Tuple[int, bytes]] = None
        self._next_seq = 0              # allocated on the cycle thread
        self._head_seq = 0              # advanced when the encode lands
        self._head_version = 0
        self._last_cache_version = 0    # swap version at the last publish
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="kb-replicate")
        self._pending: Optional[Future] = None
        self._closed = False
        self.records = {stream.FULL: 0, stream.DELTA: 0}
        self.heartbeats = 0
        self.bytes_published = 0
        self.hint_fields = 0            # per-cycle fields served by the swap's
        self.diff_fields = 0            # delta record, against self-diffed
        self.encode_errors = 0
        # times in ms: the cycle thread's last publish_cycle (the join of
        # the previous encode in it apart) and the worker's last encode
        self.last_publish_ms = 0.0
        self.last_join_ms = 0.0
        self.last_encode_ms = 0.0
        self.last_frame_bytes = 0

    # ---- cycle thread ----------------------------------------------------
    def publish_cycle(self, snap, meta, lease, delta_hint=None,
                      cache_version: int = 0) -> int:
        """Allocate and return this record's seq; the diff and the encode
        run on the worker (joined by the next publish_cycle or by
        :meth:`barrier`).  ``delta_hint`` is the resident swap's delta
        record (field → changed rows, or None for a full upload) and
        ``cache_version`` that swap's version."""
        t0 = time.perf_counter()
        self.barrier()
        t_join = time.perf_counter()
        with self._lock:
            if self._closed:
                return self._head_seq
            self._next_seq += 1
            seq = self._next_seq
            hint_ok = (delta_hint is not None and bool(self._mirror)
                       and cache_version == self._last_cache_version + 1)
            self._last_cache_version = cache_version
        fields = {f: np.array(getattr(snap, f), copy=True) for f in type(snap)._fields}
        tables = stream.meta_tables(meta)
        lease_wire = _lease_wire(lease)
        version = int(lease.version)
        hint = dict(delta_hint) if hint_ok else None
        self._pending = self._pool.submit(
            self._encode_cycle, seq, version, fields, tables, lease_wire, hint)
        self.last_join_ms = (t_join - t0) * 1e3
        self.last_publish_ms = (time.perf_counter() - t0) * 1e3
        return seq

    def barrier(self) -> None:
        """Join the encode in flight (the scheduler's drain hook, like the
        writeback stage's)."""
        fut, self._pending = self._pending, None
        if fut is not None:
            fut.result()

    def close(self) -> None:
        self.barrier()
        with self._lock:
            self._closed = True
        self._pool.shutdown(wait=True)

    def invalidate(self) -> None:
        """Drop the mirrors: the next record is full (state the leader no
        longer trusts must not keep feeding deltas)."""
        with self._lock:
            self._mirror.clear()
            self._meta_tables = None
            self._full_cache = None

    # ---- worker ----------------------------------------------------------
    def _encode_cycle(self, seq, version, fields, tables, lease_wire, hint):
        t0 = time.perf_counter()
        try:
            self._encode_locked(seq, version, fields, tables, lease_wire, hint)
        except Exception:  # noqa: BLE001 — the next record is full; the cycle goes on
            # a half-updated mirror must never feed another delta
            with self._lock:
                self.encode_errors += 1
            logger.exception("replication encode failed; next record full")
            self.invalidate()
        self.last_encode_ms = (time.perf_counter() - t0) * 1e3

    def _encode_locked(self, seq, version, fields, tables, lease_wire, hint):
        from kube_batch_tpu_torch.api.resident import (
            PER_CYCLE_FIELDS,
            PerCycleDeviceCache,
            changed_rows,
        )

        with self._lock:
            cold = not self._mirror
            full: Dict[str, np.ndarray] = {}
            delta: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
            for field, host in fields.items():
                mirror = self._mirror.get(field)
                if mirror is None or mirror.shape != host.shape or mirror.dtype != host.dtype:
                    full[field] = host
                    self._mirror[field] = host.copy()
                    continue
                if hint is not None and field in PER_CYCLE_FIELDS:
                    if field not in hint:
                        self.hint_fields += 1
                        continue  # the swap found this field clean
                    rows = hint[field]
                    if (isinstance(rows, np.ndarray)
                            and (rows.size == 0
                                 or (0 <= rows.min() and rows.max() < host.shape[0]))):
                        self.hint_fields += 1
                        changed = rows.astype(np.int64, copy=False)
                    else:
                        changed = changed_rows(mirror, host)
                        self.diff_fields += 1
                else:
                    changed = changed_rows(mirror, host)
                    self.diff_fields += 1
                if changed.size == 0:
                    continue
                payload = PerCycleDeviceCache._payload_bytes(int(changed.size), host)
                if payload >= host.nbytes:
                    full[field] = host
                    self._mirror[field] = host.copy()
                else:
                    vals = np.ascontiguousarray(host[changed])
                    delta[field] = (changed.astype(np.int32), vals)
                    mirror[changed] = vals
            if cold or self._meta_tables is None:
                kind, meta_out = stream.FULL, tables
            else:
                kind = stream.DELTA
                meta_out = stream.meta_patch(self._meta_tables, tables)
            rec = stream.ReplicationRecord(
                kind=kind, seq=seq, version=version,
                prev_seq=(-1 if kind == stream.FULL else self._head_seq),
                prev_version=(-1 if kind == stream.FULL else self._head_version),
                head_seq=seq, head_version=version,
                full=full, delta=delta, meta=meta_out, lease=lease_wire)
            frame = stream.encode_record(rec)
            self._meta_tables = tables
            self._lease_wire = lease_wire
            self._ring.append((seq, frame))
            while len(self._ring) > self.ring_size:
                self._ring.popleft()
            self._full_cache = None
            self._head_seq = seq
            self._head_version = version
            self.records[kind] += 1
            self.bytes_published += len(frame)
            self.last_frame_bytes = len(frame)

    # ---- serving (the follower's pull) -----------------------------------
    def record_for(self, since: int) -> bytes:
        """The frame a follower at applied seq ``since`` consumes next: its
        successor delta while the ring holds it, a heartbeat when it is
        caught up, else a full frame synthesized from the mirrors (a cold
        start, a ring fall-off or an explicit ``since=-1`` resync)."""
        with self._lock:
            head_seq, head_version = self._head_seq, self._head_version
            if head_seq == 0 or since >= head_seq:
                self.heartbeats += 1
                return self._heartbeat(head_seq, head_version)
            if since >= 0:
                for seq, frame in self._ring:
                    if seq == since + 1:
                        return frame
            return self._full_frame(head_seq, head_version)

    def _heartbeat(self, head_seq: int, head_version: int) -> bytes:
        rec = stream.ReplicationRecord(
            kind=stream.HEARTBEAT, seq=head_seq, version=head_version,
            prev_seq=-1, prev_version=-1,
            head_seq=head_seq, head_version=head_version,
            full={}, delta={}, meta={}, lease={})
        return stream.encode_record(rec)

    def _full_frame(self, head_seq: int, head_version: int) -> bytes:
        # the caller holds the lock; cached per head, so a herd of
        # resyncing followers pays one encode
        if self._full_cache is not None and self._full_cache[0] == head_seq:
            return self._full_cache[1]
        rec = stream.ReplicationRecord(
            kind=stream.FULL, seq=head_seq, version=head_version,
            prev_seq=-1, prev_version=-1,
            head_seq=head_seq, head_version=head_version,
            full=dict(self._mirror), delta={},
            meta=self._meta_tables or {}, lease=self._lease_wire or {})
        frame = stream.encode_record(rec)
        self._full_cache = (head_seq, frame)
        self.records[stream.FULL] += 1
        self.bytes_published += len(frame)
        return frame

    def counters(self) -> dict:
        with self._lock:
            return {
                "head_seq": self._head_seq,
                "head_version": self._head_version,
                "records_full": self.records[stream.FULL],
                "records_delta": self.records[stream.DELTA],
                "heartbeats": self.heartbeats,
                "bytes_published": self.bytes_published,
                "hint_fields": self.hint_fields,
                "diff_fields": self.diff_fields,
                "encode_errors": self.encode_errors,
                "ring": len(self._ring),
            }
