"""The follower side of the replication stream.

Mirrors ``kube_batch_tpu/replicate/follower.py``.  A follower pulls
``GET /v1/replicate?since=<applied>`` frames from the leader over
:class:`~kube_batch_tpu_torch.k8s.transport.ApiTransport` (the classified
retry policy and circuit breaker of every apiserver call), applies them
to its own host copy of the snapshot, refreshes its own device-resident
tensors with the leader's scatter discipline (``api/resident.py``: the
wire rows are the scatter rows) and publishes a ``SnapshotLease`` into its
own query plane, which then answers what-ifs and sweeps exactly as the
leader does for the same applied record.

The chain check mirrors the warm carry's escalation to cold: a delta
whose ``prev_seq`` / ``prev_version`` is not exactly the applied state is
refused and counted as a gap, and the next pull asks ``since=-1``, which
the leader answers with a full frame.  A full frame is adopted warm: each
field is diffed against the copy already held, only changed rows are
written and only changed fields get a new stamp, so the device tensors
of the unchanged fields survive the resync.

The device comes in at :meth:`FollowerApplier._publish`: the per-cycle
fields go through the port's own ``PerCycleDeviceCache`` (``stage`` and
one ``StagedUpload``), the static fields are uploaded again only when
their stamp moves, all inside the plane's ``broker.swap_guard()``, so a
probe in flight finishes first and the old lease retires (the resident
tensors are rewritten in place).  No lease tensor shares memory with the
host fields, on the CPU either: the next delta scatters into those fields
in place.  ``device=None`` means CUDA and raises without a card.

Each frame moves ``volcano_replication_lag_cycles``; each applied record
counts in ``volcano_replication_applied_total`` and each refused one in
``volcano_replication_resyncs_total``, and the published lease's version
is ``volcano_whatif_snapshot_version`` (``metrics/``).  With a ``tracer``
the device swap runs in a ``replicate_apply`` span.  The counters and the
last apply's times stay on the objects too.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.replicate import stream

logger = logging.getLogger("kube_batch_tpu_torch")

#: idle poll cadence while the leader answers heartbeats
POLL_S_DEFAULT = 0.02


def _poll_s() -> float:
    from kube_batch_tpu_torch.serve.batcher import env_float

    return env_float("KB_REPL_POLL_S", POLL_S_DEFAULT)


class FollowerColumns:
    """Just enough ColumnStore surface for a QueryPlane to attach: the
    plane installs its broker's swap guard here, and the applier runs its
    resident swaps inside it."""

    def __init__(self) -> None:
        self.resident_swap_guard = None


class FollowerCache:
    """The read-only cache a follower serves from: enough of the
    SchedulerCache surface for a QueryPlane, with every ingest mutator
    rejecting.  Cluster state enters a follower only through the stream."""

    _INGEST = (
        "add_pod", "update_pod", "delete_pod",
        "add_node", "update_node", "delete_node",
        "add_pod_group", "update_pod_group", "delete_pod_group",
        "add_queue", "update_queue", "delete_queue",
        "add_priority_class", "delete_priority_class",
        "add_pdb", "update_pdb", "delete_pdb",
    )

    def __init__(self, spec=None) -> None:
        from kube_batch_tpu_torch.api.resources import ResourceSpec

        # replaced by the wire's spec at the first applied record; until a
        # lease exists the plane answers 503 anyway
        self.spec = spec if spec is not None else ResourceSpec()
        self.columns = FollowerColumns()
        self._lock = threading.Lock()
        self.queues: dict = {}
        self.jobs: dict = {}
        self.volume_binder = None
        self.query_plane = None
        for name in self._INGEST:
            setattr(self, name, self._read_only)

    def _read_only(self, *_a, **_k):
        raise ValueError("follower is a read-only replica; ingest on the leader")

    def ingest_batch(self, ops):
        self._read_only()

    def mark_synced(self) -> None:
        pass


class FollowerApplier:
    """Applies decoded records: host scatter or whole-field apply, the
    table patches, the device residency and the lease's publish."""

    def __init__(self, cache: FollowerCache, query_plane, device=None,
                 tracer=None) -> None:
        from kube_batch_tpu_torch.api.resident import PerCycleDeviceCache

        self.device = resolve_device(device)
        self.cache = cache
        self.qp = query_plane
        self.tracer = tracer
        self.fields: Dict[str, np.ndarray] = {}
        self.tables: Optional[dict] = None
        self.applied_seq = 0
        self.applied_version = 0
        self.head_seq = 0
        self.head_version = 0
        self.resident = PerCycleDeviceCache(self.device)
        self._static_dev: Dict[str, Tuple[int, object]] = {}
        self._stamp: Dict[str, int] = {}
        self._spec_cache: Tuple[tuple, object] = ((), None)
        self.applied_records = 0
        self.heartbeats = 0
        self.gaps = 0
        self.full_adoptions = 0
        self.static_uploads = 0
        # the last applied record's host times in ms: decode, host apply
        # (scatters, adoption, table patch) and the device swap (staging,
        # the transfer's launch, the scatters' launches)
        self.last_ms: Dict[str, float] = {}
        query_plane.head_fn = self.head

    def head(self) -> Tuple[int, int]:
        """The leader's head as of the last fetched frame: the staleness
        every verdict of this plane reports."""
        return (self.head_seq, self.head_version)

    # ---- record application ---------------------------------------------
    def apply(self, frame: bytes) -> str:
        """Consume one frame; returns ``"applied"``, ``"heartbeat"`` or
        ``"resync"`` (the caller's next pull must ask for a full frame)."""
        t0 = time.perf_counter()
        rec = stream.decode_record(frame)
        t_decode = time.perf_counter()
        self.head_seq = max(self.head_seq, rec.head_seq)
        self.head_version = max(self.head_version, rec.head_version)
        metrics.set_replication_lag(max(0, self.head_seq - self.applied_seq))
        if rec.kind == stream.HEARTBEAT:
            self.heartbeats += 1
            return "heartbeat"
        try:
            if rec.kind == stream.DELTA:
                if (not self.fields or rec.prev_seq != self.applied_seq
                        or rec.prev_version != self.applied_version):
                    # a chain gap (a missed record, a version skip, a
                    # reconnect): resync in full instead of guessing
                    self.gaps += 1
                    metrics.register_replication_resync()
                    return "resync"
                self._apply_delta(rec)
            else:
                self._adopt_full(rec)
        except (KeyError, IndexError, ValueError) as e:
            logger.warning("replication apply failed (%s); forcing resync", e)
            self.gaps += 1
            metrics.register_replication_resync()
            return "resync"
        t_apply = time.perf_counter()
        self.applied_seq = rec.seq
        self.applied_version = rec.version
        self.applied_records += 1
        self._publish(rec)
        self.last_ms = {"decode": (t_decode - t0) * 1e3,
                        "apply": (t_apply - t_decode) * 1e3,
                        "swap": (time.perf_counter() - t_apply) * 1e3}
        metrics.register_replication_applied(rec.kind)
        metrics.set_replication_lag(max(0, self.head_seq - self.applied_seq))
        return "applied"

    def _bump(self, field: str) -> None:
        self._stamp[field] = self._stamp.get(field, 0) + 1

    def _apply_delta(self, rec) -> None:
        # check every scatter before writing any: a refused record must
        # leave the applied state as it was
        for field, (rows, _vals) in rec.delta.items():
            tgt = self.fields[field]
            if rows.size and (rows.min() < 0 or rows.max() >= tgt.shape[0]):
                raise ValueError(f"delta rows out of range for {field}")
        for field, arr in rec.full.items():
            self.fields[field] = arr
            self._bump(field)
        for field, (rows, vals) in rec.delta.items():
            self.fields[field][rows] = vals
            self._bump(field)
        self.tables = stream.apply_meta_patch(self.tables, rec.meta)

    def _adopt_full(self, rec) -> None:
        """The warm re-adoption: each incoming field is diffed against the
        copy held, so an unchanged field keeps its stamp (and its device
        tensor)."""
        from kube_batch_tpu_torch.api.resident import changed_rows
        from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot

        missing = [f for f in DeviceSnapshot._fields if f not in rec.full]
        if missing:
            raise ValueError(f"full record missing fields {missing[:3]}")
        for field, arr in rec.full.items():
            cur = self.fields.get(field)
            if cur is None or cur.shape != arr.shape or cur.dtype != arr.dtype:
                self.fields[field] = arr
                self._bump(field)
                continue
            rows = changed_rows(cur, arr)
            if rows.size:
                cur[rows] = arr[rows]
                self._bump(field)
        self.tables = rec.meta
        self.full_adoptions += 1

    # ---- residency and the lease's publish -------------------------------
    def _spec_for(self, lease_wire):
        from kube_batch_tpu_torch.api.resources import ResourceSpec

        names = tuple(lease_wire.get("scalar_names", ()))
        cached_names, cached = self._spec_cache
        if cached is None or cached_names != names:
            cached = ResourceSpec(names)
            self._spec_cache = (names, cached)
        return cached

    def _swap(self):
        """The device snapshot of the applied fields (the caller holds the
        plane's swap guard)."""
        from kube_batch_tpu_torch.api.convert import host_field
        from kube_batch_tpu_torch.api.resident import (
            PER_CYCLE_FIELDS,
            PerCycleDeviceCache,
            StagedUpload,
        )
        from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot

        host_snap = DeviceSnapshot(**{f: self.fields[f] for f in DeviceSnapshot._fields})
        upload = StagedUpload(self.device)
        made = self.resident.stage(host_snap, upload)
        for field in DeviceSnapshot._fields:
            if field in PER_CYCLE_FIELDS:
                continue
            stamp = self._stamp.get(field, 0)
            cached = self._static_dev.get(field)
            if cached is not None and cached[0] == stamp:
                made[field] = lambda t=cached[1]: t
                continue
            handle = upload.add(host_field(field, self.fields[field]))
            self.static_uploads += 1

            def done(field=field, stamp=stamp, handle=handle):
                # a copy: the view would keep the whole staging buffer
                t = upload.tensor(handle).clone()
                self._static_dev[field] = (stamp, t)
                return t

            made[field] = done
        try:
            upload.run()
            return DeviceSnapshot(**{f: made[f]() for f in DeviceSnapshot._fields})
        except BaseException:
            # the resident mirrors already describe this swap: start cold
            self.resident = PerCycleDeviceCache(self.device)
            self._static_dev.clear()
            raise

    def _publish(self, rec) -> None:
        from kube_batch_tpu_torch.serve.lease import SnapshotLease

        spec = self._spec_for(rec.lease)
        meta = stream.build_snapshot_meta(self.tables, spec)
        config = stream.config_from_wire(rec.lease["config"])
        evict_config = stream.config_from_wire(rec.lease["evict_config"])
        with self.qp.broker.swap_guard():
            if self.tracer is not None:
                with self.tracer.span("replicate_apply", seq=rec.seq, kind=rec.kind):
                    dev_snap = self._swap()
            else:
                dev_snap = self._swap()
        lease = SnapshotLease(
            snap=dev_snap, meta=meta, version=rec.version, config=config,
            evict_config=evict_config, mesh=None,
            probe_rows=tuple(int(r) for r in rec.lease["probe_rows"]),
            queue_rows={k: int(v) for k, v in rec.lease["queue_rows"].items()},
            unmodeled_gates=tuple(rec.lease["unmodeled_gates"]),
            seq=rec.seq,
        )
        self.cache.spec = spec
        self.qp.broker.publish(lease)
        metrics.set_whatif_snapshot_version(rec.version)

    def revalidate_resident(self) -> dict:
        """The re-adoption check after a pull-loop restart
        (``ColumnStore.revalidate_resident``'s contract): a resident cache
        that has synced at least one snapshot is kept (the next swap
        absorbs what diverged as ordinary deltas); anything else starts
        cold."""
        from kube_batch_tpu_torch.api.resident import PerCycleDeviceCache

        if self.resident.version > 0 and self.fields:
            return {"mode": "warm", "resident_version": self.resident.version}
        self.resident = PerCycleDeviceCache(self.device)
        self._static_dev.clear()
        return {"mode": "cold", "resident_version": 0}


class ReplicationFollower:
    """The pull loop: transport, applier and the follower's query plane.
    :meth:`start` runs it on a daemon thread; tests and drives call
    :meth:`run_once` themselves."""

    def __init__(self, leader_url: str, cache: Optional[FollowerCache] = None,
                 query_plane=None, poll_s: Optional[float] = None,
                 transport=None, timeout: float = 30.0, device=None,
                 tracer=None) -> None:
        from kube_batch_tpu_torch.k8s.transport import ApiTransport

        device = resolve_device(device)
        self.cache = cache if cache is not None else FollowerCache()
        if query_plane is None:
            from kube_batch_tpu_torch.serve.plane import QueryPlane

            query_plane = QueryPlane(self.cache)
        self.qp = query_plane
        self.applier = FollowerApplier(self.cache, query_plane, device=device,
                                       tracer=tracer)
        self.transport = (transport if transport is not None
                          else ApiTransport(leader_url, role="replicate"))
        self.poll_s = _poll_s() if poll_s is None else poll_s
        self.timeout = timeout
        self._force_full = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pull_errors = 0

    def run_once(self) -> str:
        """One pull and apply; returns the applier's outcome, or
        ``"error"`` when the transport failed (the loop polls again; the
        transport's retry policy and breaker pace it)."""
        since = -1 if self._force_full else self.applier.applied_seq
        try:
            frame = self.transport.get_bytes(f"/v1/replicate?since={since}",
                                             timeout=self.timeout)
        except Exception as e:  # noqa: BLE001 — the transport classified it already
            self.pull_errors += 1
            logger.debug("replication pull failed: %s", e)
            return "error"
        outcome = self.applier.apply(frame)
        if outcome == "resync":
            self._force_full = True
        elif outcome == "applied":
            self._force_full = False
        return outcome

    def _loop(self) -> None:
        # on a (re)start, decide warm or cold residency once
        mode = self.applier.revalidate_resident()
        logger.info("replication follower loop starting (%s residency)", mode["mode"])
        while not self._stop.is_set():
            outcome = self.run_once()
            if outcome in ("heartbeat", "error"):
                # caught up or disconnected: pace the next pull; applied
                # records loop at once to drain the backlog
                self._stop.wait(self.poll_s)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kb-follower-pull")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
