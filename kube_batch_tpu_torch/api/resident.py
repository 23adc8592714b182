"""Per-cycle device-resident snapshot columns, refreshed by row scatters.

Mirrors ``kube_batch_tpu/api/resident.py``, the mesh's residency
(``ShardedPerCycleDeviceCache``) included.  The
ingest-static columns ride ``ColumnStore.resident_features`` (re-uploaded
when their axis version moves); this module keeps the *per-cycle* columns
(statuses, node ledgers, job and queue rows) alive on the device between
cycles.  For each field the host keeps a mirror of what the device holds,
and each swap diffs the freshly built host column against it:

- no row changed → the resident tensor is handed to the solve as it is;
- a small delta → the changed rows and their values are uploaded and
  written in place with ``index_copy_``;
- a delta wider than the largest slot bucket, a slot bucket whose payload
  is not smaller than the column, or a shape or dtype change (axis
  growth) → the whole column is uploaded.

The slot buckets (``SCATTER_SLOT_BUCKETS``) and ``_payload_bytes`` are the
JAX package's: they decide scatter against full upload and feed the
``bytes_*`` counters, so both packages count the same swaps the same way.
Nothing is padded here — torch compiles no shape-specialised program, and
``index_copy_`` raises on an out-of-range row — so a scatter ships only
the changed rows (``bytes_shipped`` counts what moved).

Every swap's payloads (scatter rows and values, full columns, and the
fields no cache holds) are packed into one host buffer, pinned on CUDA, and
moved in one non-blocking copy; each swap stages into a fresh buffer,
which PyTorch's pinned-memory allocator does not reuse before that copy
has completed.  On the CPU the resident tensors are copies too, never the
host columns or the staging buffer: a tensor that aliased the column store
would make the mirror diff read clean and the scatter path untested.

In-place updates take the place of the JAX package's buffer donation: a
later swap rewrites the same tensors, so a consumer must not keep a
resident tensor past its own readback.  Each device program of the cycle
(allocate's solve and its fit-error histogram, reclaim's and preempt's
eviction solve, backfill's stranded-capacity solve) swaps, launches and
reads back before the next action swaps, and no action keeps a snapshot
tensor afterwards.  All run on one stream, so a swap's writes follow the
kernels already queued on the tensors.

On a mesh (``parallel/mesh.py``) ``ShardedPerCycleDeviceCache`` keeps
each node-axis field per (device, node shard) and every other field per
distinct device, with the JAX package's per-shard decisions and counters
and its churn-adaptive slot ladder.

The last part of the module is the warm-started allocate's host
planner (``WarmTableState``, the JAX package's, keyed by device): every
swap's delta record is absorbed into it, and each warm dispatch asks it
which carried rows to re-rank and which nodes' keys to refresh.  The
carried table it holds is made by the solve (new tensors every cycle),
never a view of a resident snapshot tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# snapshot fields refreshed per cycle (everything the static feature cache
# does not own, minus the variable-K sparse affinity rows)
PER_CYCLE_FIELDS: Tuple[str, ...] = (
    "task_status", "task_node", "task_valid", "task_pending",
    "task_best_effort",
    "node_idle", "node_releasing", "node_used", "node_valid", "node_sched",
    "job_min_avail", "job_ready", "job_queue", "job_prio", "job_creation",
    "job_valid", "job_schedulable", "job_allocated",
    "queue_weight", "queue_capability", "queue_alloc", "queue_request",
    "queue_valid",
    "total",
)

#: scatter width buckets: a delta is costed at the smallest bucket that
#: holds it; deltas wider than the largest take the full upload
SCATTER_SLOT_BUCKETS: Tuple[int, ...] = (64, 512, 4096)
SCATTER_SLOTS = SCATTER_SLOT_BUCKETS[-1]

#: byte alignment of each payload in a staging buffer (any dtype view of a
#: slice at this offset is aligned)
_ALIGN = 16


def _slot_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest slot bucket holding an n-row delta (the caller guarantees
    n ≤ buckets[-1])."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def changed_rows(mirror: np.ndarray, host: np.ndarray) -> np.ndarray:
    """Ascending row indices where ``host`` differs from ``mirror``."""
    if host.ndim == 1:
        return np.flatnonzero(mirror != host)
    return np.flatnonzero(np.any(mirror != host, axis=1))


def scatter_summary(per_path_counters: Dict[str, Dict[str, int]]) -> Dict[str, Dict]:
    """Per-path counters with the bytes moved and the upload reduction
    against full per-cycle uploads (``ColumnStore.resident_counters()``
    feeds it)."""
    out: Dict[str, Dict] = {}
    for path, c in per_path_counters.items():
        moved = c["bytes_full"] + c["bytes_scatter"]
        rec = dict(c)
        rec["bytes_moved"] = moved
        if c["bytes_if_full"]:
            rec["upload_reduction"] = round(1.0 - moved / c["bytes_if_full"], 3)
        out[path] = rec
    return out


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


class StagedUpload:
    """One swap's host→device transfer: payloads are added as numpy arrays
    (``add`` returns a handle), ``run`` packs them into one fresh host
    buffer (pinned on CUDA) and moves it in one non-blocking copy, and
    ``tensor`` then gives each payload as a device tensor (a view into the
    transferred buffer)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.nbytes = 0
        self._parts = []
        self._views = None

    def add(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        off = -(-self.nbytes // _ALIGN) * _ALIGN
        self._parts.append((off, arr))
        self.nbytes = off + arr.nbytes
        return len(self._parts) - 1

    def run(self) -> None:
        cuda = self.device.type == "cuda"
        host = torch.empty(max(self.nbytes, _ALIGN), dtype=torch.uint8,
                           pin_memory=cuda)
        hb = host.numpy()
        for off, arr in self._parts:
            hb[off:off + arr.nbytes] = arr.reshape(-1).view(np.uint8)
        buf = host.to(self.device, non_blocking=True) if cuda else host
        self._views = [
            buf[off:off + arr.nbytes].view(_torch_dtype(arr.dtype)).view(arr.shape)
            for off, arr in self._parts]

    def tensor(self, handle: int) -> torch.Tensor:
        return self._views[handle]


class PerCycleDeviceCache:
    """The per-cycle fields of one device's snapshot, resident between
    cycles (module docstring)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._mirror: Dict[str, np.ndarray] = {}
        self._dev: Dict[str, torch.Tensor] = {}
        # per-swap delta record: field → changed row indices for a scatter
        # or a full upload after a diff, None for an upload without a
        # mirror to diff against; clean fields are absent
        self.delta_record: Dict[str, object] = {}
        # the last (input snap, swapped result): a repeat swap of the same
        # snapshot object (allocate's fit-error histogram after its solve)
        # returns the same tensors without re-diffing
        self._last_in = None
        self._last_out = None
        # monotonic swap version
        self.version = 0
        self.full_uploads = 0
        self.scatter_updates = 0
        self.clean_hits = 0
        # bytes the JAX package's slot-bucketed transfers would ship, and
        # what full per-cycle uploads would; bytes_shipped is what this
        # cache's scatters and full uploads actually moved
        self.bytes_full = 0
        self.bytes_scatter = 0
        self.bytes_if_full = 0
        self.bytes_shipped = 0

    def counters(self) -> Dict[str, int]:
        return {
            "version": self.version,
            "full_uploads": self.full_uploads,
            "scatter_updates": self.scatter_updates,
            "clean_hits": self.clean_hits,
            "bytes_full": self.bytes_full,
            "bytes_scatter": self.bytes_scatter,
            "bytes_if_full": self.bytes_if_full,
            "bytes_shipped": self.bytes_shipped,
        }

    @staticmethod
    def _payload_bytes(slots: int, host: np.ndarray) -> int:
        """A ``slots``-wide delta's size in the JAX package's layout (an
        int32 index and one value row per slot)."""
        row = host.dtype.itemsize * int(np.prod(host.shape[1:], dtype=np.int64))
        return slots * (4 + row)

    def _full(self, field: str, host: np.ndarray, upload: StagedUpload):
        self.full_uploads += 1
        self.bytes_full += host.nbytes
        self.bytes_shipped += host.nbytes
        self._mirror[field] = host.copy()
        handle = upload.add(host)

        def done() -> torch.Tensor:
            src = upload.tensor(handle)
            dev = self._dev.get(field)
            if dev is not None and dev.shape == src.shape and dev.dtype == src.dtype:
                dev.copy_(src)
            else:
                dev = self._dev[field] = src.clone()
            return dev

        return done

    def _refresh(self, field: str, host: np.ndarray,
                 upload: StagedUpload) -> Callable[[], torch.Tensor]:
        """Decide this field's update, stage its payload and update the
        mirror; returns what yields the device tensor once ``upload`` ran."""
        self.bytes_if_full += host.nbytes
        mirror = self._mirror.get(field)
        if mirror is None or mirror.shape != host.shape or mirror.dtype != host.dtype:
            self.delta_record[field] = None
            return self._full(field, host, upload)
        changed = changed_rows(mirror, host)
        if changed.size == 0:
            self.clean_hits += 1
            dev = self._dev[field]
            return lambda: dev
        self.delta_record[field] = changed
        slots = _slot_bucket(changed.size, SCATTER_SLOT_BUCKETS)
        if changed.size > SCATTER_SLOTS or self._payload_bytes(slots, host) >= host.nbytes:
            return self._full(field, host, upload)
        vals = host[changed]
        rows = changed.astype(np.int64)
        mirror[changed] = vals
        self.scatter_updates += 1
        self.bytes_scatter += self._payload_bytes(slots, host)
        self.bytes_shipped += rows.nbytes + vals.nbytes
        h_rows, h_vals = upload.add(rows), upload.add(vals)

        def done() -> torch.Tensor:
            dev = self._dev[field]
            dev.index_copy_(0, upload.tensor(h_rows), upload.tensor(h_vals))
            return dev

        return done

    def stage(self, snap, upload: StagedUpload) -> Dict[str, Callable[[], torch.Tensor]]:
        """Stage a swap of ``snap``'s per-cycle fields into ``upload``;
        returns field → what yields its device tensor once ``upload`` ran."""
        self.version += 1
        self.delta_record = {}
        return {field: self._refresh(field, np.asarray(getattr(snap, field)), upload)
                for field in PER_CYCLE_FIELDS}

    def memo(self, snap) -> Optional[object]:
        """The result of the last swap when ``snap`` is the same object."""
        return self._last_out if snap is self._last_in else None

    def remember(self, snap, out) -> None:
        self._last_in, self._last_out = snap, out


# ==========================================================================
# Mesh-sharded residency
# ==========================================================================

#: the subset whose leading axis is the node axis: sliced per node shard on
#: the sharded path (``parallel/mesh.snapshot_shardings``); everything else
#: is kept once per distinct device
NODE_AXIS_FIELDS = frozenset((
    "node_idle", "node_releasing", "node_used", "node_valid", "node_sched",
))

#: per-shard slot-width buckets of the mesh scatter (the JAX package's
#: static default; the live ladder follows the churn EWMA, capped here)
SHARD_SCATTER_SLOT_BUCKETS: Tuple[int, ...] = (16, 128, 1024)
SHARD_SCATTER_SLOTS = SHARD_SCATTER_SLOT_BUCKETS[-1]

#: churn EWMA smoothing for the adaptive per-shard ladder
CHURN_EWMA_DECAY = 0.8


def all_shard_buckets(max_slots: int) -> Tuple[int, ...]:
    """Every per-shard bucket width the adaptive ladder can select: powers
    of two from 16 up to the cap (the widths the JAX package compiles at
    its cold upload)."""
    out = []
    v = min(16, max_slots)
    while True:
        out.append(v)
        if v >= max_slots:
            return tuple(out)
        v = min(v * 2, max_slots)


def adaptive_ladder(ewma: float, max_slots: int) -> Tuple[int, ...]:
    """The per-shard slot ladder sized from the churn EWMA: the base is the
    smallest power of two ≥ max(16, 2 × ewma), then ×8 steps to the cap.
    Zero churn gives the static default."""
    base = 16
    target = max(16.0, 2.0 * ewma)
    while base < target and base < max_slots:
        base *= 2
    base = min(base, max_slots)
    ladder = [base]
    while ladder[-1] < max_slots:
        ladder.append(min(ladder[-1] * 8, max_slots))
    return tuple(ladder)


class ShardedPerCycleDeviceCache(PerCycleDeviceCache):
    """The per-cycle fields resident on a mesh (``parallel/mesh.py``): each
    node-axis field as one tensor per (device, node shard) holding that
    shard's rows, every other field once per distinct device.  No tensor is
    shared with another placement, with the single-device cache or with a
    swap's staging buffers, so the in-place refreshes below never write
    through one placement into another, even on a mesh whose devices
    repeat.

    The decisions and the counters are the JAX package's
    ``ShardedPerCycleDeviceCache``'s: a node-axis delta is partitioned by
    owning shard and costed at the live per-shard ladder's bucket of the
    widest shard's rows (a full upload past the ladder's top or when the
    payload is not smaller than the column); other fields as the
    single-device cache.  The ladder retargets from the churn EWMA of the
    widest per-shard delta, once per swap (``ladder_retargets``).  Under
    ``distributed`` the byte counters carry this process's share of the
    node-axis fields.  What moves: each placement's changed rows (written
    with ``index_copy_``) or its whole slice."""

    def __init__(self, mesh) -> None:
        super().__init__(mesh.first)
        self.mesh = mesh
        self.n_shards = mesh.node_shards
        self.churn_ewma = 0.0
        self._ladder: Tuple[int, ...] = adaptive_ladder(0.0, SHARD_SCATTER_SLOTS)
        self._cycle_max = 0
        self.ladder_retargets = 0
        # placements: every local (device, node shard) pair, and the
        # distinct devices
        self.node_places = []
        for (i, j) in mesh.local_positions():
            key = (mesh.device(i, j), j)
            if key not in self.node_places:
                self.node_places.append(key)
        self.devices = mesh.distinct()

    def counters(self) -> Dict[str, int]:
        out = super().counters()
        out["churn_ewma"] = round(self.churn_ewma, 2)
        out["slot_ladder"] = list(self._ladder)
        out["ladder_retargets"] = self.ladder_retargets
        return out

    def _host_fraction(self) -> float:
        """This process's share of the mesh (the per-host byte scale)."""
        if self.mesh.distributed:
            import torch.distributed as dist

            return 1.0 / dist.get_world_size(self.mesh.group)
        return 1.0

    def _places(self, field: str):
        return self.node_places if field in NODE_AXIS_FIELDS else self.devices

    def _part(self, field: str, host: np.ndarray, place) -> np.ndarray:
        if field in NODE_AXIS_FIELDS:
            s = host.shape[0] // self.n_shards
            return host[place[1] * s:(place[1] + 1) * s]
        return host

    def _full_sharded(self, field: str, host: np.ndarray, uploads) -> Callable:
        frac = self._host_fraction() if field in NODE_AXIS_FIELDS else 1.0
        self.full_uploads += 1
        self.delta_record.setdefault(field, None)
        self.bytes_full += int(host.nbytes * frac)
        self._mirror[field] = host.copy()
        old = self._dev.get(field) or {}
        handles = {}
        for place in self._places(field):
            part = self._part(field, host, place)
            dev = place[0] if isinstance(place, tuple) else place
            handles[place] = (dev, uploads[dev].add(part))
            self.bytes_shipped += part.nbytes

        def done() -> Dict:
            out = {}
            for place, (dev, h) in handles.items():
                src = uploads[dev].tensor(h)
                t = old.get(place)
                if t is not None and t.shape == src.shape and t.dtype == src.dtype:
                    t.copy_(src)
                else:
                    t = src.clone()
                out[place] = t
            self._dev[field] = out
            return out

        return done

    def _refresh(self, field: str, host: np.ndarray, uploads) -> Callable:
        sharded = field in NODE_AXIS_FIELDS
        frac = self._host_fraction() if sharded else 1.0
        self.bytes_if_full += int(host.nbytes * frac)
        mirror = self._mirror.get(field)
        if mirror is None or mirror.shape != host.shape or mirror.dtype != host.dtype:
            return self._full_sharded(field, host, uploads)
        changed = changed_rows(mirror, host)
        if changed.size == 0:
            self.clean_hits += 1
            cur = self._dev[field]
            return lambda: cur
        self.delta_record[field] = changed
        if sharded:
            s = host.shape[0] // self.n_shards
            shard_ids = changed // s
            counts = np.bincount(shard_ids, minlength=self.n_shards)
            widest = int(counts.max())
            self._cycle_max = max(self._cycle_max, widest)
            if widest > min(self._ladder[-1], SHARD_SCATTER_SLOTS):
                return self._full_sharded(field, host, uploads)
            slots = _slot_bucket(widest, self._ladder)
            if self._payload_bytes(slots, host) * self.n_shards >= host.nbytes:
                return self._full_sharded(field, host, uploads)
            self.bytes_scatter += int(self._payload_bytes(slots, host) * self.n_shards * frac)
        else:
            if changed.size > SCATTER_SLOTS:
                return self._full_sharded(field, host, uploads)
            slots = _slot_bucket(changed.size, SCATTER_SLOT_BUCKETS)
            if self._payload_bytes(slots, host) >= host.nbytes:
                return self._full_sharded(field, host, uploads)
            self.bytes_scatter += self._payload_bytes(slots, host)
        self.scatter_updates += 1
        mirror[changed] = host[changed]
        cur = self._dev[field]
        handles = {}
        for place in self._places(field):
            if sharded:
                j = place[1]
                rows = changed[(changed >= j * s) & (changed < (j + 1) * s)]
                if rows.size == 0:
                    continue
                local = rows - j * s
            else:
                rows = local = changed
            dev = place[0] if isinstance(place, tuple) else place
            vals = host[rows]
            r64 = local.astype(np.int64)
            handles[place] = (dev, uploads[dev].add(r64), uploads[dev].add(vals))
            self.bytes_shipped += r64.nbytes + vals.nbytes

        def done() -> Dict:
            for place, (dev, h_rows, h_vals) in handles.items():
                cur[place].index_copy_(0, uploads[dev].tensor(h_rows),
                                       uploads[dev].tensor(h_vals))
            return cur

        return done

    def stage(self, snap, uploads) -> Dict[str, Callable[[], Dict]]:
        """Stage a swap of ``snap``'s per-cycle fields into ``uploads`` (one
        :class:`StagedUpload` per distinct device); returns field → what
        yields its placement → tensor dict once the uploads ran."""
        self.version += 1
        self.delta_record = {}
        out = {field: self._refresh(field, np.asarray(getattr(snap, field)), uploads)
               for field in PER_CYCLE_FIELDS}
        self.churn_ewma = (CHURN_EWMA_DECAY * self.churn_ewma
                           + (1.0 - CHURN_EWMA_DECAY) * self._cycle_max)
        self._cycle_max = 0
        new = adaptive_ladder(self.churn_ewma, SHARD_SCATTER_SLOTS)
        if new != self._ladder:
            self._ladder = new
            self.ladder_retargets += 1
        return out


# ==========================================================================
# Warm-started allocate (KB_WARM): the carried candidate table's planner
# ==========================================================================
#
# The compacted solve's [P, W] candidate table stays on the device between
# solves (ops/assignment.py warm_allocate_solve).  Each cycle this host
# planner decides, from what moved since the last solve, which rows are
# re-ranked in full and which node columns get fresh keys merged in:
#
#   node deltas — the swap's delta record (``absorb``) at the node fields
#     the keys read, plus the ingest-static node features (mirror diffs);
#   task deltas — rows new to the bucket, rows whose own features moved,
#     rows with sparse affinity or preference terms (rebuilt every cycle
#     from object state, invisible to both sources above);
#   erosion — the solve's ``eroded`` output re-ranks next cycle.
#
# Any wholesale movement (full upload, version gap, shape or config change)
# makes the plan COLD: every live bucket row re-ranks.

#: changed-node slot rungs of the warm merge's fresh [P, C] block; churn
#: past the top rung makes the plan cold
WARM_CHANGED_BUCKETS: Tuple[int, ...] = (64, 512, 4096)

#: the carried table stores W = K + margin entries, so cut erosion rarely
#: reaches the nominal K before a re-rank catches up
WARM_WIDTH_MARGIN = 16


def warm_rerank_rungs(P: int) -> Tuple[int, ...]:
    """The sub-bucket rungs for a [P] pending bucket: ×2 steps from 128 up
    to P (always ending at P), for the re-rank rung and the merge rung."""
    out = []
    v = min(128, P)
    while v < P:
        out.append(v)
        v = min(v * 2, P)
    out.append(P)
    return tuple(out)


def _rung(n: int, rungs: Tuple[int, ...]) -> int:
    for r in rungs:
        if n <= r:
            return r
    return rungs[-1]


#: consecutive under-rung plans before a ratcheted rung drops back to fit
WARM_RUNG_DECAY = 3


def _ratchet(current: int, needed: int, low_streak: int, floor: int = 0):
    """Sticky rung with hysteresis: grow at once, drop to the needed rung
    after WARM_RUNG_DECAY consecutive plans that needed less.  Returns
    (rung, streak)."""
    if needed >= current:
        return needed, 0
    low_streak += 1
    if low_streak < WARM_RUNG_DECAY:
        return current, low_streak
    return max(needed, floor), 0


class WarmTableState:
    """One device's (or mesh's) carried candidate table and its
    invalidation planner (the JAX package's ``WarmTableState``).  Owned by the ColumnStore (``warm_table_state``) and dropped
    wholesale on axis growth, resident drops (guard heals) and device
    changes, so a table never outlives the index space it was ranked in."""

    #: per-cycle snapshot fields whose row deltas invalidate node keys
    NODE_DELTA_FIELDS = (
        "node_idle", "node_releasing", "node_used", "node_valid",
        "node_sched",
    )

    def __init__(self, device: torch.device, key=None):
        self.device = device
        # the resident cache this state absorbs: its device, or the mesh
        # whose first device holds the table
        self.key = device if key is None else key
        self._reset()
        # lifetime counters
        self.plans = 0
        self.cold_builds = 0
        self.reranked_total = 0
        self.changed_total = 0

    def _reset(self) -> None:
        self.shape_key = None       # (P, W, capN, capT, config)
        self.rows: Optional[np.ndarray] = None
        self.table = None           # (idx, skey, hash, trunc) tensors
        self.eroded_dev = None
        self._changed: Optional[np.ndarray] = None  # bool [capN]
        self._node_full = True
        self._absorbed_version = -1
        self._consumed_version = -1
        self._t_mirror: Optional[Dict[str, np.ndarray]] = None
        self._n_mirror: Optional[Dict[str, np.ndarray]] = None
        self._t_feat_ver = -1
        self._n_feat_ver = -1
        # sticky rungs (the re-rank ratchet never pins the cold rung P; the
        # merge rung decays no lower than the previous bucket's live count,
        # so carried row_map values stay inside the sliced prefix)
        self._c_rung = 0
        self._r_rung = 0
        self._m_rung = 0
        self._c_low = 0
        self._r_low = 0
        self._m_low = 0
        self.last: Dict = {}

    # ------------------------------------------------------------------
    def absorb(self, record: Dict, version: int) -> None:
        """Fold one resident swap's delta record into the pending
        invalidation.  A version the planner already consumed is skipped,
        so a re-notified record is never marked twice."""
        if version <= self._consumed_version:
            return
        for field in self.NODE_DELTA_FIELDS:
            if field not in record:
                continue
            rows = record[field]
            if rows is None:
                self._node_full = True
            elif self._changed is not None:
                if rows.size and rows[-1] < self._changed.shape[0]:
                    self._changed[rows] = True
                else:
                    self._node_full = True  # shape drift: cold
        self._absorbed_version = version

    # ------------------------------------------------------------------
    def _ensure(self, key) -> None:
        if key != self.shape_key:
            self._reset()
            self.shape_key = key

    def _diff_mirror(self, mirror_slot: str, ver_slot: str, version: int,
                     sources) -> np.ndarray:
        """Changed-row mask over the named ingest-static arrays (they carry
        no scatter deltas, so the state keeps its own mirrors).  A shape
        change reads as all-changed; an unmoved feature version skips the
        compare."""
        mirror = getattr(self, mirror_slot)
        n = sources[0][1].shape[0]
        if mirror is not None and getattr(self, ver_slot) == version:
            return np.zeros(n, bool)
        out = np.zeros(n, bool)
        fresh = {}
        for name, arr in sources:
            fresh[name] = arr.copy()
            if mirror is None:
                out[:] = True
                continue
            old = mirror.get(name)
            if old is None or old.shape != arr.shape:
                out[:] = True
                continue
            if arr.ndim == 1:
                out |= old != arr
            else:
                out |= np.any(old != arr, axis=1)
        setattr(self, mirror_slot, fresh)
        setattr(self, ver_slot, version)
        return out

    # ------------------------------------------------------------------
    def plan(self, cols, pend_rows: np.ndarray, k: int,
             config) -> Optional[Dict]:
        """The per-solve invalidation plan, or None when warm cannot run
        this cycle (no resident cache on this device, or a swap this state
        did not absorb: the delta chain is broken).

        Returns {"row_map", "changed", "rerank_rows", "rerank_slots",
        "table", "w", "cold"}: numpy plan arrays, the carried (or freshly
        emptied) table and the stored width.  Reads back the previous
        solve's [P] erosion flags (one small sync)."""
        cache = cols._per_cycle_dev.get(self.key)
        if cache is None or cache.version != self._absorbed_version:
            return None
        P = int(pend_rows.shape[0])
        capN = cols.nodes.cap
        capT = cols.tasks.cap
        W = k + WARM_WIDTH_MARGIN
        key = (P, W, capN, capT, config)
        self._ensure(key)
        self.plans += 1
        if self._changed is None:
            self._changed = np.zeros(capN, bool)

        new_live = pend_rows[pend_rows >= 0]
        # ---- ingest-static feature diffs (no scatter deltas to ride) --
        task_dirty = self._diff_mirror(
            "_t_mirror", "_t_feat_ver", cols.task_feature_version, (
                ("t_init32", cols.t_init32),
                ("t_sel_bits", cols.t_sel_bits),
                ("t_sel_impossible", cols.t_sel_impossible),
                ("t_tol_bits", cols.t_tol_bits),
            ))
        node_feat_dirty = self._diff_mirror(
            "_n_mirror", "_n_feat_ver", cols.node_feature_version, (
                ("n_alloc32", cols.n_alloc32),
                ("n_label_bits", cols.n_label_bits),
                ("n_taint_bits", cols.n_taint_bits),
            ))

        # C rungs past the node capacity would make the fresh block wider
        # than the cold build it replaces: they make the plan cold instead
        c_rungs = tuple(
            r for r in WARM_CHANGED_BUCKETS if r < capN
        ) or (WARM_CHANGED_BUCKETS[0],)
        cold = (
            self.table is None
            or self.rows is None
            or self._node_full
            or bool(node_feat_dirty.all())
        )
        changed_mask = self._changed
        if not cold:
            changed_mask = changed_mask | node_feat_dirty
            n_changed = int(changed_mask.sum())
            if n_changed > min(c_rungs[-1], capN - 1):
                cold = True

        rerank_mask = np.zeros(P, bool)
        n_live = int(new_live.size)
        rungs = warm_rerank_rungs(P)
        # the merge rung: the [M] live prefix the refresh slices to, its
        # decay floor covering the previous bucket's live count
        old_live = (
            int((self.rows >= 0).sum()) if self.rows is not None else 0
        )
        m_need = _rung(max(n_live, old_live, 1), rungs)
        self._m_rung, self._m_low = _ratchet(
            self._m_rung, m_need, self._m_low
        )
        m_rung = self._m_rung
        n_new = n_dirty = n_eroded = 0
        if cold:
            self.cold_builds += 1
            row_map = np.full(m_rung, -1, np.int32)
            rerank_mask[:n_live] = True
            changed = np.full(max(self._c_rung, c_rungs[0]), -1, np.int32)
            n_changed = 0
        else:
            # ---- bucket permutation (old slot per new slot) ----------
            old_live = self.rows[self.rows >= 0]
            pos = np.searchsorted(old_live, new_live)
            safe = np.minimum(pos, max(old_live.size - 1, 0))
            carried = (
                (pos < old_live.size) & (old_live[safe] == new_live)
                if old_live.size else np.zeros(n_live, bool)
            )
            row_map = np.full(m_rung, -1, np.int32)
            row_map[:n_live][carried] = pos[carried].astype(np.int32)
            # ---- the re-rank set -------------------------------------
            rerank_mask[:n_live] = ~carried                 # new rows
            n_new = int(np.sum(~carried))
            rerank_mask[:n_live] |= task_dirty[new_live]    # own features
            n_dirty = int(np.sum(task_dirty[new_live]))
            sparse = cols._aff_rows | cols._pref_rows       # conservative
            if sparse:
                rerank_mask[:n_live] |= np.isin(
                    new_live, np.fromiter(sparse, np.int64)
                )
            if self.eroded_dev is not None:
                # the previous solve's [P] erosion flags, long computed:
                # one small readback per warm plan
                eroded = self.eroded_dev.cpu().numpy()
                er_rows = self.rows[np.flatnonzero(eroded)]
                er_rows = er_rows[er_rows >= 0]
                n_eroded = int(er_rows.size)
                if er_rows.size:
                    # spare-fill: eroded rows re-rank only in the padding
                    # slots of the rung the mandatory set already pays for;
                    # deferred rows stay exact and retry next cycle
                    base = int(rerank_mask.sum())
                    spare = _rung(max(base, 1), warm_rerank_rungs(P)) - base
                    if spare > 0:
                        admit = np.isin(new_live, er_rows)
                        admit &= ~rerank_mask[:n_live]
                        extra = np.flatnonzero(admit)[:spare]
                        rerank_mask[extra] = True
            # changed-node list at its (ratcheted, decaying) rung
            ch_rows = np.flatnonzero(changed_mask)
            n_changed = int(ch_rows.size)
            self._c_rung, self._c_low = _ratchet(
                self._c_rung, _rung(max(n_changed, 1), c_rungs),
                self._c_low, floor=c_rungs[0],
            )
            changed = np.full(self._c_rung, -1, np.int32)
            changed[:n_changed] = ch_rows.astype(np.int32)

        n_rerank = int(rerank_mask.sum())
        rrung = _rung(max(n_rerank, 1), rungs)
        if rrung < P:
            # sub-P rungs ratchet with decay; the cold-sized rung never
            # pins the ratchet
            self._r_rung, self._r_low = _ratchet(
                self._r_rung, rrung, self._r_low, floor=rungs[0]
            )
            rrung = min(self._r_rung, m_rung)
        rerank_slots = np.full(rrung, -1, np.int32)
        slots = np.flatnonzero(rerank_mask)
        rerank_slots[:n_rerank] = slots.astype(np.int32)
        rerank_rows = np.full(rrung, -1, np.int32)
        rerank_rows[:n_rerank] = pend_rows[slots]

        table = self.table
        if table is None:
            table = self._init_table(P, W)
        # plan consumed: clear the accumulators and mark the consumed swap
        # version, so a re-notified record cannot re-mark them
        self._changed = np.zeros(capN, bool)
        self._node_full = False
        self._consumed_version = self._absorbed_version
        self.rows = pend_rows.copy()
        self.reranked_total += n_rerank
        self.changed_total += n_changed
        self.last = {
            "cold": cold, "reranked": n_rerank, "changed": n_changed,
            "bucket_live": n_live, "w": W,
            # re-rank attribution: rows new to the bucket, rows whose own
            # features moved, eroded rows
            "new": n_new, "dirty": n_dirty, "eroded": n_eroded,
        }
        return {
            "row_map": row_map, "changed": changed,
            "rerank_rows": rerank_rows, "rerank_slots": rerank_slots,
            "table": table, "w": W, "cold": cold,
        }

    def _init_table(self, P: int, W: int):
        """An empty [P, W] table on this state's device."""
        dev = self.device
        return (torch.zeros((P, W), dtype=torch.int32, device=dev),
                torch.full((P, W), -(2 ** 31), dtype=torch.int32, device=dev),
                torch.full((P, W), -1, dtype=torch.int32, device=dev),
                torch.zeros(P, dtype=torch.bool, device=dev))

    def commit(self, table, eroded) -> None:
        """Adopt the refreshed table and erosion flags the solve returned."""
        self.table = table
        self.eroded_dev = eroded

    def drop(self) -> None:
        """Abandon the carry (the next plan is cold): the dispatch calls
        this when a warm solve raises between plan() and commit(), since
        plan() already consumed the invalidation accumulators."""
        self._reset()

    def counters(self) -> Dict:
        return {
            "plans": self.plans,
            "cold_builds": self.cold_builds,
            "reranked_total": self.reranked_total,
            "changed_total": self.changed_total,
            "last": dict(self.last),
        }
