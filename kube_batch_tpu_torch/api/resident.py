"""Per-cycle device-resident snapshot columns, refreshed by row scatters.

Mirrors ``kube_batch_tpu/api/resident.py`` (its single-device half).  The
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
