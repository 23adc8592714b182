"""ColumnStore — the persistent columnar host model (its host half).

Mirrors ``kube_batch_tpu/api/columns.py``:

- The cache owns one ColumnStore.  Rows are assigned when objects are
  ingested (pods → task rows, jobs → job rows, nodes and queues likewise)
  and freed when they leave; a row is stable for its object's lifetime.
- The object model's ledgers (JobInfo.allocated / total_request /
  pending_request, NodeInfo.idle / used / releasing / allocatable /
  capability) are views into [cap, R] float64 matrices: every in-place
  ``add_`` / ``sub_`` through the object API writes the column, and every
  vectorized column op is seen by the objects.
- Per-job status counts ([capJ, n_statuses] int32) are kept by JobInfo's
  index choke points, so gang readiness, phase derivation and the
  session-open validity gate are matrix expressions.
- TaskInfo.status / .node_name write through to t_status / t_node.

The per-cycle snapshot is then a few casts and derived masks
(``device_snapshot``), returned as numpy arrays in the port's
``DeviceSnapshot`` layout.  Capacities grow in the same buckets the
snapshot pads to, so the row space IS the padded device axis.

Across cycles:

- The session job rows are re-derived at open for the dirty jobs only
  when the open takes the delta path (``sync_session_rows(ssn,
  dirty_uids=...)``); ``j_touched`` marks every row whose close-pass
  inputs may have moved, so the delta close visits only those.
- The node ledgers' float32 twins are refreshed at the rows the ledger
  choke points marked (``node_ledgers32``).
- The device half: ``resident_snap`` hands the device programs tensors
  that stay on the device between cycles — the ingest-static columns
  re-uploaded when their axis's feature version moves
  (``resident_features``), the per-cycle columns refreshed by row
  scatters (``per_cycle_resident``, ``api/resident.py``).  The host-backed
  numpy snapshot stays what the host reads.  ``KB_DEVICE_CACHE=0``
  uploads the whole snapshot on every call instead (the oracle).

The carried candidate tables of the warm-started allocate
(``warm_table_state``, ``api/resident.WarmTableState``) hang off the
store by device; every swap's delta record is fed to them, and they are
dropped on axis growth, resident drops and device changes.

The job-alloc float32 twin (``job_alloc32``) is refreshed like the node
ledgers' twins: at exactly the rows the ``note_job_alloc`` choke points
marked.

The query plane's seams: ``peek_task_rows`` (the rows the next pods would
occupy: the what-if probe's tie-hash rows) and ``resident_swap_guard``
(a context-manager factory that every swap's writes run inside: the
query plane's ``LeaseBroker.swap_guard``, which waits out in-flight
probes and retires the lease whose tensors the swap rewrites).
``revalidate_resident`` is the leader failover's keep-or-drop check on
the surviving residency.  On the sharded path the residency is keyed by
the mesh (``resident_snap(cols, snap, mesh)``): node columns per node
shard, the rest per distinct device
(``api/resident.ShardedPerCycleDeviceCache``).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from kube_batch_tpu_torch.api.resources import ResourceSpec
from kube_batch_tpu_torch.api.snapshot import (
    BITS,
    HARD_TAINT_EFFECTS,
    UNBOUNDED,
    DeviceSnapshot,
    SnapshotMeta,
    _pack_bits,
    _TaintView,
    bucket,
)
from kube_batch_tpu_torch.api.types import (
    CRITICAL_NAMESPACE,
    CRITICAL_PRIORITY_CLASSES,
    PodGroupPhase,
    TaskStatus,
)
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.utils.switches import switch_on

logger = logging.getLogger("kube_batch_tpu_torch")

N_STATUS = len(TaskStatus)
# columns summed for gang readiness (job_info.go:367-380 ReadyTaskNum)
READY_STATUSES = (
    int(TaskStatus.BOUND), int(TaskStatus.BINDING), int(TaskStatus.RUNNING),
    int(TaskStatus.ALLOCATED), int(TaskStatus.SUCCEEDED),
)
# ValidTaskNum statuses (job_info.go:394-409)
VALID_STATUSES = READY_STATUSES + (
    int(TaskStatus.PENDING), int(TaskStatus.PIPELINED),
)

# PodGroup phase ↔ int code for the j_phase column (−1 = no phase yet)
PHASE_CODE: Dict[PodGroupPhase, int] = {p: i for i, p in enumerate(PodGroupPhase)}
CODE_PHASE: List[PodGroupPhase] = list(PodGroupPhase)
N_PHASES = len(CODE_PHASE)


def _path_name(key) -> str:
    """A residency key's path name: "sharded" for a mesh, else "single"."""
    from kube_batch_tpu_torch.parallel.mesh import Mesh

    return "sharded" if isinstance(key, Mesh) else "single"


def resident_snap(cols, snap, device):
    """The device snapshot a device program reads: resident tensors when a
    ColumnStore backs the session and ``KB_DEVICE_CACHE`` is on (the
    ingest-static features by version, the per-cycle columns by scatter),
    else (``KB_DEVICE_CACHE=0``) a full upload of ``snap``.  ``snap`` stays the host's copy; only
    the returned tensors feed the solve.  A repeat call with the same
    ``snap`` object returns the same tensors.

    ``device`` may be a mesh (``parallel/mesh.Mesh``): the result is then
    a ``ShardedSnapshot`` whose residency is keyed by the mesh, as the JAX
    package keys it (``_sharded_resident_snap``)."""
    from kube_batch_tpu_torch.api.convert import host_field, snapshot_from_numpy
    from kube_batch_tpu_torch.api.resident import StagedUpload
    from kube_batch_tpu_torch.parallel.mesh import Mesh

    if isinstance(device, Mesh):
        return _sharded_resident_snap(cols, snap, device)
    dev = resolve_device(device)
    if cols is None:
        return snapshot_from_numpy(snap, dev)
    if not switch_on("KB_DEVICE_CACHE"):
        # nothing stays resident, and a residency left from before the
        # switch moved would pair stale mirrors (and warm tables) with
        # swaps they never saw
        if cols._per_cycle_dev or cols._warm_tables:
            cols.drop_resident()
        return snapshot_from_numpy(snap, dev)
    cache = cols.per_cycle_cache(dev)
    out = cache.memo(snap)
    if out is not None:
        return out
    guard = cols.resident_swap_guard
    with guard() if guard is not None else contextlib.nullcontext():
        # the swap rewrites resident tensors in place (the scatters, the
        # full uploads and the memo), so a query plane's guard parks its
        # probes and retires the lease that holds them for its duration
        upload = StagedUpload(dev)
        made = cols.resident_features(snap, upload)
        made.update(cols.per_cycle_resident(snap, upload))
        for name in DeviceSnapshot._fields:
            if name not in made:
                handle = upload.add(host_field(name, getattr(snap, name)))
                made[name] = lambda h=handle: upload.tensor(h)
        try:
            upload.run()
            out = DeviceSnapshot(**{name: made[name]() for name in DeviceSnapshot._fields})
        except BaseException:
            # the mirrors already describe this swap: after a failed transfer
            # or scatter the next swap must start cold, not trust them
            cols.drop_resident()
            raise
        cache.remember(snap, out)
    # this swap's row-exact delta record feeds the warm-table carry (the
    # memoized repeat above never re-notifies it)
    st = cols._warm_tables.get(dev)
    if st is not None:
        st.absorb(cache.delta_record, cache.version)
    if cols.on_swap is not None:
        cols.on_swap(snap, out)
    return out


def _sharded_resident_snap(cols, snap, mesh):
    """:func:`resident_snap` on a mesh: the ingest-static features per
    placement by version, the per-cycle columns through the mesh's
    ``ShardedPerCycleDeviceCache``, the rest uploaded per placement; one
    staged transfer per distinct device.  Returns a ``ShardedSnapshot``."""
    from kube_batch_tpu_torch.api.convert import host_field
    from kube_batch_tpu_torch.api.resident import StagedUpload
    from kube_batch_tpu_torch.parallel.mesh import (
        NODE1_FIELDS, NODE_FIELDS, ShardedSnapshot, node_slice, place_snapshot,
    )

    if cols is None:
        return place_snapshot(snap, mesh)
    if not switch_on("KB_DEVICE_CACHE"):
        if cols._per_cycle_dev or cols._warm_tables:
            cols.drop_resident()
        return place_snapshot(snap, mesh)
    cache = cols.per_cycle_cache(mesh)
    out = cache.memo(snap)
    if out is not None:
        return out
    ns = mesh.node_shards
    guard = cols.resident_swap_guard
    with guard() if guard is not None else contextlib.nullcontext():
        uploads = {d: StagedUpload(d) for d in cache.devices}
        made = cols.resident_features_sharded(uploads, mesh)
        made.update(cache.stage(snap, uploads))
        for name in DeviceSnapshot._fields:
            if name in made:
                continue
            host = host_field(name, getattr(snap, name))
            if name in NODE1_FIELDS:
                handles = {(d, j): (d, uploads[d].add(node_slice(name, host, j, ns)))
                           for d, j in cache.node_places}
            else:
                handles = {d: (d, uploads[d].add(host)) for d in cache.devices}
            made[name] = lambda hs=handles: {p: uploads[d].tensor(h).clone()
                                             for p, (d, h) in hs.items()}
        try:
            for up in uploads.values():
                up.run()
            placed = {name: made[name]() for name in DeviceSnapshot._fields}
        except BaseException:
            cols.drop_resident()
            raise
        shards = []
        for (i, j) in mesh.positions():
            if not mesh.is_local(i, j):
                shards.append(None)
                continue
            d = mesh.device(i, j)
            shards.append(DeviceSnapshot(**{
                name: placed[name][(d, j) if name in NODE_FIELDS or name in NODE1_FIELDS else d]
                for name in DeviceSnapshot._fields}))
        out = ShardedSnapshot(mesh, shards)
        cache.remember(snap, out)
    for key, st in cols._warm_tables.items():
        if isinstance(key, tuple) and key[0] == mesh:
            st.absorb(cache.delta_record, cache.version)
    if cols.on_swap is not None:
        cols.on_swap(snap, out)
    return out


def _grow(arr: np.ndarray, cap: int) -> np.ndarray:
    new = np.zeros((cap,) + arr.shape[1:], arr.dtype)
    new[: arr.shape[0]] = arr
    return new


def _grow_width(arr: np.ndarray, words: int) -> np.ndarray:
    new = np.zeros((arr.shape[0], words), arr.dtype)
    new[:, : arr.shape[1]] = arr
    return new


class _Axis:
    """Row allocator: stable rows and a LIFO free list, capacities in the
    snapshot's shape buckets."""

    def __init__(self, floor: int = 8):
        self.cap = bucket(0, floor)
        self._free: List[int] = list(range(self.cap - 1, -1, -1))

    def alloc(self) -> Optional[int]:
        """Next free row, or None when the axis must grow first."""
        if not self._free:
            return None
        return self._free.pop()

    def grown_cap(self) -> int:
        return bucket(self.cap + 1)

    def on_grown(self, new_cap: int) -> None:
        self._free.extend(range(new_cap - 1, self.cap - 1, -1))
        self.cap = new_cap

    def free(self, row: int) -> None:
        self._free.append(row)

    def peek(self, k: int) -> List[int]:
        """The rows the next k ``alloc()`` calls would hand out, without
        changing the allocator: the free list pops from its end, and once
        it runs out the axis grows and hands out rows ascending from the
        old capacity."""
        out: List[int] = []
        i = len(self._free) - 1
        grown = self.cap
        for _ in range(k):
            if i >= 0:
                out.append(self._free[i])
                i -= 1
            else:
                out.append(grown)
                grown += 1
        return out


class ColumnStore:
    def __init__(self, spec: ResourceSpec):
        self.spec = spec
        R = spec.n
        self.R = R

        # ---- task axis --------------------------------------------------
        self.tasks = _Axis()
        capT = self.tasks.cap
        self.t_init32 = np.zeros((capT, R), np.float32)   # InitResreq
        self.t_res32 = np.zeros((capT, R), np.float32)    # Resreq
        self.t_resreq64 = np.zeros((capT, R), np.float64)  # exact ledger rows
        self.t_job = np.zeros(capT, np.int32)
        self.t_prio = np.zeros(capT, np.int32)
        self.t_creation = np.zeros(capT, np.int32)
        self.t_status = np.zeros(capT, np.int32)
        self.t_node = np.full(capT, -1, np.int32)
        self.t_valid = np.zeros(capT, bool)
        self.t_best_effort = np.zeros(capT, bool)
        self.t_critical = np.zeros(capT, bool)
        self.t_needs_host = np.zeros(capT, bool)
        self.t_sel_bits = np.zeros((capT, 1), np.uint32)
        self.t_sel_impossible = np.zeros(capT, bool)
        self.t_tol_bits = np.zeros((capT, 1), np.uint32)
        self.task_by_row: List = [None] * capT
        # sparse feature registries: rows whose pods carry selectors /
        # tolerations / required pod-(anti)affinity / preferred terms / ports
        self._sel_rows: Set[int] = set()
        self._tol_rows: Set[int] = set()
        self._aff_rows: Set[int] = set()
        self._pref_rows: Set[int] = set()
        self._ported_rows: Set[int] = set()

        # ---- job axis ---------------------------------------------------
        self.jobs = _Axis()
        capJ = self.jobs.cap
        self.j_alloc = np.zeros((capJ, R), np.float64)
        self.j_total = np.zeros((capJ, R), np.float64)
        self.j_pend = np.zeros((capJ, R), np.float64)
        # float32 twin of j_alloc, refreshed at the rows the choke points
        # marked (JobInfo's allocated add_ / sub_, the columnar replay's
        # vectorized +=, row bind / free / growth)
        self.j_alloc32 = np.zeros((capJ, R), np.float32)
        self._j_alloc_dirty = np.ones(capJ, bool)
        self.j_counts = np.zeros((capJ, N_STATUS), np.int32)
        self.job_by_row: List = [None] * capJ
        # session rows, re-derived at every session open (sync_session_rows)
        self.j_min = np.zeros(capJ, np.int32)
        self.j_queue = np.zeros(capJ, np.int32)
        self.j_prio = np.zeros(capJ, np.int32)
        self.j_creation = np.zeros(capJ, np.int32)
        self.j_sess = np.zeros(capJ, bool)
        self.j_sched = np.zeros(capJ, bool)
        # PodGroup metadata rows read by the close-session status pass
        self.j_has_pg = np.zeros(capJ, bool)
        self.j_shadow = np.zeros(capJ, bool)
        self.j_pdb = np.zeros(capJ, bool)
        self.j_phase = np.full(capJ, -1, np.int8)   # PHASE_CODE, -1 = none
        # the PodGroup's MinResources as an f32 row (the enqueue gate's
        # input), kept at PodGroup ingest; j_has_minres tells an empty
        # MinResources (budgeted, zero) from none (promoted unconditionally)
        self.j_has_minres = np.zeros(capJ, bool)
        self.j_minres = np.zeros((capJ, R), np.float32)
        self.j_has_conds = np.zeros(capJ, bool)
        # rows whose close-pass inputs may have moved since the last status
        # pass: every j_counts write, the session row sync and mid-cycle
        # phase / condition writes stamp it; the delta close visits these
        # rows (plus the standing need-record set) and clears it
        self.j_touched = np.zeros(capJ, bool)

        # ---- node axis --------------------------------------------------
        self.nodes = _Axis()
        capN = self.nodes.cap
        self.n_idle = np.zeros((capN, R), np.float64)
        self.n_rel = np.zeros((capN, R), np.float64)
        self.n_used = np.zeros((capN, R), np.float64)
        self.n_alloc = np.zeros((capN, R), np.float64)
        self.n_cap = np.zeros((capN, R), np.float64)
        # float32 twins of the ledgers, refreshed at the rows the ledger
        # choke points marked (NodeInfo's task algebra and set_node, the
        # allocate replay's matrix updates, bind / free)
        self.n_idle32 = np.zeros((capN, R), np.float32)
        self.n_rel32 = np.zeros((capN, R), np.float32)
        self.n_used32 = np.zeros((capN, R), np.float32)
        self.n_alloc32 = np.zeros((capN, R), np.float32)
        self._node_ledger_dirty = np.ones(capN, bool)
        self.n_valid = np.zeros(capN, bool)   # Ready
        self.n_sched = np.zeros(capN, bool)   # not Unschedulable
        self.n_label_bits = np.zeros((capN, 1), np.uint32)
        self.n_taint_bits = np.zeros((capN, 1), np.uint32)
        self.node_by_row: List = [None] * capN
        self.node_rows: Dict[str, int] = {}   # name → row
        self.node_names: List[str] = [""] * capN

        # ---- queue axis -------------------------------------------------
        self.queues = _Axis()
        capQ = self.queues.cap
        self.q_weight = np.ones(capQ, np.float32)
        self.q_cap = np.full((capQ, R), UNBOUNDED, np.float32)
        self.q_valid = np.zeros(capQ, bool)
        self.queue_by_row: List = [None] * capQ
        self.queue_rows: Dict[str, int] = {}
        self.queue_names: List[str] = [""] * capQ

        # ---- label / taint interning (monotone tables) ------------------
        self.label_pair_bit: Dict[tuple, int] = {}
        self.taint_bit: Dict[tuple, int] = {}
        # set when the label/taint universe grew: the next device_snapshot
        # re-packs the sparse task rows
        self._task_bits_dirty = False

        # ---- device residency ---------------------------------------------
        # the ingest-static columns (FEATURE_FIELDS) change only where these
        # per-axis versions are bumped; resident_features re-uploads a
        # column only when its version moved
        self.task_feature_version = 0
        self.node_feature_version = 0
        self._dev_cache: Dict = {}
        # the per-cycle resident cache (api/resident.py) by device; at most
        # one is kept
        self._per_cycle_dev: Dict = {}
        # warm-started allocate (KB_WARM): the carried candidate table's
        # state by device (api/resident.WarmTableState), dropped wholesale
        # on axis growth, resident drops and device changes
        self._warm_tables: Dict = {}
        # called as on_swap(snap, tensors) after every swap that was not a
        # repeat (drives use it to check the tensors against a full upload)
        self.on_swap = None
        # the query plane's seam (serve/lease.LeaseBroker.swap_guard): a
        # context-manager factory every swap's writes run inside; None (no
        # plane attached) costs the swap nothing
        self.resident_swap_guard = None
        # which path the most recent session row sync took
        self.last_snapshot_path = "full"

    # ==================================================================
    # task axis
    # ==================================================================
    def bind_task(self, task, job) -> None:
        """Assign a row and fill the static columns (after job.add_task;
        ``job`` must already be bound)."""
        row = self.tasks.alloc()
        if row is None:
            self._grow_tasks()
            row = self.tasks.alloc()
        pod = task.pod
        self.t_init32[row] = task.init_resreq.vec
        self.t_res32[row] = task.resreq.vec
        self.t_resreq64[row] = task.resreq.vec
        self.t_job[row] = job._row
        self.t_prio[row] = task.priority
        self.t_creation[row] = pod.creation_index
        self.t_status[row] = int(task.status)
        self.t_node[row] = (self.node_rows.get(task.node_name, -1)
                            if task.node_name is not None else -1)
        self.t_valid[row] = True
        self.t_best_effort[row] = task.best_effort
        self.t_critical[row] = (pod.priority_class in CRITICAL_PRIORITY_CLASSES
                                or task.namespace == CRITICAL_NAMESPACE)
        self.t_needs_host[row] = task.needs_host_predicate
        if pod.node_selector or pod.affinity is not None:
            self._sel_rows.add(row)
            self._fill_sel_bits(row, task)
        if pod.tolerations:
            self._tol_rows.add(row)
            self._fill_tol_bits(row, task)
        if pod.affinity is not None:
            if pod.affinity.pod_affinity or pod.affinity.pod_anti_affinity:
                self._aff_rows.add(row)
            if pod.affinity.has_preferences():
                self._pref_rows.add(row)
        if pod.host_ports:
            self._ported_rows.add(row)
        self.task_by_row[row] = task
        # bind last: the status/node_name setters skip the store until both
        # row and store are attached; job.add_task already counted the task
        task._row = row
        task._store = self
        self.task_feature_version += 1

    def free_task(self, task) -> None:
        row = task._row
        if row < 0 or task._store is not self:
            return
        task._store = None
        task._row = -1
        self.t_valid[row] = False
        self.t_status[row] = 0
        self.t_node[row] = -1
        self.t_best_effort[row] = False
        if row in self._sel_rows:
            self._sel_rows.discard(row)
            self.t_sel_bits[row] = 0
            self.t_sel_impossible[row] = False
        if row in self._tol_rows:
            self._tol_rows.discard(row)
            self.t_tol_bits[row] = 0
        self._aff_rows.discard(row)
        self._pref_rows.discard(row)
        self._ported_rows.discard(row)
        self.task_by_row[row] = None
        self.tasks.free(row)
        self.task_feature_version += 1

    def _grow_tasks(self) -> None:
        cap = self.tasks.grown_cap()
        for name in ("t_init32", "t_res32", "t_resreq64", "t_job", "t_prio",
                     "t_creation", "t_status", "t_valid", "t_best_effort",
                     "t_critical", "t_needs_host", "t_sel_bits",
                     "t_sel_impossible", "t_tol_bits"):
            setattr(self, name, _grow(getattr(self, name), cap))
        tn = np.full(cap, -1, np.int32)
        tn[: self.t_node.shape[0]] = self.t_node
        self.t_node = tn
        self.task_by_row.extend([None] * (cap - self.tasks.cap))
        self.tasks.on_grown(cap)
        # the bucket rung moves with the task axis: drop the carried
        # tables rather than index-shift them
        self.drop_warm_tables()

    def _fill_sel_bits(self, row: int, task) -> None:
        """Required label pairs → bits (the device predicate's sound
        over-approximation: node selectors plus a single required
        node-affinity term's single-value In requirements)."""
        pod = task.pod
        required_pairs = list(pod.node_selector.items()) if pod.node_selector else []
        aff = pod.affinity
        if aff is not None and len(aff.node_terms) == 1:
            required_pairs += [(key, values[0])
                               for key, op, values in aff.node_terms[0]
                               if op == "In" and len(values) == 1]
        bits: List[int] = []
        impossible = False
        for kv in required_pairs:
            b = self.label_pair_bit.get(kv)
            if b is None:
                impossible = True  # no node carries this pair (yet)
            else:
                bits.append(b)
        self.t_sel_bits[row] = _pack_bits(bits, self.t_sel_bits.shape[1])
        self.t_sel_impossible[row] = impossible

    def _fill_tol_bits(self, row: int, task) -> None:
        tols = task.pod.tolerations
        bits = [bit for (tk, tv, te), bit in self.taint_bit.items()
                if any(tol.tolerates(_TaintView(tk, tv, te)) for tol in tols)]
        self.t_tol_bits[row] = _pack_bits(bits, self.t_tol_bits.shape[1])

    def task_node_changed(self, row: int, node_name) -> None:
        self.t_node[row] = (self.node_rows.get(node_name, -1)
                            if node_name is not None else -1)

    # ==================================================================
    # job axis
    # ==================================================================
    def bind_job(self, job) -> None:
        row = self.jobs.alloc()
        if row is None:
            self._grow_jobs()
            row = self.jobs.alloc()
        # copy the ledgers into the rows, then rebind the job's Resources as
        # zero-copy views of them
        self.j_alloc[row] = job.allocated.vec
        self._j_alloc_dirty[row] = True
        self.j_total[row] = job.total_request.vec
        self.j_pend[row] = job.pending_request.vec
        job.allocated.vec = self.j_alloc[row]
        job.total_request.vec = self.j_total[row]
        job.pending_request.vec = self.j_pend[row]
        counts = self.j_counts[row]
        counts[:] = 0
        for status, bucket_ in job.task_status_index.items():
            counts[int(status)] = len(bucket_)
        self.job_by_row[row] = job
        job._row = row
        job._cols = self
        self.j_touched[row] = True

    def free_job(self, job) -> None:
        row = job._row
        if row < 0 or job._cols is not self:
            return
        job._cols = None
        job._row = -1
        # session-row state must not leak onto the row's next tenant
        self.j_sess[row] = False
        self.j_sched[row] = False
        self.j_has_pg[row] = False
        self.j_shadow[row] = False
        self.j_pdb[row] = False
        self.j_phase[row] = -1
        self.j_has_minres[row] = False
        self.j_minres[row] = 0.0
        self.j_has_conds[row] = False
        self.j_touched[row] = True
        # give the job private buffers (copies of its final state)
        job.allocated.vec = self.j_alloc[row].copy()
        job.total_request.vec = self.j_total[row].copy()
        job.pending_request.vec = self.j_pend[row].copy()
        self.j_alloc[row] = 0.0
        self._j_alloc_dirty[row] = True
        self.j_total[row] = 0.0
        self.j_pend[row] = 0.0
        self.j_counts[row] = 0
        self.job_by_row[row] = None
        self.jobs.free(row)

    def sync_job_minres(self, job) -> None:
        """The job's MinResources row from its PodGroup (at PodGroup add,
        update and delete).  ``is None``, not truthiness: an empty dict is
        a budgeted zero request (enqueue.go:102-105)."""
        row = job._row
        if row < 0 or job._cols is not self:
            return
        mr = job.pod_group.min_resources if job.pod_group is not None else None
        self.j_has_minres[row] = mr is not None
        self.j_minres[row] = self._minres_vec(mr)

    def _minres_vec(self, mr) -> np.ndarray:
        vec = np.zeros(self.R, np.float32)
        for name, v in (mr or {}).items():
            if name in self.spec:
                vec[self.spec.index(name)] = float(v)
        return vec

    def _grow_jobs(self) -> None:
        cap = self.jobs.grown_cap()
        for name in ("j_alloc", "j_alloc32", "j_total", "j_pend", "j_counts",
                     "j_min", "j_queue", "j_prio", "j_creation", "j_sess",
                     "j_sched", "j_has_pg", "j_shadow", "j_pdb", "j_has_minres",
                     "j_minres", "j_has_conds", "j_touched"):
            setattr(self, name, _grow(getattr(self, name), cap))
        dirty = np.ones(cap, bool)  # grown rows refresh on first read
        dirty[: self._j_alloc_dirty.shape[0]] = self._j_alloc_dirty
        self._j_alloc_dirty = dirty
        j_phase = np.full(cap, -1, np.int8)
        j_phase[: self.j_phase.shape[0]] = self.j_phase
        self.j_phase = j_phase
        self.job_by_row.extend([None] * (cap - self.jobs.cap))
        self.jobs.on_grown(cap)
        # rebind every bound job's ledger views onto the new buffers
        for row, job in enumerate(self.job_by_row):
            if job is not None:
                job.allocated.vec = self.j_alloc[row]
                job.total_request.vec = self.j_total[row]
                job.pending_request.vec = self.j_pend[row]

    # ==================================================================
    # node axis
    # ==================================================================
    def bind_node(self, node) -> None:
        row = self.nodes.alloc()
        if row is None:
            self._grow_nodes()
            row = self.nodes.alloc()
        self.node_by_row[row] = node
        self.node_rows[node.name] = row
        self.node_names[row] = node.name
        node._row = row
        node._cols = self
        self.n_idle[row] = node.idle.vec
        self.n_rel[row] = node.releasing.vec
        self.n_used[row] = node.used.vec
        self.n_alloc[row] = node.allocatable.vec
        self.n_cap[row] = node.capability.vec
        node.idle.vec = self.n_idle[row]
        node.releasing.vec = self.n_rel[row]
        node.used.vec = self.n_used[row]
        node.allocatable.vec = self.n_alloc[row]
        node.capability.vec = self.n_cap[row]
        self.node_feature_version += 1  # fresh n_alloc and bit rows on this row
        self._node_ledger_dirty[row] = True
        self.sync_node_meta(node)
        # resident tasks bound before their node resolve to -1; repoint them
        for t in node.tasks.values():
            if t._row >= 0 and t._store is self:
                self.t_node[t._row] = row

    def free_node(self, node) -> None:
        row = node._row
        if row < 0 or node._cols is not self:
            return
        node._cols = None
        node._row = -1
        node.idle.vec = self.n_idle[row].copy()
        node.releasing.vec = self.n_rel[row].copy()
        node.used.vec = self.n_used[row].copy()
        node.allocatable.vec = self.n_alloc[row].copy()
        node.capability.vec = self.n_cap[row].copy()
        for arr in (self.n_idle, self.n_rel, self.n_used, self.n_alloc, self.n_cap):
            arr[row] = 0.0
        self._node_ledger_dirty[row] = True
        self.n_valid[row] = False
        self.n_sched[row] = False
        self.n_label_bits[row] = 0
        self.n_taint_bits[row] = 0
        self.node_by_row[row] = None
        self.node_rows.pop(node.name, None)
        self.node_names[row] = ""
        # tasks still pointing at the freed row must not alias its next tenant
        self.t_node[self.t_node == row] = -1
        self.nodes.free(row)
        self.node_feature_version += 1

    def _grow_nodes(self) -> None:
        cap = self.nodes.grown_cap()
        for name in ("n_idle", "n_rel", "n_used", "n_alloc", "n_cap",
                     "n_valid", "n_sched", "n_label_bits", "n_taint_bits",
                     "n_idle32", "n_rel32", "n_used32", "n_alloc32"):
            setattr(self, name, _grow(getattr(self, name), cap))
        dirty = np.ones(cap, bool)
        dirty[: self._node_ledger_dirty.shape[0]] = self._node_ledger_dirty
        self._node_ledger_dirty = dirty
        self.node_by_row.extend([None] * (cap - self.nodes.cap))
        self.node_names.extend([""] * (cap - self.nodes.cap))
        self.nodes.on_grown(cap)
        # the node index space the carried tables rank over grew
        self.drop_warm_tables()
        for row, node in enumerate(self.node_by_row):
            if node is not None:
                node.idle.vec = self.n_idle[row]
                node.releasing.vec = self.n_rel[row]
                node.used.vec = self.n_used[row]
                node.allocatable.vec = self.n_alloc[row]
                node.capability.vec = self.n_cap[row]

    def sync_node_meta(self, node) -> None:
        """Refresh validity / schedulability / label and taint bits after
        set_node (or bind).  New label pairs and taints are interned; a
        grown universe marks the task bitsets for re-packing.  The node
        feature version moves only when a bit row actually changed, so a
        heartbeat with unchanged content keeps the resident columns."""
        row = node._row
        self.n_valid[row] = node.ready
        obj = node.node
        self.n_sched[row] = obj is not None and not obj.unschedulable
        if obj is None:
            return
        before_labels = len(self.label_pair_bit)
        before_taints = len(self.taint_bit)
        for kv in obj.labels.items():
            self.label_pair_bit.setdefault(kv, len(self.label_pair_bit))
        for t in obj.taints:
            if t.effect in HARD_TAINT_EFFECTS:
                self.taint_bit.setdefault((t.key, t.value, t.effect),
                                          len(self.taint_bit))
        W = max(1, -(-len(self.label_pair_bit) // BITS))
        Wt = max(1, -(-len(self.taint_bit) // BITS))
        if W > self.n_label_bits.shape[1]:
            self.n_label_bits = _grow_width(self.n_label_bits, W)
            self.t_sel_bits = _grow_width(self.t_sel_bits, W)
        if Wt > self.n_taint_bits.shape[1]:
            self.n_taint_bits = _grow_width(self.n_taint_bits, Wt)
            self.t_tol_bits = _grow_width(self.t_tol_bits, Wt)
        if (len(self.label_pair_bit) != before_labels
                or len(self.taint_bit) != before_taints):
            self._task_bits_dirty = True
        label_row = _pack_bits(
            [self.label_pair_bit[kv] for kv in obj.labels.items()],
            self.n_label_bits.shape[1])
        taint_row = _pack_bits(
            [self.taint_bit[(t.key, t.value, t.effect)]
             for t in obj.taints if t.effect in HARD_TAINT_EFFECTS],
            self.n_taint_bits.shape[1])
        if not (np.array_equal(self.n_label_bits[row], label_row)
                and np.array_equal(self.n_taint_bits[row], taint_row)):
            self.node_feature_version += 1
        self.n_label_bits[row] = label_row
        self.n_taint_bits[row] = taint_row

    # ==================================================================
    # queue axis
    # ==================================================================
    def bind_queue(self, qinfo) -> None:
        existing = self.queue_rows.get(qinfo.name)
        if existing is not None:
            row = existing
            old = self.queue_by_row[row]
            if old is not None and old is not qinfo:
                old._row, old._cols = -1, None
        else:
            row = self.queues.alloc()
            if row is None:
                self._grow_queues()
                row = self.queues.alloc()
            self.queue_rows[qinfo.name] = row
            self.queue_names[row] = qinfo.name
        self.queue_by_row[row] = qinfo
        qinfo._row = row
        qinfo._cols = self
        self.q_weight[row] = qinfo.weight
        self.q_valid[row] = True
        if qinfo.queue.capability:
            # dims a capability dict does not name are capped at 0; only a
            # cap-less queue is UNBOUNDED
            cap = np.zeros(self.R, np.float32)
            for name, v in qinfo.queue.capability.items():
                if name in self.spec:
                    cap[self.spec.index(name)] = v
        else:
            cap = np.full(self.R, UNBOUNDED, np.float32)
        self.q_cap[row] = cap

    def free_queue(self, name: str) -> None:
        row = self.queue_rows.pop(name, None)
        if row is None:
            return
        q = self.queue_by_row[row]
        if q is not None:
            q._row, q._cols = -1, None
        self.queue_by_row[row] = None
        self.q_valid[row] = False
        self.q_weight[row] = 1.0
        self.q_cap[row] = UNBOUNDED
        self.queue_names[row] = ""
        self.queues.free(row)

    def _grow_queues(self) -> None:
        cap = self.queues.grown_cap()
        q_weight = np.ones(cap, np.float32)
        q_weight[: self.queues.cap] = self.q_weight
        self.q_weight = q_weight
        q_cap = np.full((cap, self.R), UNBOUNDED, np.float32)
        q_cap[: self.queues.cap] = self.q_cap
        self.q_cap = q_cap
        self.q_valid = _grow(self.q_valid, cap)
        self.queue_by_row.extend([None] * (cap - self.queues.cap))
        self.queue_names.extend([""] * (cap - self.queues.cap))
        self.queues.on_grown(cap)

    # ==================================================================
    # capacity reservation
    # ==================================================================
    def reserve(self, n_tasks: int = 0, n_nodes: int = 0, n_jobs: int = 0,
                n_queues: int = 0) -> None:
        """Pre-grow the axes to an expected peak, so a wobbling workload
        stays in one shape bucket (and the resident columns keep their
        shapes).  Capacity never shrinks."""
        while self.tasks.cap < n_tasks:
            self._grow_tasks()
        while self.nodes.cap < n_nodes:
            self._grow_nodes()
        while self.jobs.cap < n_jobs:
            self._grow_jobs()
        while self.queues.cap < n_queues:
            self._grow_queues()

    # ==================================================================
    # per-session job-row sync (delta or full)
    # ==================================================================
    def _sync_job_row(self, job, queue_rows_get) -> None:
        """Derive one session job's row state (both sync forms run it)."""
        row = job._row
        if row < 0 or job._cols is not self:
            return  # a foreign or unbound job (an isolated session's clone)
        self.j_touched[row] = True  # re-synced: the close pass must visit
        qi = queue_rows_get(job.queue, -1)
        if qi < 0:
            self.j_sess[row] = False
            return
        self.j_sess[row] = True
        self.j_min[row] = job.min_available
        self.j_queue[row] = qi
        self.j_prio[row] = job.priority
        self.j_creation[row] = job.creation_index
        pg = job.pod_group
        self.j_sched[row] = pg is None or pg.phase != PodGroupPhase.PENDING
        self.j_has_pg[row] = pg is not None
        self.j_pdb[row] = job.pdb is not None
        if pg is None:
            self.j_shadow[row] = False
            self.j_phase[row] = -1
            self.j_has_conds[row] = False
            return
        self.j_shadow[row] = pg.shadow
        self.j_phase[row] = PHASE_CODE[pg.phase] if pg.phase is not None else -1
        self.j_has_conds[row] = bool(pg.conditions)

    def sync_session_rows(self, ssn, dirty_uids=None, restore_rows=()) -> None:
        """Fill the session-scoped job rows (j_sess membership, j_min,
        j_queue, j_prio, j_creation, j_sched and the PodGroup metadata).

        ``dirty_uids=None`` is the full rescan, one pass over every session
        job.  A set re-derives only those uids: rows of jobs that left the
        session clear, dirty members re-fill, and every other row keeps
        last cycle's values, which are still exact because each input
        moves only through choke points that stamp the dirty set.
        ``restore_rows`` re-admits the rows the previous gate dropped; this
        cycle's gate re-votes on them right after."""
        queue_rows_get = self.queue_rows.get
        if dirty_uids is None:
            self.last_snapshot_path = "full"
            self.j_sess[:] = False
            self.j_sched[:] = False
            for job in ssn.jobs.values():
                self._sync_job_row(job, queue_rows_get)
            return
        self.last_snapshot_path = "delta"
        jobs_get = ssn.jobs.get
        job_by_row = self.job_by_row
        for row in restore_rows:
            job = job_by_row[row]
            if job is not None and jobs_get(job.uid) is job:
                self.j_sess[row] = True
        cache_jobs_get = ssn.cache.jobs.get
        for uid in dirty_uids:
            job = jobs_get(uid)
            if job is None:
                # left the session (deleted, or membership lost): clear the
                # row it may still hold
                job = cache_jobs_get(uid)
                if job is not None and job._cols is self and job._row >= 0:
                    self.j_sess[job._row] = False
                continue
            self._sync_job_row(job, queue_rows_get)

    # ==================================================================
    # per-cycle snapshot
    # ==================================================================
    def schedulable_pending_mask(self) -> np.ndarray:
        """[capT] bool — tasks the allocate solve can act on (Pending, not
        BestEffort, live row): the snapshot's task_pending and the idle
        cycle's skip test are this one mask."""
        return ((self.t_status == int(TaskStatus.PENDING))
                & ~self.t_best_effort & self.t_valid)

    def has_schedulable_pending(self) -> bool:
        return bool(np.any(self.schedulable_pending_mask()))

    def peek_task_rows(self, k: int) -> List[int]:
        """The task rows the next k ingested pods would occupy (nothing
        changes): the what-if probe's tie-hash rows (``ops/probe.py``).
        Exact against a frozen cache; ingest in between shifts the
        allocator, and the probe's answer is then one of the tied nodes."""
        return self.tasks.peek(k)

    def has_running_victims(self) -> bool:
        """Any live task Running on a node — without one the eviction solve
        has no victim and can make no claim."""
        return bool(np.any((self.t_status == int(TaskStatus.RUNNING))
                           & self.t_valid & (self.t_node >= 0)))

    def excluded_node_rows(self, ssn) -> List[int]:
        """Rows of the session's excluded nodes (pressure gates)."""
        if not ssn.session_excluded_nodes:
            return []
        rows_get = self.node_rows.get
        return [r for r in (rows_get(n) for n in ssn.session_excluded_nodes)
                if r is not None]

    def refresh_task_bits(self) -> None:
        """Re-pack the sparse task bitsets after the label/taint universe
        grew (a new pair can un-impossible a selector; a new taint needs a
        toleration verdict)."""
        if not self._task_bits_dirty:
            return
        self._task_bits_dirty = False
        self.task_feature_version += 1
        for row in self._sel_rows:
            self._fill_sel_bits(row, self.task_by_row[row])
        for row in self._tol_rows:
            self._fill_tol_bits(row, self.task_by_row[row])

    # ---- node-ledger dirty rows (the float32 cast's choke point) ---------
    def note_node_ledger(self, row: int) -> None:
        """Mark one node row's ledgers changed; every ledger write path
        calls this or ``note_node_ledger_rows``."""
        self._node_ledger_dirty[row] = True

    def note_node_ledger_rows(self, rows) -> None:
        self._node_ledger_dirty[rows] = True

    # ---- job-alloc dirty rows (the j_alloc float32 cast's choke point) ---
    def note_job_alloc(self, row: int) -> None:
        """Mark one job row's allocated ledger changed; every write path
        calls this or ``note_job_alloc_rows``."""
        self._j_alloc_dirty[row] = True

    def note_job_alloc_rows(self, rows) -> None:
        self._j_alloc_dirty[rows] = True

    def job_alloc32(self) -> np.ndarray:
        """The float32 twin of j_alloc, refreshed at exactly the dirty
        rows."""
        dirty = self._j_alloc_dirty
        if dirty.any():
            rows = np.flatnonzero(dirty)
            self.j_alloc32[rows] = self.j_alloc[rows]
            dirty[:] = False
        return self.j_alloc32

    def bump_node_features(self) -> None:
        self.node_feature_version += 1

    def node_ledgers32(self):
        """(idle32, rel32, used32, alloc32): the float32 ledger twins,
        refreshed at exactly the dirty rows."""
        dirty = self._node_ledger_dirty
        if dirty.any():
            rows = np.flatnonzero(dirty)
            self.n_idle32[rows] = self.n_idle[rows]
            self.n_rel32[rows] = self.n_rel[rows]
            self.n_used32[rows] = self.n_used[rows]
            self.n_alloc32[rows] = self.n_alloc[rows]
            dirty[:] = False
        return self.n_idle32, self.n_rel32, self.n_used32, self.n_alloc32

    # ==================================================================
    # device residency
    # ==================================================================
    # snapshot field → (backing column, version axis): per-axis versions
    # keep pod churn from re-uploading the node columns and back
    FEATURE_FIELDS = {
        "task_req": ("t_init32", "task"),
        "task_resreq": ("t_res32", "task"),
        "task_job": ("t_job", "task"),
        "task_prio": ("t_prio", "task"),
        "task_creation": ("t_creation", "task"),
        "task_best_effort": ("t_best_effort", "task"),
        "task_critical": ("t_critical", "task"),
        "task_needs_host": ("t_needs_host", "task"),
        "task_sel_bits": ("t_sel_bits", "task"),
        "task_sel_impossible": ("t_sel_impossible", "task"),
        "task_tol_bits": ("t_tol_bits", "task"),
        # the float32 twin, refreshed by device_snapshot before any swap
        "node_alloc": ("n_alloc32", "node"),
        "node_label_bits": ("n_label_bits", "node"),
        "node_taint_bits": ("n_taint_bits", "node"),
    }

    def resident_features(self, snap, upload) -> Dict:
        """Stage into ``upload`` the feature columns whose axis version
        moved since the last call (or whose shape changed); returns
        field → what yields its device tensor once ``upload`` ran.  The
        columns are read from the store, not from ``snap``, as the JAX
        package's cache does."""
        from kube_batch_tpu_torch.api.convert import host_field

        cache = self._dev_cache.setdefault(upload.device, {})
        versions = {"task": self.task_feature_version,
                    "node": self.node_feature_version}
        made = {}
        for field, (col, axis) in self.FEATURE_FIELDS.items():
            version = versions[axis]
            host = host_field(field, getattr(self, col))
            ver, tensor = cache.get(field, (-1, None))
            if ver != version or tensor.shape != host.shape:
                handle = upload.add(host)

                def done(field=field, version=version, handle=handle):
                    t = upload.tensor(handle).clone()
                    cache[field] = (version, t)
                    return t

                made[field] = done
            else:
                made[field] = lambda t=tensor: t
        return made

    def resident_features_sharded(self, uploads, mesh) -> Dict:
        """:meth:`resident_features` on ``mesh``'s placements: ``uploads``
        holds one staged upload per distinct device, and each field yields
        its placement → tensor dict (node columns per node shard)."""
        from kube_batch_tpu_torch.api.convert import host_field
        from kube_batch_tpu_torch.parallel.mesh import node_slice

        cache = self._dev_cache.setdefault(mesh, {})
        versions = {"task": self.task_feature_version,
                    "node": self.node_feature_version}
        node_places = self._per_cycle_dev[mesh].node_places
        devices = self._per_cycle_dev[mesh].devices
        made = {}
        for field, (col, axis) in self.FEATURE_FIELDS.items():
            version = versions[axis]
            host = host_field(field, getattr(self, col))
            ver, shape, placed = cache.get(field, (-1, None, None))
            if ver == version and shape == host.shape:
                made[field] = lambda placed=placed: placed
                continue
            places = node_places if axis == "node" else devices
            handles = {}
            for p in places:
                d = p[0] if isinstance(p, tuple) else p
                part = node_slice(field, host, p[1], mesh.node_shards) if axis == "node" else host
                handles[p] = (d, uploads[d].add(part))

            def done(field=field, version=version, shape=host.shape, handles=handles):
                placed = {p: uploads[d].tensor(h).clone() for p, (d, h) in handles.items()}
                cache[field] = (version, shape, placed)
                return placed

            made[field] = done
        return made

    def per_cycle_cache(self, key):
        """The per-cycle resident cache for ``key`` (a device, or a mesh:
        ``ShardedPerCycleDeviceCache``), made on first use.  Only the path
        that just ran keeps a cache: a device or mesh change drops the
        other's residency and carried tables, so the fresh one uploads in
        full once and scatters resume."""
        from kube_batch_tpu_torch.api.resident import (
            PerCycleDeviceCache, ShardedPerCycleDeviceCache,
        )
        from kube_batch_tpu_torch.parallel.mesh import Mesh

        cache = self._per_cycle_dev.get(key)
        if cache is None:
            for stale in [k for k in self._per_cycle_dev if k != key]:
                del self._per_cycle_dev[stale]
                self._dev_cache.pop(stale, None)
                for wkey in [w for w in self._warm_tables
                             if w == stale or (isinstance(w, tuple) and w[0] == stale)]:
                    del self._warm_tables[wkey]
            cache = self._per_cycle_dev[key] = (
                ShardedPerCycleDeviceCache(key) if isinstance(key, Mesh)
                else PerCycleDeviceCache(key))
        return cache

    def per_cycle_resident(self, snap, upload) -> Dict:
        """Stage into ``upload`` a swap of ``snap``'s per-cycle fields on
        ``upload.device``'s resident cache (``api/resident.py``); returns
        field → what yields its device tensor once ``upload`` ran."""
        return self.per_cycle_cache(upload.device).stage(snap, upload)

    def resident_counters(self) -> Dict[str, Dict[str, int]]:
        """The per-cycle cache's counters under its path name: "single"
        for a device's cache, "sharded" for a mesh's."""
        return {_path_name(key): cache.counters()
                for key, cache in self._per_cycle_dev.items()}

    def export_delta_record(self, device=None):
        """The last swap's delta record and the cache's swap version, or
        ``(None, 0)`` when ``device`` (a device or a mesh) has no resident
        cache."""
        from kube_batch_tpu_torch.parallel.mesh import Mesh

        key = device if isinstance(device, Mesh) else torch.device(
            "cuda" if device is None else device)
        cache = self._per_cycle_dev.get(key)
        if cache is None:
            return None, 0
        return dict(cache.delta_record), int(cache.version)

    def drop_resident(self) -> None:
        """Cold-start the device residency: the next swap uploads every
        column in full.  The carried warm tables go with it: they were
        ranked against the dropped tensors, and a guard heal must not
        leave a possibly corrupt ranking behind."""
        self._per_cycle_dev.clear()
        self._dev_cache.clear()
        self.drop_warm_tables()

    def revalidate_resident(self, cache) -> Dict:
        """Warm-standby revalidation (leader failover): whether the
        surviving per-cycle device cache may keep serving after the host
        model was rebuilt from the pod store.  KEEP when every resident
        cache has synced at least one snapshot (version token > 0) and
        ``check_consistency`` is clean: the next swap's diff then absorbs
        what diverged as ordinary scatter deltas, so failover pays no full
        re-upload.  DROP (cold start) on any consistency error or an
        unsynced cache.  The follower's restart re-adoption
        (``replicate/follower.FollowerApplier.revalidate_resident``)
        applies the same keep-iff-synced contract."""
        errors = [str(e) for e in self.check_consistency(cache)]
        tokens = {_path_name(key): int(rc.version) for key, rc in self._per_cycle_dev.items()}
        ok = not errors and all(v > 0 for v in tokens.values())
        if not ok and self._per_cycle_dev:
            self.drop_resident()
        return {
            "mode": "warm" if ok else "cold",
            "resident_tokens": tokens,
            "errors": errors,
        }

    # ---- warm-started allocate: carried candidate tables (KB_WARM) ----
    def warm_table_state(self, device, impl=None):
        """The carried candidate-table state for ``device``, made on first
        use; it resets itself when its shape or config key changes.  On a
        mesh the state is keyed by (mesh, impl), the JAX package's dispatch
        slot, and its table lies on the mesh's first device."""
        from kube_batch_tpu_torch.api.resident import WarmTableState
        from kube_batch_tpu_torch.parallel.mesh import Mesh

        if isinstance(device, Mesh):
            key = (device, impl)
            st = self._warm_tables.get(key)
            if st is None:
                st = self._warm_tables[key] = WarmTableState(device.first, key=device)
            return st
        device = resolve_device(device)
        st = self._warm_tables.get(device)
        if st is None:
            st = self._warm_tables[device] = WarmTableState(device)
        return st

    def drop_warm_tables(self) -> None:
        """Drop every carried candidate table: the next warm dispatch
        builds cold."""
        self._warm_tables.clear()

    def warm_counters(self) -> Dict[str, Dict]:
        """The carried tables' counters under their path name: "single",
        or "sharded:<impl>" for a mesh's dispatch slot (the JAX package's
        names)."""
        return {("sharded:" + key[1] if isinstance(key, tuple) else "single"): st.counters()
                for key, st in self._warm_tables.items()}

    def device_snapshot(self, ssn):
        """(DeviceSnapshot of numpy arrays, SnapshotMeta) for an exclusive
        session, straight from the columns.  Row space == device axis: the
        assignment vector indexes task rows; node / job indices are rows.
        Several arrays are the live columns themselves, not copies."""
        self.refresh_task_bits()
        spec = self.spec
        capT, capN = self.tasks.cap, self.nodes.cap
        capJ, capQ = self.jobs.cap, self.queues.cap

        if not ssn.rows_synced:
            self.sync_session_rows(ssn)
        j_sess = self.j_sess
        job_ready = self.j_counts[:, READY_STATUSES].sum(axis=1, dtype=np.int32)

        # ---- queue aggregates (proportion.go:84-99 semantics) -----------
        sess_rows = np.flatnonzero(j_sess)
        queue_alloc = np.zeros((capQ, self.R), np.float32)
        queue_request = np.zeros((capQ, self.R), np.float32)
        if sess_rows.size:
            qr = self.j_queue[sess_rows]
            np.add.at(queue_alloc, qr, self.j_alloc[sess_rows].astype(np.float32))
            np.add.at(queue_request, qr,
                      (self.j_alloc[sess_rows] + self.j_pend[sess_rows]).astype(np.float32))

        # ---- sparse affinity / preference rows --------------------------
        aff_live = [r for r in self._aff_rows if self.t_valid[r]]
        K = max(1, len(aff_live))
        task_aff_idx = np.full(K, -1, np.int32)
        task_aff_mask = np.ones((K, capN), bool)
        node_objs = None
        if aff_live:
            from kube_batch_tpu_torch.plugins.predicates import pod_affinity_ok

            node_objs = [n for n in self.node_by_row if n is not None]
            for k, row in enumerate(aff_live):
                task_aff_idx[k] = row
                t = self.task_by_row[row]
                for n in node_objs:
                    task_aff_mask[k, n._row] = pod_affinity_ok(t, n, node_objs)
        pref_live = [r for r in self._pref_rows if self.t_valid[r]]
        Kp = max(1, len(pref_live))
        task_pref_idx = np.full(Kp, -1, np.int32)
        task_pref_node = np.zeros((Kp, capN), np.float32)
        task_pref_pod = np.zeros((Kp, capN), np.float32)
        if pref_live:
            from kube_batch_tpu_torch.plugins.nodeorder import (
                minmax_scale_rows,
                preferred_node_affinity_score,
                preferred_pod_affinity_score,
            )

            if node_objs is None:
                node_objs = [n for n in self.node_by_row if n is not None]
            for k, row in enumerate(pref_live):
                task_pref_idx[k] = row
                t = self.task_by_row[row]
                for n in node_objs:
                    task_pref_node[k, n._row] = preferred_node_affinity_score(t, n)
                    task_pref_pod[k, n._row] = preferred_pod_affinity_score(
                        t, n, node_objs)
            task_pref_pod = minmax_scale_rows(task_pref_pod)

        node_valid = self.n_valid
        # session-level node exclusions (pressure gates) fold into node_sched
        node_sched = self.n_sched
        excluded_rows = self.excluded_node_rows(ssn)
        if excluded_rows:
            node_sched = node_sched.copy()
            node_sched[excluded_rows] = False
        total = (self.n_alloc[node_valid].sum(axis=0).astype(np.float32)
                 if node_valid.any() else np.zeros(self.R, np.float32))
        # node ledgers: the float32 twins, refreshed at the dirty rows only
        idle32, rel32, used32, alloc32 = self.node_ledgers32()

        snap = DeviceSnapshot(
            task_req=self.t_init32,
            task_resreq=self.t_res32,
            task_job=self.t_job,
            task_prio=self.t_prio,
            task_creation=self.t_creation,
            task_status=self.t_status,
            task_valid=self.t_valid,
            task_pending=self.schedulable_pending_mask(),
            task_best_effort=self.t_best_effort,
            task_sel_bits=self.t_sel_bits,
            task_sel_impossible=self.t_sel_impossible,
            task_tol_bits=self.t_tol_bits,
            task_node=self.t_node,
            task_critical=self.t_critical,
            task_needs_host=self.t_needs_host,
            task_aff_idx=task_aff_idx,
            task_aff_mask=task_aff_mask,
            task_pref_idx=task_pref_idx,
            task_pref_node=task_pref_node,
            task_pref_pod=task_pref_pod,
            node_idle=idle32,
            node_releasing=rel32,
            node_used=used32,
            node_alloc=alloc32,
            node_valid=node_valid,
            node_sched=node_sched,
            node_label_bits=self.n_label_bits,
            node_taint_bits=self.n_taint_bits,
            job_min_avail=self.j_min,
            job_ready=job_ready,
            job_queue=self.j_queue,
            job_prio=self.j_prio,
            job_creation=self.j_creation,
            job_valid=j_sess,
            job_schedulable=self.j_sched,
            job_allocated=self.job_alloc32(),
            queue_weight=self.q_weight,
            queue_capability=self.q_cap,
            queue_alloc=queue_alloc,
            queue_request=queue_request,
            queue_valid=self.q_valid,
            total=total,
            quanta=spec.quanta.astype(np.float32),
        )
        meta = SnapshotMeta(
            spec=spec,
            task_keys=[t._key if t is not None else "" for t in self.task_by_row],
            node_names=self.node_names,
            job_uids=[j.uid if j is not None else "" for j in self.job_by_row],
            queue_names=self.queue_names,
            label_pair_bit=self.label_pair_bit,
            taint_bit=self.taint_bit,
            n_tasks=capT,
            n_nodes=capN,
            n_jobs=capJ,
            n_queues=capQ,
            task_objs=self.task_by_row,
            job_objs=self.job_by_row,
            node_objs=self.node_by_row,
            task_resreq64=self.t_resreq64,
            task_needs_host=self.t_needs_host,
            live_nodes=int(node_valid.sum()),
        )
        return snap, meta

    # ==================================================================
    # debug / test support
    # ==================================================================
    def check_consistency(self, cache) -> List[str]:
        """The columns against the object model: a list of discrepancies,
        empty when consistent.  O(objects) — for tests and debugging."""
        errs: List[str] = []
        seen_rows = set()
        for uid, job in cache.jobs.items():
            row = job._row
            if row < 0:
                errs.append(f"job {uid} unbound")
                continue
            if not np.allclose(self.j_alloc[row], job.allocated.vec):
                errs.append(f"job {uid} allocated mismatch")
            if not np.allclose(self.j_pend[row], job.pending_request.vec):
                errs.append(f"job {uid} pending mismatch")
            if not np.allclose(self.j_total[row], job.total_request.vec):
                errs.append(f"job {uid} total mismatch")
            mr = job.pod_group.min_resources if job.pod_group is not None else None
            if (bool(self.j_has_minres[row]) != (mr is not None)
                    or not np.array_equal(self.j_minres[row], self._minres_vec(mr))):
                errs.append(f"job {uid} min_resources row mismatch")
            for s in TaskStatus:
                want = len(job.task_status_index.get(s, {}))
                got = int(self.j_counts[row, int(s)])
                if want != got:
                    errs.append(f"job {uid} count[{s.name}] = {got}, objects say {want}")
            for t in job.tasks.values():
                trow = t._row
                if trow < 0:
                    errs.append(f"task {t._key} unbound")
                    continue
                seen_rows.add(trow)
                if int(self.t_status[trow]) != int(t.status):
                    errs.append(f"task {t._key} status col {self.t_status[trow]} "
                                f"!= {int(t.status)}")
                # t_node is the node row the task is ACCOUNTED on, derived
                # from the object model so index corruption cannot
                # self-validate
                want_node = -1
                if t.node_name:
                    node_obj = cache.nodes.get(t.node_name)
                    if node_obj is not None and t._key in node_obj.tasks:
                        want_node = node_obj._row
                if int(self.t_node[trow]) != want_node:
                    errs.append(f"task {t._key} node col {self.t_node[trow]} "
                                f"!= {want_node}")
                if self.t_job[trow] != row:
                    errs.append(f"task {t._key} job col {self.t_job[trow]} != {row}")
                if not self.t_valid[trow]:
                    errs.append(f"task {t._key} row not valid")
        if int(self.t_valid.sum()) != len(seen_rows):
            errs.append(f"{int(self.t_valid.sum())} valid task rows but "
                        f"{len(seen_rows)} live tasks")
        for name, node in cache.nodes.items():
            row = node._row
            if row < 0:
                errs.append(f"node {name} unbound")
                continue
            for label, col, vec in (("idle", self.n_idle, node.idle.vec),
                                    ("used", self.n_used, node.used.vec),
                                    ("releasing", self.n_rel, node.releasing.vec),
                                    ("allocatable", self.n_alloc, node.allocatable.vec)):
                if not np.allclose(col[row], vec):
                    errs.append(f"node {name} {label} mismatch")
            if bool(self.n_valid[row]) != node.ready:
                errs.append(f"node {name} valid flag mismatch")
        for name in cache.queues:
            if self.queue_rows.get(name) is None:
                errs.append(f"queue {name} unbound")
        # the float32 ledger twins must equal the float64 ledgers once the
        # dirty rows are flushed: a ledger write that missed its choke point
        # shows up here
        self.node_ledgers32()
        for label, f32, f64 in (("idle32", self.n_idle32, self.n_idle),
                                ("rel32", self.n_rel32, self.n_rel),
                                ("used32", self.n_used32, self.n_used),
                                ("alloc32", self.n_alloc32, self.n_alloc)):
            stale = np.flatnonzero(np.any(f32 != f64.astype(np.float32), axis=1))
            if stale.size:
                errs.append(f"node ledger twin {label} stale at rows "
                            f"{stale[:8].tolist()} (missed note_node_ledger)")
        self.job_alloc32()
        stale = np.flatnonzero(np.any(
            self.j_alloc32 != self.j_alloc.astype(np.float32), axis=1))
        if stale.size:
            errs.append(f"job alloc twin stale at rows {stale[:8].tolist()} "
                        "(missed note_job_alloc)")
        return errs
