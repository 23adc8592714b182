"""DeviceSnapshot — the cluster state as structure-of-arrays tensors.

Mirrors ``kube_batch_tpu/api/snapshot.py``: the same fields in the same
order, padded to the same shape buckets, so a snapshot built by the JAX
package converts field by field (:mod:`kube_batch_tpu_torch.api.convert`).
The u32 bitsets (``task_sel_bits``, ``task_tol_bits``, ``node_label_bits``,
``node_taint_bits``) ride as int32 views: ``&``, ``~`` and ``==`` are
bit-identical on them, and torch's uint32 lacks most CPU ops.

An exclusive session builds its snapshot from the cache's column store
(``api/columns.py`` ``ColumnStore.device_snapshot``); an isolated session,
whose cloned objects are bound to no column, flattens its objects with
:func:`build_snapshot`.  Both give numpy arrays, which
``api/convert.snapshot_from_numpy`` or the resident swap upload.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from kube_batch_tpu_torch.api.resources import ResourceSpec
from kube_batch_tpu_torch.api.types import (
    CRITICAL_NAMESPACE,
    CRITICAL_PRIORITY_CLASSES,
    PodGroupPhase,
    TaskStatus,
    is_allocated,
)

#: bits per word of the label / taint bitsets
BITS = 32
#: taint effects that hard-exclude a node (PreferNoSchedule only scores)
HARD_TAINT_EFFECTS = ("NoSchedule", "NoExecute")
#: capability value meaning "unbounded" (queue without a Capability cap)
UNBOUNDED = np.float32(3.4e38)

#: fields carried as int32 views of u32 bitsets
BITSET_FIELDS = frozenset(
    {"task_sel_bits", "task_tol_bits", "node_label_bits", "node_taint_bits"}
)


def bucket(n: int, floor: int = 8) -> int:
    """Shape bucket ≥ max(n, floor): powers of two up to 4096, then
    multiples of 1024 (≤2.5% padding at the 50k/5k sizes users run)."""
    n = max(n, floor)
    if n <= 4096:
        return max(floor, 1 << max(0, math.ceil(math.log2(n))))
    return -(-n // 1024) * 1024


class DeviceSnapshot(NamedTuple):
    """The per-cycle tensor image; rows beyond the live count are padding
    with their ``*_valid`` bit off."""

    # tasks [T, ...]
    task_req: "torch.Tensor"          # [T, R] f32 — InitResreq (fits on this)
    task_resreq: "torch.Tensor"       # [T, R] f32 — Resreq (accounting)
    task_job: "torch.Tensor"          # [T] i32 — index into the job axis
    task_prio: "torch.Tensor"         # [T] i32
    task_creation: "torch.Tensor"     # [T] i32
    task_status: "torch.Tensor"       # [T] i32 — TaskStatus values
    task_valid: "torch.Tensor"        # [T] bool
    task_pending: "torch.Tensor"      # [T] bool — Pending and not BestEffort
    task_best_effort: "torch.Tensor"  # [T] bool
    task_sel_bits: "torch.Tensor"     # [T, W] i32 view of u32 label bits
    task_sel_impossible: "torch.Tensor"  # [T] bool
    task_tol_bits: "torch.Tensor"     # [T, Wt] i32 view of u32 taint bits
    task_node: "torch.Tensor"         # [T] i32 — bound node, -1 unbound
    task_critical: "torch.Tensor"     # [T] bool
    task_needs_host: "torch.Tensor"   # [T] bool
    task_aff_idx: "torch.Tensor"      # [K] i32 — task index, -1 padding
    task_aff_mask: "torch.Tensor"     # [K, N] bool — allowed nodes
    task_pref_idx: "torch.Tensor"     # [Kp] i32 — task index, -1 padding
    task_pref_node: "torch.Tensor"    # [Kp, N] f32
    task_pref_pod: "torch.Tensor"     # [Kp, N] f32
    # nodes [N, ...]
    node_idle: "torch.Tensor"         # [N, R] f32
    node_releasing: "torch.Tensor"    # [N, R] f32
    node_used: "torch.Tensor"         # [N, R] f32
    node_alloc: "torch.Tensor"        # [N, R] f32 — allocatable
    node_valid: "torch.Tensor"        # [N] bool
    node_sched: "torch.Tensor"        # [N] bool
    node_label_bits: "torch.Tensor"   # [N, W] i32 view of u32
    node_taint_bits: "torch.Tensor"   # [N, Wt] i32 view of u32
    # jobs [J, ...]
    job_min_avail: "torch.Tensor"     # [J] i32
    job_ready: "torch.Tensor"         # [J] i32
    job_queue: "torch.Tensor"         # [J] i32
    job_prio: "torch.Tensor"          # [J] i32
    job_creation: "torch.Tensor"      # [J] i32
    job_valid: "torch.Tensor"         # [J] bool
    job_schedulable: "torch.Tensor"   # [J] bool
    job_allocated: "torch.Tensor"     # [J, R] f32
    # queues [Q, ...]
    queue_weight: "torch.Tensor"      # [Q] f32
    queue_capability: "torch.Tensor"  # [Q, R] f32
    queue_alloc: "torch.Tensor"       # [Q, R] f32
    queue_request: "torch.Tensor"     # [Q, R] f32
    queue_valid: "torch.Tensor"       # [Q] bool
    # cluster
    total: "torch.Tensor"             # [R] f32
    quanta: "torch.Tensor"            # [R] f32


@dataclasses.dataclass
class SnapshotMeta:
    """Host-side index maps for decoding device results back to names."""

    spec: ResourceSpec
    task_keys: List[str]            # task index → "ns/name"
    node_names: List[str]           # node index → name
    job_uids: List[str]             # job index → uid
    queue_names: List[str]          # queue index → name
    label_pair_bit: Dict[Tuple[str, str], int]
    taint_bit: Dict[Tuple[str, str, str], int]
    n_tasks: int
    n_nodes: int
    n_jobs: int
    n_queues: int
    # the session's own objects in device-index order — the allocate replay
    # addresses placements by index instead of by dict lookups
    task_objs: List = dataclasses.field(default_factory=list)
    job_objs: List = dataclasses.field(default_factory=list)
    node_objs: List = dataclasses.field(default_factory=list)
    # [T, R] float64 resreq: segment sums over it match the host Resource
    # ledgers exactly (the f32 device cast would not)
    task_resreq64: "np.ndarray" = None
    # [T] bool — task carries host-only constraints (ports, rich affinity)
    task_needs_host: "np.ndarray" = None
    # Ready nodes at snapshot time (the fit-error "0/N nodes" denominator)
    live_nodes: int = 0

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (len(self.task_keys), len(self.node_names),
                len(self.job_uids), len(self.queue_names))


_task_key = operator.attrgetter("_key")


def _pad_bool(arr: np.ndarray, n: int) -> np.ndarray:
    """[k] bool → [n] bool, padded with False."""
    out = np.zeros(n, bool)
    out[: arr.shape[0]] = arr
    return out


def _pack_bits(bit_indices: List[int], words: int) -> np.ndarray:
    out = np.zeros(words, dtype=np.uint32)
    for b in bit_indices:
        out[b // BITS] |= np.uint32(1 << (b % BITS))
    return out


class _TaintView:
    """Duck-typed taint for ``Toleration.tolerates`` during interning."""

    __slots__ = ("key", "value", "effect")

    def __init__(self, key: str, value: str, effect: str):
        self.key = key
        self.value = value
        self.effect = effect


def build_snapshot(cluster, pad: bool = True, excluded_nodes=()
                   ) -> Tuple[DeviceSnapshot, SnapshotMeta]:
    """Flatten a ClusterInfo of (cloned) objects into the snapshot arrays,
    numpy, u32 bitsets: the isolated session's counterpart of
    ``ColumnStore.device_snapshot``.  Queues, jobs and nodes are numbered
    in sorted order (name, uid, name), each job's tasks by key after its
    predecessors'.  Every task of every job is included (resident tasks
    carry the accounting); only Pending, not BestEffort ones are
    ``task_pending``.  The session open already dropped gang-invalid jobs;
    ``job_valid`` marks jobs in a known queue.  ``excluded_nodes`` fold
    into ``node_sched``."""
    spec = cluster.spec
    R = spec.n

    queues = sorted(cluster.queues.values(), key=lambda q: q.name)
    queue_idx = {q.name: i for i, q in enumerate(queues)}
    jobs = sorted(cluster.jobs.values(), key=lambda j: j.uid)
    nodes = sorted(cluster.nodes.values(), key=lambda n: n.name)
    node_idx = {n.name: i for i, n in enumerate(nodes)}

    tasks = []
    for ji, j in enumerate(jobs):
        for t in sorted(j.tasks.values(), key=_task_key):
            tasks.append((t, ji))

    nT, nN, nJ, nQ = len(tasks), len(nodes), len(jobs), len(queues)
    T = bucket(nT) if pad else max(nT, 1)
    N = bucket(nN) if pad else max(nN, 1)
    J = bucket(nJ) if pad else max(nJ, 1)
    Q = bucket(nQ) if pad else max(nQ, 1)

    # ---- label / taint interning over the node universe -----------------
    label_pair_bit: Dict[Tuple[str, str], int] = {}
    taint_bit: Dict[Tuple[str, str, str], int] = {}
    for n in nodes:
        if n.node is None:
            continue
        for k, v in n.node.labels.items():
            label_pair_bit.setdefault((k, v), len(label_pair_bit))
        for taint in n.node.taints:
            if taint.effect in HARD_TAINT_EFFECTS:
                taint_bit.setdefault((taint.key, taint.value, taint.effect),
                                     len(taint_bit))
    W = max(1, -(-len(label_pair_bit) // BITS))
    Wt = max(1, -(-len(taint_bit) // BITS))

    # ---- tasks: one numpy write per column ------------------------------
    task_req = np.zeros((T, R), np.float32)
    task_resreq = np.zeros((T, R), np.float32)
    task_job = np.zeros(T, np.int32)
    task_prio = np.zeros(T, np.int32)
    task_creation = np.zeros(T, np.int32)
    task_status = np.full(T, int(TaskStatus.UNKNOWN), np.int32)
    task_valid = np.zeros(T, bool)
    task_pending = np.zeros(T, bool)
    task_best_effort = np.zeros(T, bool)
    task_sel_bits = np.zeros((T, W), np.uint32)
    task_sel_impossible = np.zeros(T, bool)
    task_tol_bits = np.zeros((T, Wt), np.uint32)
    task_node = np.full(T, -1, np.int32)
    task_critical = np.zeros(T, bool)
    aff_tasks: List[int] = []   # tasks needing an inter-pod-affinity row
    pref_tasks: List[int] = []  # tasks with preferred (soft) terms
    task_keys: List[str] = []
    taint_list = list(taint_bit.items())
    task_objs: List = []
    task_resreq64 = np.zeros((nT, R), np.float64)
    task_needs_host = np.zeros(nT, bool)
    if nT:
        task_objs = [t for t, _ in tasks]
        task_keys.extend(t._key for t in task_objs)
        task_resreq64 = np.stack([t.resreq.vec for t in task_objs])
        task_resreq[:nT] = task_resreq64
        # init_resreq IS resreq for a pod without init containers
        if all(t.init_resreq is t.resreq for t in task_objs):
            task_req[:nT] = task_resreq[:nT]
        else:
            task_req[:nT] = np.stack([t.init_resreq.vec for t in task_objs])
        task_needs_host = np.fromiter((t.needs_host_predicate for t in task_objs),
                                      bool, count=nT)
        task_job[:nT] = [ji for _, ji in tasks]
        task_prio[:nT] = [t.priority for t in task_objs]
        task_creation[:nT] = [t.pod.creation_index for t in task_objs]
        statuses = np.fromiter((int(t.status) for t in task_objs), np.int32, count=nT)
        task_status[:nT] = statuses
        task_valid[:nT] = True
        # BestEffort = empty semantic InitResreq
        m = spec.semantic_mask
        task_best_effort[:nT] = np.all(task_req[:nT][:, m] < spec.quanta[None, m], axis=1)
        task_pending[:nT] = (statuses == int(TaskStatus.PENDING)) & ~task_best_effort[:nT]
        task_node[:nT] = [node_idx.get(t.node_name, -1) if t.node_name is not None else -1
                          for t in task_objs]
        task_critical[:nT] = [t.pod.priority_class in CRITICAL_PRIORITY_CLASSES
                              or t.namespace == CRITICAL_NAMESPACE for t in task_objs]
    # sparse per-task features: only tasks carrying selectors, tolerations
    # or affinity walk this path
    sparse = [(i, t) for i, (t, _) in enumerate(tasks)
              if t.pod.affinity is not None or t.pod.node_selector or t.pod.tolerations]
    for i, t in sparse:
        pod = t.pod
        if pod.affinity is not None and (pod.affinity.pod_affinity
                                         or pod.affinity.pod_anti_affinity):
            aff_tasks.append(i)
        if pod.affinity is not None and pod.affinity.has_preferences():
            pref_tasks.append(i)
        # required label pairs → bits: the node selector plus a single
        # node-affinity term's one-value In requirements; richer terms stay
        # with the host predicate (the mask is a sound over-approximation)
        if pod.node_selector or pod.affinity is not None:
            required_pairs = list(pod.node_selector.items())
            if pod.affinity is not None and len(pod.affinity.node_terms) == 1:
                required_pairs += [(key, values[0])
                                   for key, op, values in pod.affinity.node_terms[0]
                                   if op == "In" and len(values) == 1]
            sel_bits: List[int] = []
            for k, v in required_pairs:
                b = label_pair_bit.get((k, v))
                if b is None:
                    task_sel_impossible[i] = True  # no node carries the pair
                else:
                    sel_bits.append(b)
            if sel_bits:
                task_sel_bits[i] = _pack_bits(sel_bits, W)
        # tolerations → tolerated-taint bits (predicates.go:220-231)
        if pod.tolerations and taint_list:
            tol_bits = [bit for (tk, tv, te), bit in taint_list
                        if any(tol.tolerates(_TaintView(tk, tv, te))
                               for tol in pod.tolerations)]
            task_tol_bits[i] = _pack_bits(tol_bits, Wt)

    # ---- nodes ----------------------------------------------------------
    node_idle = np.zeros((N, R), np.float32)
    node_releasing = np.zeros((N, R), np.float32)
    node_used = np.zeros((N, R), np.float32)
    node_alloc = np.zeros((N, R), np.float32)
    node_valid = np.zeros(N, bool)
    node_sched = np.zeros(N, bool)
    node_label_bits = np.zeros((N, W), np.uint32)
    node_taint_bits = np.zeros((N, Wt), np.uint32)
    node_names: List[str] = []
    for i, n in enumerate(nodes):
        node_names.append(n.name)
        node_idle[i] = n.idle.vec
        node_releasing[i] = n.releasing.vec
        node_used[i] = n.used.vec
        node_alloc[i] = n.allocatable.vec
        node_valid[i] = n.ready
        if n.node is not None:
            node_sched[i] = not n.node.unschedulable and n.name not in excluded_nodes
            node_label_bits[i] = _pack_bits(
                [label_pair_bit[(k, v)] for k, v in n.node.labels.items()], W)
            node_taint_bits[i] = _pack_bits(
                [taint_bit[(t.key, t.value, t.effect)] for t in n.node.taints
                 if t.effect in HARD_TAINT_EFFECTS], Wt)

    # ---- jobs -----------------------------------------------------------
    job_min_avail = np.zeros(J, np.int32)
    job_ready = np.zeros(J, np.int32)
    job_queue = np.zeros(J, np.int32)
    job_prio = np.zeros(J, np.int32)
    job_creation = np.zeros(J, np.int32)
    job_valid = np.zeros(J, bool)
    job_schedulable = np.zeros(J, bool)
    job_allocated = np.zeros((J, R), np.float32)
    job_uids: List[str] = []
    for i, j in enumerate(jobs):
        job_uids.append(j.uid)
        job_min_avail[i] = j.min_available
        job_ready[i] = j.ready_task_num
        job_queue[i] = queue_idx.get(j.queue, 0)
        job_prio[i] = j.priority
        job_creation[i] = j.creation_index
        job_valid[i] = j.queue in queue_idx
        phase = j.pod_group.phase if j.pod_group else None
        job_schedulable[i] = phase != PodGroupPhase.PENDING
        job_allocated[i] = j.allocated.vec

    # ---- queues ---------------------------------------------------------
    queue_weight = np.ones(Q, np.float32)
    queue_capability = np.full((Q, R), UNBOUNDED, np.float32)
    queue_alloc = np.zeros((Q, R), np.float32)
    queue_request = np.zeros((Q, R), np.float32)
    queue_valid = np.zeros(Q, bool)
    queue_names: List[str] = []
    for i, q in enumerate(queues):
        queue_names.append(q.name)
        queue_weight[i] = q.weight
        queue_valid[i] = True
        if q.queue.capability:
            # a capability caps every dimension it does not name at 0
            queue_capability[i] = 0.0
            for name, v in q.queue.capability.items():
                if name in spec:
                    queue_capability[i, spec.index(name)] = v
    for i, j in enumerate(jobs):
        qi = job_queue[i]
        queue_alloc[qi] += job_allocated[i]
        # proportion's request: allocated and Pending tasks only
        # (proportion.go:84-99)
        for t in j.tasks.values():
            if t.status == TaskStatus.PENDING or is_allocated(t.status):
                queue_request[qi] += t.resreq.vec

    # sparse inter-pod-affinity rows, evaluated on the host
    K = max(1, len(aff_tasks))
    task_aff_idx = np.full(K, -1, np.int32)
    task_aff_mask = np.ones((K, N), bool)
    if aff_tasks:
        from kube_batch_tpu_torch.plugins.predicates import pod_affinity_ok

        for k, ti in enumerate(aff_tasks):
            task_aff_idx[k] = ti
            t = tasks[ti][0]
            for ni, n in enumerate(nodes):
                task_aff_mask[k, ni] = pod_affinity_ok(t, n, nodes)

    Kp = max(1, len(pref_tasks))
    task_pref_idx = np.full(Kp, -1, np.int32)
    task_pref_node = np.zeros((Kp, N), np.float32)
    task_pref_pod = np.zeros((Kp, N), np.float32)
    if pref_tasks:
        from kube_batch_tpu_torch.plugins.nodeorder import (
            minmax_scale_rows,
            preferred_node_affinity_score,
            preferred_pod_affinity_score,
        )

        for k, ti in enumerate(pref_tasks):
            task_pref_idx[k] = ti
            t = tasks[ti][0]
            for ni, n in enumerate(nodes):
                task_pref_node[k, ni] = preferred_node_affinity_score(t, n)
                task_pref_pod[k, ni] = preferred_pod_affinity_score(t, n, nodes)
        # the pod-affinity row min-max scaled to 0..10 over the real nodes
        task_pref_pod[:, :nN] = minmax_scale_rows(task_pref_pod[:, :nN])

    total = (node_alloc[node_valid].sum(axis=0).astype(np.float32) if nN
             else np.zeros(R, np.float32))

    snap = DeviceSnapshot(
        task_req=task_req,
        task_resreq=task_resreq,
        task_job=task_job,
        task_prio=task_prio,
        task_creation=task_creation,
        task_status=task_status,
        task_valid=task_valid,
        task_pending=task_pending,
        task_best_effort=task_best_effort,
        task_sel_bits=task_sel_bits,
        task_sel_impossible=task_sel_impossible,
        task_tol_bits=task_tol_bits,
        task_node=task_node,
        task_critical=task_critical,
        task_needs_host=_pad_bool(task_needs_host, T),
        task_aff_idx=task_aff_idx,
        task_aff_mask=task_aff_mask,
        task_pref_idx=task_pref_idx,
        task_pref_node=task_pref_node,
        task_pref_pod=task_pref_pod,
        node_idle=node_idle,
        node_releasing=node_releasing,
        node_used=node_used,
        node_alloc=node_alloc,
        node_valid=node_valid,
        node_sched=node_sched,
        node_label_bits=node_label_bits,
        node_taint_bits=node_taint_bits,
        job_min_avail=job_min_avail,
        job_ready=job_ready,
        job_queue=job_queue,
        job_prio=job_prio,
        job_creation=job_creation,
        job_valid=job_valid,
        job_schedulable=job_schedulable,
        job_allocated=job_allocated,
        queue_weight=queue_weight,
        queue_capability=queue_capability,
        queue_alloc=queue_alloc,
        queue_request=queue_request,
        queue_valid=queue_valid,
        total=total,
        quanta=spec.quanta.astype(np.float32),
    )
    meta = SnapshotMeta(
        spec=spec,
        task_keys=task_keys,
        node_names=node_names,
        job_uids=job_uids,
        queue_names=queue_names,
        label_pair_bit=label_pair_bit,
        taint_bit=taint_bit,
        n_tasks=nT,
        n_nodes=nN,
        n_jobs=nJ,
        n_queues=nQ,
        task_objs=task_objs,
        job_objs=list(jobs),
        node_objs=list(nodes),
        task_resreq64=task_resreq64,
        task_needs_host=task_needs_host,
        live_nodes=nN,
    )
    return snap, meta
