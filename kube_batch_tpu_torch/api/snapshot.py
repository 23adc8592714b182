"""DeviceSnapshot — the cluster state as structure-of-arrays tensors.

Mirrors ``kube_batch_tpu/api/snapshot.py``: the same fields in the same
order, padded to the same shape buckets, so a snapshot built by the JAX
package converts field by field (:mod:`kube_batch_tpu_torch.api.convert`).
The u32 bitsets (``task_sel_bits``, ``task_tol_bits``, ``node_label_bits``,
``node_taint_bits``) ride as int32 views: ``&``, ``~`` and ``==`` are
bit-identical on them, and torch's uint32 lacks most CPU ops.

The host cycle builds a snapshot from the cache's column store
(``api/columns.py`` ``ColumnStore.device_snapshot``); the JAX package's
object-model ``build_snapshot`` (isolated sessions) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from kube_batch_tpu_torch.api.resources import ResourceSpec

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
