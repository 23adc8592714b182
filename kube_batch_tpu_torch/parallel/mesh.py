"""The device mesh of the sharded solve, the snapshot's placement on it,
and the sharded entry points.

Mirrors ``kube_batch_tpu/parallel/mesh.py``.  The node axis is split
across the mesh's devices (and, on a 2-D ``(tasks, nodes)`` mesh, the task
axis too); every [T, N]-scale block of a round head is computed on the
device that holds its node columns, and only task-sized winner vectors
cross devices per round (``shard_solve.py`` holds the bodies and their
collectives).

One controller, as the JAX package's ``shard_map``: one process drives
every device of the mesh.  A :class:`Mesh` is an ordered list of
``torch.device``\\ s with the JAX package's axis names; a device may
repeat, so four shards can share one card and eight shards can run on
the CPU.  :func:`place_snapshot` (and the resident cache,
``api/resident.ShardedPerCycleDeviceCache``) gives each mesh position its
own tensors: the node-axis columns sliced to its shard, everything else
once per distinct device.  ``parallel/distributed.py`` maps the same mesh
onto ``torch.distributed`` ranks.

Two implementations, as in the JAX package:

- ``"shard_map"`` (default): the shard bodies with explicit collectives;
- ``"pjit"`` (``KB_SHARD_MAP=0``, or a guard demotion): the oracle.  The
  port has no SPMD partitioner, so its oracle is the single-device
  program on the mesh's first device over the gathered snapshot.  The
  name stays ``"pjit"`` so that ``engaged`` lists, trace attributes and
  the demotion series read as the JAX package's.

Knobs (the JAX package's): ``KB_SHARD=0`` keeps every solve on one
device, ``KB_SHARD_MAP=0`` selects the oracle, ``KB_TASK_SHARDS=k`` folds
the default mesh into a (tasks=k, nodes=d/k) grid.  A mesh is also a
keyword (``Scheduler(mesh=...)``), like ``device=``.
"""

from __future__ import annotations

import logging
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import torch

from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.device import resolve_device

logger = logging.getLogger("kube_batch_tpu_torch")

NODE_AXIS = "nodes"
TASK_AXIS = "tasks"

#: below this padded node-axis size one device wins (the JAX package's gate)
SHARD_MIN_NODES = 256

#: node-axis columns on their leading axis, and on their second axis
NODE_FIELDS = ("node_idle", "node_releasing", "node_used", "node_alloc",
               "node_valid", "node_sched", "node_label_bits", "node_taint_bits")
NODE1_FIELDS = ("task_aff_mask", "task_pref_node", "task_pref_pod")

_default_mesh: Dict[int, "Mesh"] = {}
_bad_task_shards: set = set()


def _env_off(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("0", "false", "off", "no")


def shard_map_enabled() -> bool:
    """``KB_SHARD_MAP=0`` selects the ``"pjit"`` oracle; the default is the
    explicit-collective shard bodies."""
    return not _env_off("KB_SHARD_MAP")


def task_shards() -> int:
    """``KB_TASK_SHARDS=k``: fold the default mesh into a (tasks=k,
    nodes=d/k) grid.  Default 1 (node axis only)."""
    try:
        return max(1, int(os.environ.get("KB_TASK_SHARDS", "1")))
    except ValueError:
        return 1


class Mesh:
    """An ordered list of devices with the JAX package's axis names.

    ``devices`` are in row-major (task, node) order: position ``(i, j)`` is
    ``devices[i * node_shards + j]``.  A device may repeat.  ``ranks``
    (``parallel/distributed.py``) names the process that owns each
    position and ``rank`` this process; without them every position is
    local.  Hashable by value, so a mesh keys the residency as the JAX
    package's does."""

    def __init__(self, devices: Sequence, task_shards: int = 1,
                 ranks: Optional[Sequence[int]] = None, rank: Optional[int] = None,
                 group=None):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError("a CUDA mesh needs a CUDA device; none is available")
                if d.index is None:
                    d = torch.device("cuda", torch.cuda.current_device())
            elif d.type != "cpu":
                raise ValueError(f"unsupported mesh device {d}")
            devs.append(d)
        if not devs or task_shards < 1 or len(devs) % task_shards:
            raise ValueError(f"{len(devs)} devices do not fold into {task_shards} task shards")
        self.devices = tuple(devs)
        ns = len(devs) // task_shards
        if task_shards > 1:
            self.axis_names = (TASK_AXIS, NODE_AXIS)
            self.shape = {TASK_AXIS: task_shards, NODE_AXIS: ns}
        else:
            self.axis_names = (NODE_AXIS,)
            self.shape = {NODE_AXIS: ns}
        self.ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self.rank = rank
        self.group = group
        if self.ranks is not None and len(self.ranks) != len(devs):
            raise ValueError("one rank per mesh position")

    # ---- shape ----------------------------------------------------------
    @property
    def task_shards(self) -> int:
        return self.shape.get(TASK_AXIS, 1)

    @property
    def node_shards(self) -> int:
        return self.shape[NODE_AXIS]

    @property
    def size(self) -> int:
        return len(self.devices)

    def positions(self):
        """Every (i, j) position, row-major."""
        return [(i, j) for i in range(self.task_shards) for j in range(self.node_shards)]

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i * self.node_shards + j]

    # ---- processes ------------------------------------------------------
    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    def is_local(self, i: int, j: int) -> bool:
        return self.ranks is None or self.ranks[i * self.node_shards + j] == self.rank

    def local_positions(self):
        return [p for p in self.positions() if self.is_local(*p)]

    @property
    def first(self) -> torch.device:
        """Where the replicated tail runs: the mesh's first device, or under
        ``distributed`` this process's first device."""
        return self.device(*self.local_positions()[0])

    def distinct(self) -> List[torch.device]:
        """The distinct local devices, in mesh order."""
        out = []
        for p in self.local_positions():
            d = self.device(*p)
            if d not in out:
                out.append(d)
        return out

    @property
    def devices_distinct(self) -> bool:
        return len(set(self.devices)) == len(self.devices)

    def _key(self):
        return (self.devices, self.axis_names, self.ranks, self.rank)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, shape={self.shape})"


def make_mesh(devices: Optional[Sequence] = None, task_shards: int = 1) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA card; raises without
    one) — 1-D over the node axis, or a (tasks, nodes) grid when
    ``task_shards`` > 1.  ``["cuda:0"] * 4`` is four shards on one card,
    ``["cpu"] * 8`` eight on the CPU."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] for the CPU")
        devices = [f"cuda:{i}" for i in range(n)]
    return Mesh(devices, task_shards=task_shards)


def default_mesh(device=None) -> Optional[Mesh]:
    """The production mesh: every CUDA card, ``None`` with one card (as the
    JAX package's is on one chip) and on the CPU.  Cached per task-shard
    count, so every call returns the same object.  A ``KB_TASK_SHARDS``
    that does not divide the card count falls back to the 1-D mesh with a
    warning (once per value)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    n_dev = torch.cuda.device_count()
    if n_dev <= 1:
        return None
    ts = task_shards()
    if ts > 1 and n_dev % ts:
        if ts not in _bad_task_shards:
            _bad_task_shards.add(ts)
            logger.warning("KB_TASK_SHARDS=%d does not divide the %d-device count; "
                           "falling back to the 1-D node mesh", ts, n_dev)
        ts = 1
    mesh = _default_mesh.get(ts)
    if mesh is None:
        mesh = _default_mesh[ts] = make_mesh(task_shards=ts)
    return mesh


def should_shard(n_nodes_padded: int, mesh: Optional[Mesh]) -> bool:
    """The actions' gate: a mesh exists and the node axis is big enough
    (``SHARD_MIN_NODES``).  ``KB_SHARD=0`` keeps one device."""
    if _env_off("KB_SHARD"):
        return False
    return mesh is not None and n_nodes_padded >= SHARD_MIN_NODES


@lru_cache(maxsize=8)
def snapshot_shardings(mesh: Mesh) -> DeviceSnapshot:
    """Per field, its placement on ``mesh``: ``"nodes"`` (sliced on its
    leading axis), ``"nodes:1"`` (sliced on its second axis) or
    ``"replicated"`` (once per distinct device)."""
    spec = {f: "replicated" for f in DeviceSnapshot._fields}
    spec.update({f: "nodes" for f in NODE_FIELDS})
    spec.update({f: "nodes:1" for f in NODE1_FIELDS})
    return DeviceSnapshot(**spec)


def node_slice(field: str, value, j: int, n_shards: int):
    """Node shard ``j`` of one field's full value (numpy or tensor); the
    field itself when it is replicated."""
    if field in NODE_FIELDS:
        s = value.shape[0] // n_shards
        return value[j * s:(j + 1) * s]
    if field in NODE1_FIELDS:
        s = value.shape[1] // n_shards
        return value[:, j * s:(j + 1) * s]
    return value


class ShardedSnapshot:
    """A snapshot placed on a mesh: ``shards[p]`` is position ``p``'s
    :class:`DeviceSnapshot` (row-major; ``None`` for a position another
    process owns) — its node columns sliced to its node shard, its other
    columns the full replicated tensors of its device."""

    def __init__(self, mesh: Mesh, shards):
        self.mesh = mesh
        self.shards = tuple(shards)
        self._gathered = None

    def shard(self, i: int, j: int) -> DeviceSnapshot:
        return self.shards[i * self.mesh.node_shards + j]

    @property
    def n_nodes(self) -> int:
        return self.tail().node_alloc.shape[0] * self.mesh.node_shards

    def __getattr__(self, name):
        # a replicated field reads as the tail's tensor; a node field has no
        # whole tensor here (``gathered()`` makes one)
        if name in DeviceSnapshot._fields:
            if name in NODE_FIELDS or name in NODE1_FIELDS:
                raise AttributeError(f"{name} is node-sharded; use gathered()")
            return getattr(self.tail(), name)
        raise AttributeError(name)

    def tail(self) -> DeviceSnapshot:
        """The first local position's snapshot (its replicated columns are
        on the tail's device)."""
        return self.shard(*self.mesh.local_positions()[0])

    def gathered(self) -> DeviceSnapshot:
        """The whole snapshot on the tail's device: the replicated columns
        and every node shard concatenated.  What the ``"pjit"`` oracle,
        the sentinel tail and a guard bundle read; uncounted (the shard
        bodies gather through ``shard_solve``, which counts)."""
        if self._gathered is None:
            from kube_batch_tpu_torch.parallel.shard_solve import collect

            dev0 = self.mesh.first
            base = self.tail()
            cols = {}
            for f in NODE_FIELDS + NODE1_FIELDS:
                parts = collect(self.mesh, {p: getattr(self.shard(*p), f)
                                            for p in self.mesh.local_positions()
                                            if p[0] == self.mesh.local_positions()[0][0]},
                                dev0, row=self.mesh.local_positions()[0][0])
                cols[f] = torch.cat(parts, 0 if f in NODE_FIELDS else 1)
            self._gathered = base._replace(**cols)
        return self._gathered


def place_snapshot(snap: DeviceSnapshot, mesh: Mesh) -> ShardedSnapshot:
    """``snap`` (tensors or numpy arrays, whole) placed on ``mesh``: copies,
    never views of ``snap`` — node columns per (device, node shard),
    everything else once per distinct device."""
    from kube_batch_tpu_torch.api.convert import host_field

    if isinstance(snap, ShardedSnapshot):
        if snap.mesh != mesh:
            raise ValueError("the snapshot is placed on another mesh")
        return snap
    ns, ts = mesh.node_shards, mesh.task_shards
    T, N = snap.task_req.shape[0], snap.node_alloc.shape[0]
    if N % ns or T % ts:
        raise ValueError(f"[T={T}, N={N}] does not split over the mesh {mesh.shape}")

    def tensor(name, value):
        if isinstance(value, torch.Tensor):
            return value
        return torch.from_numpy(host_field(name, value))

    full = {f: tensor(f, getattr(snap, f)) for f in DeviceSnapshot._fields}
    repl: Dict = {}
    nodes: Dict = {}
    shards = []
    for (i, j) in mesh.positions():
        if not mesh.is_local(i, j):
            shards.append(None)
            continue
        d = mesh.device(i, j)
        if d not in repl:
            repl[d] = {f: v.to(d, copy=True) for f, v in full.items()
                       if f not in NODE_FIELDS and f not in NODE1_FIELDS}
        if (d, j) not in nodes:
            nodes[(d, j)] = {f: node_slice(f, full[f], j, ns).to(d, copy=True).contiguous()
                             for f in NODE_FIELDS + NODE1_FIELDS}
        shards.append(DeviceSnapshot(**repl[d], **nodes[(d, j)]))
    return ShardedSnapshot(mesh, shards)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def _impl(impl: Optional[str]) -> str:
    """The implementation: an explicit override (the guard's demotion
    passes ``"pjit"``), else ``KB_SHARD_MAP``."""
    if impl is not None:
        return impl
    return "shard_map" if shard_map_enabled() else "pjit"


def _placed(snap, mesh) -> ShardedSnapshot:
    """``snap`` on ``mesh``: a ``ShardedSnapshot`` as it is (on that mesh),
    a whole snapshot placed."""
    if isinstance(snap, ShardedSnapshot):
        if mesh is not None and snap.mesh != mesh:
            raise ValueError("the snapshot is placed on another mesh")
        return snap
    if mesh is None:
        raise ValueError("a snapshot not placed on a mesh needs the mesh")
    return place_snapshot(snap, mesh)


def sharded_allocate_solve(snap, config, mesh: Optional[Mesh] = None,
                           impl: Optional[str] = None):
    """The allocate solve over the mesh: K1 per shard at its (t0, n0) each
    round, the winners combined on the first device, the tail there.  The
    result lies on the first device, its node ledgers whole."""
    from kube_batch_tpu_torch.ops.assignment import allocate_solve
    from kube_batch_tpu_torch.parallel import shard_solve

    ss = _placed(snap, mesh)
    if _impl(impl) == "pjit":
        return allocate_solve(ss.gathered(), config)
    return shard_solve.allocate_shard_map(ss, config)


def sentinel_sharded_allocate_solve(snap, config, mesh=None, impl=None):
    """(result, verdict, hist, checksum): the sharded solve and the
    invariant tail over the gathered snapshot."""
    from kube_batch_tpu_torch.ops.invariants import allocate_invariants, eligibility_checksum

    ss = _placed(snap, mesh)
    res = sharded_allocate_solve(ss, config, impl=impl)
    g = ss.gathered()
    verdict, hist = allocate_invariants(g, res, config)
    return res, verdict, hist, eligibility_checksum(g)


def _check_1d(ss: ShardedSnapshot, what: str) -> None:
    if ss.mesh.task_shards != 1:
        raise ValueError(f"{what} requires a 1-D node mesh")


def sharded_allocate_topk_solve(snap, pend_rows, config, mesh=None, impl=None):
    """The compacted solve over the mesh (1-D meshes): K2 per shard builds
    each shard's candidate lists, merged once per solve; the rounds run on
    the first device with no per-round collective."""
    from kube_batch_tpu_torch.ops.assignment import allocate_topk_solve
    from kube_batch_tpu_torch.parallel import shard_solve

    ss = _placed(snap, mesh)
    _check_1d(ss, "KB_TOPK compaction")
    if _impl(impl) == "pjit":
        return allocate_topk_solve(ss.gathered(), pend_rows.to(ss.mesh.first), config)
    return shard_solve.allocate_topk_shard_map(ss, pend_rows, config)


def sentinel_sharded_allocate_topk_solve(snap, pend_rows, config, mesh=None, impl=None):
    from kube_batch_tpu_torch.ops.invariants import allocate_invariants, eligibility_checksum

    ss = _placed(snap, mesh)
    res = sharded_allocate_topk_solve(ss, pend_rows, config, impl=impl)
    g = ss.gathered()
    verdict, hist = allocate_invariants(g, res, config)
    return res, verdict, hist, eligibility_checksum(g)


def sharded_warm_allocate_solve(snap, pend_rows, table, plan, config, k_min: int,
                                mesh=None, impl=None):
    """The warm-started compacted solve over the mesh → ``(result, table',
    eroded)``; the carried table lies on the first device."""
    from kube_batch_tpu_torch.ops.assignment import warm_allocate_solve
    from kube_batch_tpu_torch.parallel import shard_solve

    ss = _placed(snap, mesh)
    _check_1d(ss, "KB_WARM carry")
    if _impl(impl) == "pjit":
        return warm_allocate_solve(ss.gathered(), pend_rows.to(ss.mesh.first), table, plan,
                                   config, k_min)
    return shard_solve.warm_allocate_shard_map(ss, pend_rows, table, plan, config, k_min)


def sentinel_sharded_warm_allocate_solve(snap, pend_rows, table, plan, config,
                                         k_min, mesh=None, impl=None):
    from kube_batch_tpu_torch.ops.invariants import allocate_invariants, eligibility_checksum

    ss = _placed(snap, mesh)
    res, table2, eroded = sharded_warm_allocate_solve(ss, pend_rows, table, plan, config,
                                                      k_min, impl=impl)
    g = ss.gathered()
    verdict, hist = allocate_invariants(g, res, config)
    return res, verdict, hist, eligibility_checksum(g), table2, eroded


def sharded_failure_histogram(snap, mesh=None, impl=None):
    """[T, N_REASONS] i32 over the mesh: per-shard partial counts, one sum."""
    from kube_batch_tpu_torch.ops.assignment import failure_histogram_solve
    from kube_batch_tpu_torch.parallel import shard_solve

    ss = _placed(snap, mesh)
    if _impl(impl) == "pjit":
        return failure_histogram_solve(ss.gathered())
    return shard_solve.failure_histogram_shard_map(ss)


def sharded_failure_histogram_bucket(snap, pend_rows, mesh=None, impl=None):
    """The histogram on the [P] pending bucket (1-D meshes)."""
    from kube_batch_tpu_torch.ops.assignment import failure_histogram_bucket_solve
    from kube_batch_tpu_torch.parallel import shard_solve

    ss = _placed(snap, mesh)
    _check_1d(ss, "the bucketed histogram")
    if _impl(impl) == "pjit":
        return failure_histogram_bucket_solve(ss.gathered(), pend_rows.to(ss.mesh.first))
    return shard_solve.failure_histogram_bucket_shard_map(ss, pend_rows)


def sharded_evict_solve(snap, config, mesh=None, impl=None):
    """``(EvictResult, rounds)`` of reclaim's or preempt's solve over the
    mesh: per-shard bids, the winners combined, the rounds' tail on the
    first device."""
    from kube_batch_tpu_torch.ops.eviction import evict_solve
    from kube_batch_tpu_torch.parallel import shard_solve

    ss = _placed(snap, mesh)
    if _impl(impl) == "pjit":
        return evict_solve(ss.gathered(), config)
    return shard_solve.evict_shard_map(ss, config)


def sentinel_sharded_evict_solve(snap, config, mesh=None, impl=None):
    """(result, rounds, verdict, hist, checksum)."""
    from kube_batch_tpu_torch.ops.invariants import eligibility_checksum, evict_invariants

    ss = _placed(snap, mesh)
    res, rounds = sharded_evict_solve(ss, config, impl=impl)
    g = ss.gathered()
    verdict, hist = evict_invariants(g, res, config)
    return res, rounds, verdict, hist, eligibility_checksum(g)


def sharded_probe_solve(snap, batch, probe_rows, mesh, config, evict_config,
                        with_evictions: bool = False, impl=None):
    """The batched what-if probe over the mesh: K1 per shard at the probe's
    rows, every ProbeResult field on the first device."""
    from kube_batch_tpu_torch.ops.probe import probe_solve
    from kube_batch_tpu_torch.parallel import shard_solve

    ss = _placed(snap, mesh)
    if _impl(impl) == "pjit":
        dev0 = ss.mesh.first
        return probe_solve(ss.gathered(), type(batch)(*(f.to(dev0) for f in batch)),
                           probe_rows.to(dev0), config, evict_config, with_evictions)
    return shard_solve.probe_shard_map(ss, batch, probe_rows, config, evict_config,
                                       with_evictions)


def dispatch_enqueue_gate(min_res, cand, idle0, quanta, n_nodes_padded: int,
                          mesh: Optional[Mesh], n_rows: Optional[int] = None):
    """The enqueue action's gate: on the mesh's first device when the
    cycle's solves shard and the shard bodies are on (the JAX package's
    replicated scan: one launch there, and one per rank under
    ``distributed``), else on the inputs' device.  The same kernel either
    way, so the verdicts are equal."""
    from kube_batch_tpu_torch.ops.admission import enqueue_gate

    if should_shard(n_nodes_padded, mesh) and shard_map_enabled():
        dev0 = mesh.first
        min_res, cand, idle0, quanta = (x.to(dev0) for x in (min_res, cand, idle0, quanta))
    return enqueue_gate(min_res, cand, idle0, quanta, n_rows)


#: the JAX audit's default abstract shapes (T, N, R, W, K)
_ABSTRACT = dict(T=16, N=8, R=3, W=1, K=1)


def collective_stats(mesh: Mesh, config=None, snap=None,
                     pend_bucket: Optional[int] = None,
                     shape: Optional[dict] = None) -> dict:
    """The collective inventory of the sharded allocate solve on ``mesh``
    at ``snap``'s shapes, under the JAX package's definition: each
    collective's RESULT bytes, split into per-round (inside the bidding
    loop) and per-solve sites, a site counted once however many rounds
    run.  With ``config.topk`` and ``pend_bucket`` the compacted program's,
    whose per-round bytes are 0.  Without ``snap`` the shapes are the JAX
    audit's abstract snapshot's, overridden by ``shape`` (keys T, N, R, W,
    K).  ``shard_solve.last_collectives`` holds what a solve actually
    moved, by the same definition."""
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig

    config = config or AllocateConfig()
    if snap is None:
        # the JAX audit's abstract snapshot, at ``shape``'s sizes
        T, N, R, W, K = (dict(_ABSTRACT, **(shape or {}))[k] for k in "TNRWK")
    else:
        if isinstance(snap, ShardedSnapshot):
            snap = snap.gathered()
        T, R = snap.task_req.shape
        N = snap.node_alloc.shape[0]
        W = snap.node_label_bits.shape[1]
        K = snap.task_aff_mask.shape[0]
    ts, ns = mesh.task_shards, mesh.node_shards
    ops = {"per_round": {}, "per_solve": {}}

    def site(phase, nbytes):
        rec = ops[phase].setdefault("all_gather", {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += int(nbytes)

    topk = bool(config.topk and pend_bucket)
    if topk:
        P, Kt = pend_bucket, config.topk
        site("per_solve", ns * P * (3 * Kt + 1) * 4)   # the candidate merge
        if ns > 1:
            for nbytes in (N * R * 4,) * 4 + (N, N) + (N * W * 4,) * 2:
                site("per_solve", nbytes)              # ledgers, node columns
            for nbytes in (K * N, K * N * 4, K * N * 4):
                site("per_solve", nbytes)              # the [K, N] rows
    else:
        T_blk = T // ts
        site("per_round", ns * 4 * T_blk * 4)          # the winner payload
        if ts > 1:
            for nbytes in (T * 4, T, T):               # best, has, chose
                site("per_round", nbytes)
        if ns > 1:
            for _ in range(3):
                site("per_solve", N * R * 4)           # the node ledgers
    per_round = sum(r["bytes"] for r in ops["per_round"].values())
    stats = {
        "per_round_bytes": per_round,
        "per_solve_bytes": sum(r["bytes"] for r in ops["per_solve"].values()),
        "per_round_bytes_expanded": per_round,
        # the round head sits in the inner bidding loop, whose trip count
        # is data-dependent
        "per_round_has_unbounded_inner_loop": bool(per_round),
        "ops": ops,
        "mesh": dict(mesh.shape),
        "task_bucket": int(T),
        "node_bucket": int(N),
    }
    if topk:
        stats["topk"] = int(config.topk)
        stats["pend_bucket"] = int(pend_bucket)
    return stats
