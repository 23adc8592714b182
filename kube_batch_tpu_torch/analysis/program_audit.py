"""Tier B: the device programs of the port, each run once under the
recorder and linted.

Mirrors ``kube_batch_tpu/analysis/jaxpr_audit.py``: a ``REGISTRY`` of the
programs the port dispatches (the solves, their sentinel twins, the
histograms, the resident scatter, the gate, the probe, K1 and K2), under
the JAX package's entry names wherever the port keeps the function, and
``sharded_registry(mesh)`` for the multi-device solves.  Where the JAX tier
traces each entry abstractly, an entry here runs on real tensors at a
shape point, made from ``SEED`` through ``testing/synthetic.py`` and
``api/convert.py``, under ``analysis/recorder.Recorder``:

- **KBT101** a float64 (or complex128) tensor anywhere in the program;
- **KBT102** a transfer beyond the uploads the entry declares
  (``uploads``): on the CPU only a copy to another device type shows,
  on a card every copy does;
- **KBT103** host syncs beyond the entry's budget ``syncs=(per_call,
  per_round)``: at most ``per_call + per_round × rounds`` — the torch
  form of a host callback, one host round trip each;
- **KBT104** an entry declaring ``in_place`` resident fields moved one:
  the resident tensor's ``data_ptr()`` changed across the call (the
  port's resident tensors are updated in place where the JAX package
  donates).

The budgets are ``PERF.md`` §3's "one readback per device program and per
bidding round", written per entry: a full solve reads back once per round
and once per outer pass (``AllocateConfig.outer`` at most), the compacted
and warm solves once more per round (the exhaustion test), an eviction
solve once per round, a probe once per round and three times per gang.

Suppression: ``allow={"KBT10x": "reason"}``; a reason is mandatory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kube_batch_tpu_torch.analysis.findings import Finding
from kube_batch_tpu_torch.analysis.memory_audit import ShapePoint
from kube_batch_tpu_torch.analysis.recorder import Recorder
from kube_batch_tpu_torch.api.convert import snapshot_from_numpy, snapshot_to_numpy
from kube_batch_tpu_torch.api.resident import (
    PerCycleDeviceCache,
    ShardedPerCycleDeviceCache,
    StagedUpload,
)
from kube_batch_tpu_torch.api.resources import GPU, ResourceSpec
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.ops.admission import enqueue_gate
from kube_batch_tpu_torch.ops.assignment import (
    AllocateConfig,
    allocate_solve,
    allocate_topk_solve,
    compact_candidates,
    failure_histogram_bucket_solve,
    failure_histogram_solve,
    pend_view,
    round_head_parts,
    warm_allocate_solve,
)
from kube_batch_tpu_torch.ops.eviction import EvictConfig, evict_solve
from kube_batch_tpu_torch.ops.feasibility import static_predicates
from kube_batch_tpu_torch.ops.invariants import (
    allocate_sentinel_solve,
    allocate_topk_sentinel_solve,
    enqueue_gate_sentinel_solve,
    evict_sentinel_solve,
    warm_allocate_sentinel_solve,
)
from kube_batch_tpu_torch.ops.kernels import NEG, masked_best_node_raw, masked_topk_blocks
from kube_batch_tpu_torch.ops.probe import ProbeBatch, probe_solve
from kube_batch_tpu_torch.ops.scoring import score_matrix
from kube_batch_tpu_torch.parallel import mesh as pm
from kube_batch_tpu_torch.parallel import shard_solve
from kube_batch_tpu_torch.parallel.mesh import (
    Mesh,
    dispatch_enqueue_gate,
    make_mesh,
    place_snapshot,
)
from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

AUDIT_RULES = {
    "KBT101": "float64 values in a device program",
    "KBT102": "device transfer beyond the program's declared uploads",
    "KBT103": "host syncs beyond the program's declared budget",
    "KBT104": "declared in-place update moved its resident tensor",
}

#: the seed the points' data is drawn from (``--seed``)
SEED = 0

#: the tier-B point: its task extents (T 1024, P 384) and node extents (N
#: 256 and its shards 128, 64, 32) differ from each other and from every
#: other extent at or above its floor, so that KBT202 and KBT204 can be
#: judged at a size the CPU runs in under a second per entry.  T/2 = J (the
#: job axis, padded to 512) is set aside as ambiguous, as the JAX tier sets
#: aside any shared extent; N is wide enough that a mesh scatter of three
#: rows costs less than the column
AUDIT_POINT = ShapePoint(
    name="audit", tasks=900, nodes=200, T=1024, N=256, J=512, Q=8, R=4, W=1,
    K_aff=1, P=384, topk=8, warm_w=24, warm_c=8, warm_pi=384, probe_b=2,
    probe_g=4, scatter_rows=256, floor=32,
)

#: gang width of the points' synthetic workloads (the JAX ladder's J = T / 4)
GANG = 4


@dataclasses.dataclass
class EntryPoint:
    """One device program.  ``build(point, device)`` returns ``(fn,
    args)``: ``fn(*args)`` is the call the audit records.  ``steady``: the
    program runs every cycle at scale (KBT202 applies).  ``syncs``: the
    (per call, per round) host-sync budget.  ``in_place``: resident fields
    the call must update in place, read through ``args[0].resident(f)``.
    ``uploads``: transfers the call may make.  ``allow``: rule → reason."""

    name: str
    build: Callable[[ShapePoint, torch.device], Tuple[Callable, Tuple]]
    steady: bool = False
    syncs: Tuple[int, int] = (0, 0)
    in_place: Tuple[str, ...] = ()
    uploads: int = 0
    allow: Dict[str, str] = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# the points' data
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PointData:
    """One point's workload: the host snapshot (numpy), its tensors on the
    device, the pending bucket's rows, and per mesh the placed snapshot."""

    sp: ShapePoint
    device: torch.device
    host: object
    snap: object
    pend_rows: torch.Tensor
    n_tasks: int
    placed: Dict = dataclasses.field(default_factory=dict)


_DATA: Dict = {}


def point_data(sp: ShapePoint, device) -> PointData:
    """The point's workload on ``device`` (the last one is kept): the
    synthetic generator's pending gangs at ``sp``'s pod and node counts
    and R resources, bitset words padded to W, sparse rows to K_aff and
    the job axis to J; only the gangs inside the first P task rows are
    schedulable, so the [P] bucket covers every schedulable pending row
    as the compacted programs require."""
    device = torch.device(device)
    key = (sp, str(device), SEED)
    hit = _DATA.get(key)
    if hit is not None:
        return hit
    _DATA.clear()
    spec = ResourceSpec(scalar_names=(GPU,) + tuple(
        f"example.com/r{i}" for i in range(sp.R - 4)))
    tensors, meta = synthetic_device_snapshot(sp.tasks, sp.nodes, gang_size=GANG, n_queues=3,
                                              seed=SEED, spec=spec, device="cpu")
    h = snapshot_to_numpy(tensors)._asdict()
    for f in ("task_sel_bits", "task_tol_bits", "node_label_bits", "node_taint_bits"):
        a = h[f]
        h[f] = np.concatenate([a, np.zeros((a.shape[0], sp.W - a.shape[1]), a.dtype)], 1)
    k = sp.K_aff - h["task_aff_idx"].shape[0]
    for f, fill in (("task_aff_idx", -1), ("task_pref_idx", -1)):
        h[f] = np.concatenate([h[f], np.full(k, fill, h[f].dtype)])
    for f, fill in (("task_aff_mask", True), ("task_pref_node", 0), ("task_pref_pod", 0)):
        h[f] = np.concatenate([h[f], np.full((k, h[f].shape[1]), fill, h[f].dtype)])
    J = h["job_min_avail"].shape[0]
    for f in ("job_min_avail", "job_ready", "job_queue", "job_prio", "job_creation",
              "job_valid", "job_schedulable", "job_allocated"):
        a = h[f]
        h[f] = np.concatenate([a, np.zeros((sp.J - J,) + a.shape[1:], a.dtype)])
    h["job_schedulable"] &= (np.arange(sp.J) + 1) * GANG <= sp.P
    host = type(tensors)(**h)
    rows = np.flatnonzero(h["task_pending"] & h["job_schedulable"][h["task_job"]])
    pend = np.full(sp.P, -1, np.int32)
    pend[:rows.size] = rows
    data = PointData(sp, device, host, snapshot_from_numpy(host, device),
                     torch.from_numpy(pend).to(device), meta.n_tasks)
    _DATA[key] = data
    return data


def placed(data: PointData, mesh):
    """``data``'s snapshot placed on ``mesh`` (kept per mesh)."""
    ss = data.placed.get(mesh)
    if ss is None:
        ss = data.placed[mesh] = place_snapshot(data.host, mesh)
    return ss


def _gate_inputs(data: PointData):
    """The enqueue gate's rows: each job's summed request as its
    MinResources, every valid job a candidate, the overcommitted idle."""
    h = data.host
    J = h.job_min_avail.shape[0]
    min_res = np.zeros((J, h.task_req.shape[1]), np.float32)
    np.add.at(min_res, h.task_job[h.task_valid], h.task_req[h.task_valid])
    idle0 = (h.total * np.float32(1.2)).astype(np.float32)
    dev = data.device
    return (torch.from_numpy(min_res).to(dev), torch.from_numpy(h.job_valid).to(dev),
            torch.from_numpy(idle0).to(dev), data.snap.quanta)


def _probe_inputs(data: PointData):
    """A [B, G] batch of gangs shaped like the workload's first gangs, and
    the [G] rows the next submitted pods would take."""
    sp, s, dev = data.sp, data.snap, data.device
    B, G = sp.probe_b, sp.probe_g
    req = torch.stack([s.task_req[b * G:(b + 1) * G] for b in range(B)])
    i32 = torch.int32
    batch = ProbeBatch(
        req=req, valid=torch.ones((B, G), dtype=torch.bool, device=dev),
        min_avail=torch.full((B,), G, dtype=i32, device=dev),
        queue=torch.arange(B, dtype=i32, device=dev) % 3,
        prio=torch.zeros(B, dtype=i32, device=dev),
        sel_bits=torch.zeros((B, sp.W), dtype=i32, device=dev),
        sel_impossible=torch.zeros(B, dtype=torch.bool, device=dev),
        tol_bits=torch.zeros((B, sp.W), dtype=i32, device=dev),
        min_res=req.sum(dim=1),
        has_min_res=torch.ones(B, dtype=torch.bool, device=dev),
    )
    rows = torch.arange(G, dtype=i32, device=dev) + data.n_tasks
    return batch, rows


def _warm_inputs(data: PointData):
    """A carried table and a steady plan: the table as the cold build made
    it at the stored width, every row carried, the first ``warm_c`` nodes
    changed, the first ``warm_pi`` rows re-ranked."""
    sp, dev, snap = data.sp, data.device, data.snap
    cfg = AllocateConfig(topk=sp.warm_w)
    rows = data.pend_rows
    view = pend_view(snap, rows)
    ki, ks, kh, nf, _ss, _tie = compact_candidates(
        view, rows, snap.node_idle, snap.node_releasing, snap.quanta, cfg)
    i32 = torch.int32
    plan = (torch.arange(sp.P, dtype=i32, device=dev), torch.arange(sp.warm_c, dtype=i32, device=dev),
            rows[:sp.warm_pi].clone(), torch.arange(sp.warm_pi, dtype=i32, device=dev))
    return (ki, ks, kh, nf > sp.warm_w), plan, cfg


# --------------------------------------------------------------------------
# the single-device entries
# --------------------------------------------------------------------------


def _build_allocate(sp, dev):
    return allocate_solve, (point_data(sp, dev).snap, AllocateConfig())


def _build_topk(sp, dev):
    d = point_data(sp, dev)
    return allocate_topk_solve, (d.snap, d.pend_rows, AllocateConfig(topk=sp.topk))


def _build_warm(sp, dev):
    d = point_data(sp, dev)
    table, plan, cfg = _warm_inputs(d)
    return warm_allocate_solve, (d.snap, d.pend_rows, table, plan, cfg, sp.topk)


def _build_histogram(sp, dev):
    return failure_histogram_solve, (point_data(sp, dev).snap,)


def _build_bucket_histogram(sp, dev):
    d = point_data(sp, dev)
    return failure_histogram_bucket_solve, (d.snap, d.pend_rows)


def _build_evict(mode, sp, dev):
    return evict_solve, (point_data(sp, dev).snap, EvictConfig(mode=mode))


def _build_gate(sp, dev):
    return enqueue_gate, _gate_inputs(point_data(sp, dev))


def _build_round_head(sp, dev):
    s = point_data(sp, dev).snap
    _head, static_ok, score = round_head_parts(s, AllocateConfig())
    return masked_best_node_raw, (score, static_ok, s.task_req, s.node_idle,
                                  s.node_releasing, s.task_pending, s.quanta)


def _build_topk_blocks(sp, dev):
    d = point_data(sp, dev)
    view = pend_view(d.snap, d.pend_rows)
    ss = torch.where(static_predicates(view), score_matrix(view, AllocateConfig().weights), NEG)
    rows = d.pend_rows.clamp(min=0).to(torch.int32)
    return masked_topk_blocks, (ss, view.task_req, d.snap.node_idle,
                                d.snap.node_releasing, rows, d.snap.quanta)


def _build_probe(topk, sp, dev):
    d = point_data(sp, dev)
    batch, rows = _probe_inputs(d)
    return probe_solve, (d.snap, batch, rows, AllocateConfig(topk=topk),
                         EvictConfig(mode="preempt"), True)


def _build_sentinel_allocate(sp, dev):
    return allocate_sentinel_solve, (point_data(sp, dev).snap, AllocateConfig())


def _build_sentinel_topk(sp, dev):
    d = point_data(sp, dev)
    return allocate_topk_sentinel_solve, (d.snap, d.pend_rows, AllocateConfig(topk=sp.topk))


def _build_sentinel_warm(sp, dev):
    d = point_data(sp, dev)
    table, plan, cfg = _warm_inputs(d)
    return warm_allocate_sentinel_solve, (d.snap, d.pend_rows, table, plan, cfg, sp.topk)


def _build_sentinel_evict(mode, sp, dev):
    return evict_sentinel_solve, (point_data(sp, dev).snap, EvictConfig(mode=mode))


def _build_sentinel_gate(sp, dev):
    return enqueue_gate_sentinel_solve, _gate_inputs(point_data(sp, dev))


class ResidentSwap:
    """A resident cache as a program: the first swap (at build) uploads
    every field; the audited call swaps a snapshot whose ``field`` moved in
    a few rows.  ``resident(f)`` is the cache's tensor (a placement →
    tensor dict on a mesh) for KBT104."""

    def __init__(self, cache, mesh=None):
        self.cache = cache
        self.mesh = mesh

    def _uploads(self):
        if self.mesh is None:
            return StagedUpload(self.cache.device)
        return {d: StagedUpload(d) for d in self.cache.devices}

    def __call__(self, host_snap):
        up = self._uploads()
        made = self.cache.stage(host_snap, up)
        for u in (up.values() if isinstance(up, dict) else (up,)):
            u.run()
        return {f: m() for f, m in made.items()}

    def resident(self, field: str):
        return self.cache._dev[field]


def _swap_program(sp, dev, field: str, mesh=None):
    """(``ResidentSwap``, the moved host snapshot): rows 1, 5 and 9 of
    ``field`` changed after a first full swap."""
    d = point_data(sp, dev)
    cache = PerCycleDeviceCache(dev) if mesh is None else ShardedPerCycleDeviceCache(mesh)
    swap = ResidentSwap(cache, mesh)
    swap(d.host)
    col = np.array(getattr(d.host, field))
    col[[1, 5, 9]] = col[[1, 5, 9]] - 1 if col.dtype != bool else ~col[[1, 5, 9]]
    return swap, d.host._replace(**{field: col})


def _build_scatter(sp, dev):
    swap, moved = _swap_program(sp, dev, "node_idle")
    return ResidentSwap.__call__, (swap, moved)


REGISTRY: Tuple[EntryPoint, ...] = (
    # the full program is the cold oracle; the compacted and warm programs
    # are what dispatches at scale
    EntryPoint("ops.assignment.allocate_solve", _build_allocate, syncs=(3, 1)),
    EntryPoint("ops.assignment.allocate_topk_solve", _build_topk, steady=True, syncs=(3, 2)),
    EntryPoint("ops.assignment.warm_allocate_solve", _build_warm, steady=True, syncs=(3, 2)),
    EntryPoint("ops.assignment.failure_histogram_solve", _build_histogram),
    EntryPoint("ops.assignment.failure_histogram_bucket_solve", _build_bucket_histogram),
    EntryPoint("ops.eviction.evict_solve[reclaim]", functools.partial(_build_evict, "reclaim"),
               steady=True, syncs=(0, 1)),
    EntryPoint("ops.eviction.evict_solve[preempt]", functools.partial(_build_evict, "preempt"),
               steady=True, syncs=(0, 1)),
    EntryPoint("api.resident.scatter", _build_scatter, steady=True,
               in_place=("node_idle",), uploads=1),
    EntryPoint("ops.admission.enqueue_gate", _build_gate, steady=True),
    EntryPoint("ops.kernels.masked_best_node_raw", _build_round_head),
    EntryPoint("ops.kernels.masked_topk_blocks", _build_topk_blocks),
    EntryPoint("ops.probe.probe_solve", functools.partial(_build_probe, 0), steady=True,
               syncs=(6, 1)),
    EntryPoint("ops.probe.probe_solve[topk-inert]", functools.partial(_build_probe, 8),
               steady=True, syncs=(6, 1)),
    EntryPoint("ops.invariants.allocate_sentinel_solve", _build_sentinel_allocate, syncs=(3, 1)),
    EntryPoint("ops.invariants.allocate_topk_sentinel_solve", _build_sentinel_topk,
               steady=True, syncs=(3, 2)),
    EntryPoint("ops.invariants.warm_allocate_sentinel_solve", _build_sentinel_warm,
               steady=True, syncs=(3, 2)),
    EntryPoint("ops.invariants.evict_sentinel_solve[reclaim]",
               functools.partial(_build_sentinel_evict, "reclaim"), steady=True, syncs=(0, 1)),
    EntryPoint("ops.invariants.evict_sentinel_solve[preempt]",
               functools.partial(_build_sentinel_evict, "preempt"), steady=True, syncs=(0, 1)),
    EntryPoint("ops.invariants.enqueue_gate_sentinel_solve", _build_sentinel_gate, steady=True),
)


# --------------------------------------------------------------------------
# the sharded entries
# --------------------------------------------------------------------------


def _sharded(fn_name: str, impl: str, mesh, args_fn, sp, dev):
    d = point_data(sp, dev)
    fn = functools.partial(getattr(pm, fn_name), impl=impl)
    return fn, args_fn(d, placed(d, mesh))


def _args_allocate(d, ss):
    return (ss, AllocateConfig())


def _args_topk(d, ss):
    return (ss, d.pend_rows, AllocateConfig(topk=d.sp.topk))


def _args_warm(d, ss):
    table, plan, cfg = _warm_inputs(d)
    return (ss, d.pend_rows, table, plan, cfg, d.sp.topk)


def _args_snap(d, ss):
    return (ss,)


def _args_bucket(d, ss):
    return (ss, d.pend_rows)


def _args_evict(mode):
    def args(d, ss):
        return (ss, EvictConfig(mode=mode))

    return args


def _args_probe(d, ss):
    batch, rows = _probe_inputs(d)
    return (ss, batch, rows, ss.mesh, AllocateConfig(), EvictConfig(mode="preempt"), True)


def _build_sharded_gate(mesh, sp, dev):
    d = point_data(sp, dev)
    return functools.partial(dispatch_enqueue_gate, n_nodes_padded=sp.N, mesh=mesh), \
        _gate_inputs(d)


def _build_shard_scatter(mesh, field, sp, dev):
    swap, moved = _swap_program(sp, dev, field, mesh)
    return ResidentSwap.__call__, (swap, moved)


def sharded_registry(mesh) -> Tuple[EntryPoint, ...]:
    """The sharded entries on ``mesh`` (a 1-D node mesh): every solve in
    both implementations (``shard_map``, the shard bodies; ``pjit``, the
    oracle), the gate, both mesh scatters, and with four positions or more
    the (tasks=2) grid's allocate body."""
    p = functools.partial
    n_dev = mesh.size
    up = len(mesh.distinct())
    entries = []
    for impl in ("shard_map", "pjit"):
        tag = f"[{impl}]"

        def e(name, fn_name, args_fn, **kw):
            entries.append(EntryPoint(f"parallel.mesh.{name}",
                                      p(_sharded, fn_name, impl, mesh, args_fn), **kw))

        e(f"sharded_allocate_solve{tag}", "sharded_allocate_solve", _args_allocate, syncs=(3, 1))
        e(f"sharded_allocate_topk_solve{tag}", "sharded_allocate_topk_solve", _args_topk,
          steady=True, syncs=(3, 2))
        e(f"sharded_warm_allocate_solve{tag}", "sharded_warm_allocate_solve", _args_warm,
          steady=True, syncs=(3, 2))
        e(f"sentinel_sharded_warm_allocate_solve{tag}", "sentinel_sharded_warm_allocate_solve",
          _args_warm, steady=True, syncs=(3, 2))
        e(f"sharded_failure_histogram{tag}", "sharded_failure_histogram", _args_snap)
        e(f"sharded_failure_histogram_bucket{tag}", "sharded_failure_histogram_bucket",
          _args_bucket)
        for mode in ("reclaim", "preempt"):
            e(f"sharded_evict_solve[{mode}]{tag}", "sharded_evict_solve", _args_evict(mode),
              steady=True, syncs=(0, 1))
        e(f"sharded_probe_solve{tag}", "sharded_probe_solve", _args_probe, steady=True,
          syncs=(6, 1))
        e(f"sentinel_sharded_allocate_solve{tag}", "sentinel_sharded_allocate_solve",
          _args_allocate, syncs=(3, 1))
        e(f"sentinel_sharded_allocate_topk_solve{tag}", "sentinel_sharded_allocate_topk_solve",
          _args_topk, steady=True, syncs=(3, 2))
        for mode in ("reclaim", "preempt"):
            e(f"sentinel_sharded_evict_solve[{mode}]{tag}", "sentinel_sharded_evict_solve",
              _args_evict(mode), steady=True, syncs=(0, 1))
    entries += [
        EntryPoint("parallel.mesh.dispatch_enqueue_gate", p(_build_sharded_gate, mesh),
                   steady=True),
        EntryPoint("api.resident.scatter_sharded", p(_build_shard_scatter, mesh, "node_idle"),
                   steady=True, in_place=("node_idle",), uploads=up),
        EntryPoint("api.resident.scatter_repl", p(_build_shard_scatter, mesh, "task_node"),
                   steady=True, in_place=("task_node",), uploads=up),
    ]
    if n_dev >= 4 and n_dev % 2 == 0:
        mesh2 = Mesh(mesh.devices, task_shards=2)
        entries.append(EntryPoint(
            "parallel.mesh.sharded_allocate_solve[shard_map,2d]",
            p(_sharded, "sharded_allocate_solve", "shard_map", mesh2, _args_allocate),
            syncs=(3, 1)))
    return tuple(entries)


# --------------------------------------------------------------------------
# running an entry
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What one recorded call did: the recorder; the in-place fields whose
    resident tensor moved and the residents' sizes; the sharded bodies'
    sites (collectives and moves, ``parallel/shard_solve``); the peak and
    base device bytes (on a card ``max_memory_allocated`` and
    ``memory_allocated`` before the call, on the CPU the recorder's);
    the CUDA sync-debug count of the same call when asked; the wall ms."""

    entry: str
    point: str
    device: str
    error: str = ""
    rec: Optional[Recorder] = None
    moved: List[str] = dataclasses.field(default_factory=list)
    resident_bytes: List[int] = dataclasses.field(default_factory=list)
    sites: List[dict] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    base_bytes: int = 0
    sync_debug: Optional[int] = None
    ms: float = 0.0


def _resident_tensors(x) -> List[torch.Tensor]:
    return list(x.values()) if isinstance(x, dict) else [x]


def run_entry(entry: EntryPoint, sp: ShapePoint, device, sync_debug: bool = False) -> Run:
    """Build ``entry`` at ``sp`` on ``device`` and record one call.  With
    ``sync_debug`` (a card only) the same call is also counted by CUDA's
    sync-debug mode (``testing/cycle_drive.count_syncs``)."""

    dev = resolve_device(device)
    run = Run(entry.name, sp.name, str(dev))
    try:
        fn, args = entry.build(sp, dev)
    except Exception as e:  # noqa: BLE001 — a broken entry must not read as clean
        run.error = f"{type(e).__name__}: {e}"
        return run
    ptrs = {}
    for f in entry.in_place:
        ts = _resident_tensors(args[0].resident(f))
        ptrs[f] = [t.data_ptr() for t in ts]
        run.resident_bytes += [t.numel() * t.element_size() for t in ts]
    before = dict(shard_solve.last_collectives)
    cuda = dev.type == "cuda"
    counter = contextlib.nullcontext([None])
    if cuda:
        torch.cuda.synchronize(dev)
        run.base_bytes = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        if sync_debug:
            from kube_batch_tpu_torch.testing.cycle_drive import count_syncs

            counter = count_syncs(dev)
    rec = run.rec = Recorder(dev)
    rec.charge(*args)
    t0 = time.perf_counter()
    try:
        with counter as box:
            with rec:
                out = fn(*args)
        if cuda:
            torch.cuda.synchronize(dev)
    except Exception as e:  # noqa: BLE001
        run.error = f"{type(e).__name__}: {e}"
        return run
    run.ms = (time.perf_counter() - t0) * 1e3
    run.sync_debug = box[0]
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    else:
        run.peak_bytes, run.base_bytes = rec.peak, rec.input_bytes
    for f in entry.in_place:
        if [t.data_ptr() for t in _resident_tensors(args[0].resident(f))] != ptrs[f]:
            run.moved.append(f)
    run.sites = [s for k, c in shard_solve.last_collectives.items() if before.get(k) is not c
                 for s in c.sites]
    del out
    return run


def cached_run(runs: Optional[Dict], entry: EntryPoint, sp: ShapePoint, device) -> Run:
    """:func:`run_entry`, reusing ``runs[(entry, point, device)]``."""
    if runs is None:
        return run_entry(entry, sp, device)
    key = (entry.name, sp.name, str(device))
    if key not in runs:
        runs[key] = run_entry(entry, sp, device)
    return runs[key]


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------


def judge(entry: EntryPoint, run: Run) -> List[Finding]:
    """KBT101–104 over one run (suppressed ones dropped; an allow with no
    reason is itself a KBT000)."""
    path = f"<programs:{entry.name}>"
    if run.error:
        return [Finding("KBT000", path, 0, 0, f"entry point failed to run: {run.error}")]
    rec = run.rec
    raw: List[Tuple[str, str]] = []
    wide = rec.wide_floats()
    if wide:
        raw.append(("KBT101", f"float64 values produced by {', '.join(wide)} — the snapshot "
                              "contract is f32; an f64 upcast doubles the bytes every "
                              "kernel moves"))
    if len(rec.transfers) > entry.uploads:
        kinds = sorted({f"{e.src}->{e.dst} by {e.op}" for e in rec.transfers})
        raw.append(("KBT102", f"{len(rec.transfers)} device transfer(s) where {entry.uploads} "
                              f"upload(s) are declared ({'; '.join(kinds[:4])}) — inputs "
                              "should arrive placed (the resident cache)"))
    per_call, per_round = entry.syncs
    budget = per_call + per_round * rec.rounds
    if len(rec.syncs) > budget:
        kinds = sorted({f"{e.kind} by {e.op}" for e in rec.syncs})
        raw.append(("KBT103", f"{len(rec.syncs)} host sync(s) over {rec.rounds} round(s) "
                              f"where {per_call} per call and {per_round} per round are "
                              f"declared ({'; '.join(kinds[:4])}) — each is a host round "
                              "trip"))
    if run.moved:
        raw.append(("KBT104", f"declared in-place field(s) {', '.join(run.moved)} moved to "
                              "a new tensor — the resident was reallocated, not updated in "
                              "place (double allocation on the card, and a holder of the "
                              "old tensor reads stale values)"))
    findings = []
    for rule, message in raw:
        reason = entry.allow.get(rule)
        if reason is not None:
            if not reason.strip():
                findings.append(Finding("KBT000", path, 0, 0,
                                        f"allow[{rule}] has no reason — suppression ignored"))
            continue
        findings.append(Finding(rule, path, 0, 0, message))
    return findings


def audit_entry(entry: EntryPoint, device=None, sp: ShapePoint = AUDIT_POINT,
                runs: Optional[Dict] = None) -> List[Finding]:
    """KBT101–104 over one entry at ``sp`` on ``device`` (None: the card,
    which raises without one)."""
    return judge(entry, cached_run(runs, entry, sp, resolve_device(device)))


def default_registry(device) -> Tuple[EntryPoint, ...]:
    """``REGISTRY`` and the sharded entries on the device's default audit
    mesh: eight positions on the CPU, four on one card (each card once
    when there are more)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 4
    else:
        devices = ["cpu"] * 8
    return tuple(REGISTRY) + sharded_registry(make_mesh(devices))


def run_audit(registry: Optional[Sequence[EntryPoint]] = None, device=None,
              select: Optional[Sequence[str]] = None, sp: ShapePoint = AUDIT_POINT,
              runs: Optional[Dict] = None) -> List[Finding]:
    """Every entry at ``sp`` on ``device`` (None: the card, which raises
    without one); ``select`` keeps a rule subset (and every KBT000)."""
    device = resolve_device(device)
    if registry is None:
        registry = default_registry(device)
    findings: List[Finding] = []
    for entry in registry:
        findings.extend(audit_entry(entry, device, sp, runs))
    if select is not None:
        wanted = set(select) | {"KBT000"}
        findings = [f for f in findings if f.rule in wanted]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
