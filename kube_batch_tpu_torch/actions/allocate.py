"""allocate action — the placement pass, solved on the device.

Mirrors ``kube_batch_tpu/actions/allocate.py``: build the session's
snapshot from the cache's column store (an isolated session's from its
cloned objects, ``api/snapshot.build_snapshot``), swap it for its
device-resident tensors (``api/columns.resident_snap``: only what changed
since the last swap is uploaded; an isolated session uploads it whole),
run the allocate solve
(predicates, scoring, fairness, ordering, gang commit/discard) on the
device, read the result back in one transfer, and replay it into host
state.  The replay is vectorized: jobs whose readiness gate is the gang
arithmetic and whose tasks carry no host-only constraints take a bulk path
(readiness from the snapshot's counts, whole-matrix ledger updates, one
bulk bind); jobs that need host predicates (ports, rich affinity) replay
through the per-task Statement path with the sequential semantics
(statement.go:29-337).  In a column session the bulk path is whole-matrix
column updates; in an isolated session it is per-job batched object
updates (``bulk_transition``, ``bulk_add_tasks``, batched events).

The dispatch is the JAX package's default:
the compacted solve when the pending rows fit the task capacity's one
pending bucket, the full [T, N] solve otherwise.  The compacted solve runs
warm-started by default (``KB_WARM``): its [P, W] candidate table is
carried on the device across cycles and repaired from the resident
swaps' delta records (``api/resident.WarmTableState`` plans on the host,
``ops/assignment.warm_allocate_solve`` refreshes on the device);
``KB_WARM=0`` rebuilds it cold every solve, the oracle.  A custom score
row (``Session.add_score_row``) defers the warm carry to the cold build
and the columnar host placement to the object scan: a row may read state
neither tracks.  The guard plane
(``KB_GUARD``, ``kube_batch_tpu_torch/guard``) follows every solve with
its invariant sentinel, read back with the result: a nonzero verdict
fails the action closed before any bind.  A demoted ``topk`` runs the
full solve, a demoted ``warm`` the cold build, and every
``KB_AUDIT_EVERY``-th engaged dispatch is compared with the full solve
after the host replay.  The fit-error histogram reads the same resident
tensors as the solve, launched before the host replay and read after it,
with no swap in between.  When a query plane is attached
(``serve/plane.py``), every cycle publishes its what-if lease here
(``republish_query_lease``): after the solve's swap, and on the idle and
empty paths when ingest moved the version since the last publish.

Each phase runs in a span of the cache's tracer (``obs/trace.py``), under
the action's own: ``snapshot_build``, ``solve_dispatch`` (a device span,
with the warm plan's ``table_invalidate`` under it), ``audit_dispatch``,
``device_wait`` (the one readback, where the device time lands),
``fit_histogram_dispatch``, ``host_replay`` and ``fit_errors``.  The
replay feeds the per-task latency, slow-replay and host-fallback series
(``metrics/``).

The sharded solve (``parallel/``): when the session's mesh shards the
node axis (``Session.mesh``, ``parallel/mesh.should_shard``), the swap
places the snapshot on the mesh (``resident_snap(cols, snap, mesh)``) and
the same dispatch runs the mesh's full, compacted or warm solve — K1 or
K2 per shard — with ``shard_map`` first in ``engaged``, demoted by the
guard to the ``"pjit"`` oracle; ``mode`` is then "sharded".  A 2-D mesh
declines compaction, as the JAX package's dispatch does.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.api.cluster_info import ClusterInfo
from kube_batch_tpu_torch.api.columns import resident_snap
from kube_batch_tpu_torch.api.convert import read_back
from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot, SnapshotMeta, build_snapshot
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import JOB_READY, NODE_ORDER, FitFailure
from kube_batch_tpu_torch.guard import (
    consume_assignment_sentinel,
    guard_of,
    make_heal,
    sentinel_bundle_thunk,
)
from kube_batch_tpu_torch.obs.trace import tracer_of
from kube_batch_tpu_torch.ops.assignment import (
    AllocateConfig,
    AllocateResult,
    allocate_solve,
    allocate_topk_solve,
    failure_histogram_bucket_solve,
    failure_histogram_solve,
)
from kube_batch_tpu_torch.utils import telemetry

logger = logging.getLogger("kube_batch_tpu_torch")

#: the pending-row bucket ladder: the compacted solve's task axis is the
#: largest rung at or below capT/4, so its shape only moves with the task
#: capacity bucket, never with the pending count
TOPK_PEND_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)

#: default candidate-table width; the exhaustion re-entry keeps any width
#: exact, so K tunes cost, never correctness
TOPK_DEFAULT = 32


def resolve_topk() -> int:
    """KB_TOPK: the candidate-table width K (default 32); 0 disables
    compaction and keeps the full solve.  An unparsable value disables
    compaction."""
    raw = os.environ.get("KB_TOPK", "").strip()
    if not raw:
        return TOPK_DEFAULT
    try:
        return max(0, int(raw))
    except ValueError:
        logger.warning("unparsable KB_TOPK=%r; compaction disabled", raw)
        return 0


def topk_bucket_for(capT: int) -> Optional[int]:
    """The one pending bucket a task capacity of ``capT`` compacts into, or
    None below the smallest rung."""
    fit = [b for b in TOPK_PEND_BUCKETS if b <= capT // 4]
    return fit[-1] if fit else None


def plan_topk_bucket(snap: DeviceSnapshot, k: int):
    """(pend_rows [P] np.int32, K), or (None, 0) when the full solve should
    run: K no smaller than the node bucket, a task bucket below the
    smallest rung, no pending rows, or more pending rows than the bucket
    (the cold-start regime).  ``snap`` holds tensors or numpy arrays;
    ``task_pending`` is read on the host (a device read for a snapshot on
    the card)."""
    capT = int(snap.task_req.shape[0])
    capN = int(snap.n_nodes if hasattr(snap, "n_nodes") else snap.node_idle.shape[0])
    if k <= 0 or k >= capN:
        return None, 0
    bucket = topk_bucket_for(capT)
    if bucket is None:
        return None, 0
    pending = snap.task_pending
    if isinstance(pending, torch.Tensor):
        pending = pending.cpu().numpy()
    rows = np.flatnonzero(pending)
    if rows.size == 0 or rows.size > bucket:
        return None, 0
    pend_rows = np.full(bucket, -1, np.int32)
    pend_rows[: rows.size] = rows.astype(np.int32)
    return pend_rows, k


def resolve_warm() -> bool:
    """KB_WARM: carry the candidate table across cycles (default on
    whenever compaction runs); KB_WARM=0 builds it cold every solve, the
    oracle.  Any value other than empty, 1, true, on or yes turns it OFF
    (a mistyped attempt to disable it must not leave it on), unlike the
    kill switches of ``utils/switches``."""
    raw = os.environ.get("KB_WARM", "").strip().lower()
    if not raw:
        return True
    return raw in ("1", "true", "on", "yes")


def warm_k_min(k: int) -> int:
    """The erosion floor of the carried table: a row re-ranks when its
    valid prefix thins below (a per-row staggered threshold above) K/4.
    A thin table still answers exactly; the floor trades re-rank traffic
    against fallback probability (``topk_exhausted``)."""
    return max(4, k // 4)


def dispatch_topk(guard) -> int:
    """The candidate width the dispatch may use: KB_TOPK, or 0 (the full
    solve) while the guard has ``topk`` demoted."""
    if guard is not None and not guard.allow("topk"):
        return 0
    return resolve_topk()


def _warm_state(cols, device, config, guard, warm: bool, k: int, impl=None):
    """The carried-table state for this dispatch, or None when the warm
    path must not run: an explicitly cold caller (backfill's pass solves a
    mid-cycle snapshot and must not consume allocate's deltas), no column
    store, no compaction, KB_WARM off, a custom score row (it may read
    state the invalidation does not track), or the guard's demotion.
    Called before the resident swap, so a fresh state absorbs this
    cycle's delta record and plans a cold build."""
    if (not warm or cols is None or k <= 0 or not resolve_warm()
            or config.weights.extra_rows
            or (guard is not None and not guard.allow("warm"))):
        return None
    return cols.warm_table_state(device, impl)


def _warm_commit(wstate, call):
    """Run one warm solve and adopt its refreshed table (the last two
    outputs).  Any failure drops the carried state and raises: plan()
    already consumed the invalidation accumulators."""
    try:
        out = call()
    except BaseException:
        wstate.drop()
        raise
    wstate.commit(out[-2], out[-1])
    return out


def _upload_i32(device, *arrays):
    """int32 numpy arrays as tensors on ``device``, in one pinned,
    non-blocking transfer (no host sync)."""
    from kube_batch_tpu_torch.api.resident import StagedUpload

    up = StagedUpload(device)
    handles = [up.add(np.ascontiguousarray(a, np.int32)) for a in arrays]
    up.run()
    return [up.tensor(h) for h in handles]


def _warm_plan(state, cols, pend_rows, k: int, config, tracer):
    """The post-swap invalidation plan (``WarmTableState.plan``), in a
    ``table_invalidate`` span under the caller's solve_dispatch span when
    a tracer is given.  None: the delta chain is broken this cycle, and
    the dispatch takes the cold per-solve build."""
    if state is None:
        return None
    if tracer is None:
        return state.plan(cols, pend_rows, k, config)
    with tracer.span("table_invalidate") as sp:
        plan = state.plan(cols, pend_rows, k, config)
        if plan is not None:
            sp.set(cold=bool(plan["cold"]),
                   reranked=int(state.last.get("reranked", 0)),
                   changed=int(state.last.get("changed", 0)))
    return plan


def _solves(snap, impl):
    """The (full, compacted, warm) solves and their sentinel twins for
    ``snap``: the single-device ones, or for a ``ShardedSnapshot`` the
    mesh's (``parallel/mesh.py``) at ``impl``."""
    from kube_batch_tpu_torch.ops import invariants as inv
    from kube_batch_tpu_torch.ops.assignment import warm_allocate_solve
    from kube_batch_tpu_torch.parallel import mesh as pm

    if not isinstance(snap, pm.ShardedSnapshot):
        return (allocate_solve, inv.allocate_sentinel_solve,
                allocate_topk_solve, inv.allocate_topk_sentinel_solve,
                warm_allocate_solve, inv.warm_allocate_sentinel_solve)

    def bind(fn):
        return lambda *a: fn(*a, impl=impl)

    return (bind(pm.sharded_allocate_solve), bind(pm.sentinel_sharded_allocate_solve),
            bind(pm.sharded_allocate_topk_solve),
            bind(pm.sentinel_sharded_allocate_topk_solve),
            bind(pm.sharded_warm_allocate_solve),
            bind(pm.sentinel_sharded_warm_allocate_solve))


def dispatch_allocate_solve(snap: DeviceSnapshot, config: AllocateConfig,
                            plan=None, cols=None, guard=None, wstate=None,
                            tracer=None):
    """``(result, mode, topk_info, ginfo)`` for one allocate pass over the
    device snapshot ``snap``, on the device its tensors lie on.  ``mode``
    is "single", or "sharded" for a ``ShardedSnapshot`` (``snap`` placed
    on a mesh: the sharded solves, ``"pjit"`` while the guard has
    ``shard_map`` demoted); ``topk_info`` is ``{"k", "bucket"}`` (plus
    ``"warm"``, the plan's record, when the warm program ran) for the
    compacted solve, None for the full solve.  ``plan`` is
    :func:`plan_topk_bucket`'s answer when the caller has it (a 2-D mesh
    declines compaction, as the JAX package's dispatch does); ``wstate``
    the carried-table state (:func:`_warm_state`, taken before the swap)
    that lets the compacted solve run warm when its plan allows.

    ``guard`` (a :class:`GuardPlane`) makes the dispatch guarded: the
    sentinel variants run and ``ginfo["sentinel"]`` holds their (verdict,
    hist, checksum) tensors for the caller's readback, which must feed
    them to the guard before acting on the result.  ``ginfo`` also holds
    the engaged fast paths, the bucket rows, the implementation, the
    snapshot and the effective config (what a trip bundle replays).
    ``tracer`` attributes the warm plan as a ``table_invalidate`` child of
    the caller's span."""
    from kube_batch_tpu_torch.parallel import mesh as pm

    sentinel_on = guard is not None and guard.enabled
    sharded = isinstance(snap, pm.ShardedSnapshot)
    impl = None
    if sharded and guard is not None and not guard.allow("shard_map"):
        impl = "pjit"  # shard_map demoted: the oracle
    if plan is None:
        plan = plan_topk_bucket(snap, dispatch_topk(guard))
        if sharded and snap.mesh.task_shards != 1:
            plan = (None, 0)
    pend_rows, k = plan
    mode = "sharded" if sharded else "single"
    base = ["shard_map"] if sharded and pm._impl(impl) == "shard_map" else []
    full, full_s, topk, topk_s, warm, warm_s = _solves(snap, impl)

    def ginfo(engaged, sentinel, cfg):
        return {"engaged": base + engaged, "sentinel": sentinel, "pend_rows": pend_rows,
                "impl": impl, "dev": snap, "config": cfg}

    dev = snap.mesh.first if sharded else snap.task_req.device
    if pend_rows is not None:
        info = {"k": k, "bucket": int(pend_rows.shape[0])}
        cfg = config._replace(topk=k)
        wplan = _warm_plan(wstate, cols, pend_rows, k, config, tracer)
        if wplan is not None:
            info["warm"] = dict(wstate.last)
            # the plan's rungs: the merge prefix M, the changed-node block C
            # and the re-rank sub-bucket (K2's rows on this path)
            info["rungs"] = {"merge": int(wplan["row_map"].shape[0]),
                             "changed": int(wplan["changed"].shape[0]),
                             "rerank": int(wplan["rerank_rows"].shape[0])}
            cfg_w = config._replace(topk=wplan["w"])
            rows, *ptuple = _upload_i32(dev, pend_rows, wplan["row_map"], wplan["changed"],
                                        wplan["rerank_rows"], wplan["rerank_slots"])
            if sentinel_on:
                res, v, h, e, _t, _er = _warm_commit(
                    wstate, lambda: warm_s(snap, rows, wplan["table"], ptuple, cfg_w,
                                           warm_k_min(k)))
                # the effective config (topk = W): a bundle replays the
                # cold compacted program at the condemned width
                return res, mode, info, ginfo(["topk", "warm"], (v, h, e), cfg_w)
            res, _t, _er = _warm_commit(
                wstate, lambda: warm(snap, rows, wplan["table"], ptuple, cfg_w,
                                     warm_k_min(k)))
            return res, mode, info, ginfo(["topk", "warm"], None, cfg_w)
        rows = torch.from_numpy(pend_rows).to(dev)
        if sentinel_on:
            res, v, h, e = topk_s(snap, rows, cfg)
            return res, mode, info, ginfo(["topk"], (v, h, e), cfg)
        return topk(snap, rows, cfg), mode, info, ginfo(["topk"], None, cfg)
    if sentinel_on:
        res, v, h, e = full_s(snap, config)
        return res, mode, None, ginfo([], (v, h, e), config)
    return full(snap, config), mode, None, ginfo([], None, config)


def dispatch_allocate_oracle(dev, config: AllocateConfig):
    """The shadow-oracle dispatch of an engaged allocate: the full program
    (no compaction, no carry) on the same tensors; the ``"pjit"`` oracle
    (the single-device program over the gathered snapshot) when the
    committed solve ran sharded."""
    from kube_batch_tpu_torch.parallel import mesh as pm

    oracle_cfg = config._replace(topk=0)
    if isinstance(dev, pm.ShardedSnapshot):
        return pm.sharded_allocate_solve(dev, oracle_cfg, impl="pjit")
    return allocate_solve(dev, oracle_cfg)


def solve_target(ssn, n_nodes_padded: int):
    """Where a session's device programs run for a node axis of
    ``n_nodes_padded``: the session's mesh when it shards
    (``parallel/mesh.should_shard``), else its device."""
    from kube_batch_tpu_torch.parallel.mesh import should_shard

    mesh = getattr(ssn, "mesh", None)
    return mesh if should_shard(n_nodes_padded, mesh) else ssn.device


def _dispatch_impl(guard) -> str:
    """The sharded implementation the dispatch will run: ``"pjit"`` while
    the guard has ``shard_map`` demoted, else ``KB_SHARD_MAP``'s."""
    from kube_batch_tpu_torch.parallel.mesh import _impl

    return _impl(None if guard is None or guard.allow("shard_map") else "pjit")


def dispatch_failure_histogram(dev, pend_rows):
    """The fit-error histogram on the tensors the solve read: on the [P]
    bucket when the compacted solve planned one, else [T, N]; on the mesh
    for a ``ShardedSnapshot`` (a 2-D mesh never plans a bucket)."""
    from kube_batch_tpu_torch.parallel import mesh as pm

    if isinstance(dev, pm.ShardedSnapshot):
        if pend_rows is not None:
            rows = torch.from_numpy(pend_rows).to(dev.mesh.first)
            return pm.sharded_failure_histogram_bucket(dev, rows)
        return pm.sharded_failure_histogram(dev)
    if pend_rows is not None:
        rows = torch.from_numpy(pend_rows).to(dev.task_req.device)
        return failure_histogram_bucket_solve(dev, rows)
    return failure_histogram_solve(dev)


def republish_query_lease(ssn, snap=None, meta=None, build=None) -> None:
    """The what-if lease publish: every publish path (allocate's solve and
    its idle and empty cycles, and the re-arms after reclaim's, preempt's
    and backfill's swaps) goes through here, so the gate, the version
    token and the failure policy live once.

    Every swap retires the published lease (``serve/lease.py``), and
    reclaim, backfill and preempt all swap after allocate's publish, so
    each re-arms right after its dispatch, or serving would stay dark
    until the next cycle's allocate.  ``resident_snap`` is memoized on the
    ``snap`` object the caller's dispatch used, so a re-arm does no device
    work.  ``build`` is the lazy (snap, meta) builder of the idle and
    empty paths: it runs only when a publish is owed (a plane attached, a
    column session, and no live lease at the open's version).  A failed
    publish degrades serving, never the cycle."""
    qp = getattr(ssn.cache, "query_plane", None)
    if qp is None or ssn.columns is None:
        return
    try:
        if not qp.needs_publish(int(getattr(ssn.cache, "last_open_version", 0))):
            return
        if build is not None:
            snap, meta = build()
        qp.publish_session(ssn, snap, meta)
    except Exception:  # noqa: BLE001 — the write path outranks serving
        logger.exception("whatif lease publication failed")


def result_binds(res: AllocateResult, meta: SnapshotMeta) -> List[Tuple[str, str]]:
    """The (task key, node name) pairs the host replay would bind, in task
    order: every surviving non-pipelined placement (after the solve's last
    revert, each belongs to a committed job).  Pipelined placements wait
    for their node's releasing capacity and are not bound."""
    assigned, pipelined = read_back((res.assigned, res.pipelined))
    assigned, pipelined = assigned[: meta.n_tasks], pipelined[: meta.n_tasks]
    rows = np.flatnonzero((assigned >= 0) & ~pipelined)
    return [(meta.task_keys[t], meta.node_names[assigned[t]])
            for t in rows.tolist()]


def _run_bounds(sorted_arr) -> list:
    """[lo, hi) boundaries of the runs of equal values in a sorted array."""
    return np.concatenate(
        ([0], np.flatnonzero(np.diff(sorted_arr)) + 1, [sorted_arr.size])
    ).tolist()


class _PhaseMarks:
    """Accumulating wall-clock marks: each ``mark(key)`` charges the time
    since the previous mark to ``sink[key]`` in ms."""

    def __init__(self, sink: Dict[str, float]):
        self.sink = sink
        self.t = telemetry.perf_counter()

    def mark(self, key: str) -> None:
        now = telemetry.perf_counter()
        self.sink[key] = self.sink.get(key, 0.0) + (now - self.t) * 1e3
        self.t = now


def build_session_snapshot(ssn):
    """(DeviceSnapshot of numpy arrays, SnapshotMeta) for the session: from
    the cache's column store in an exclusive session, from the cloned
    objects in an isolated one.  Allocate and backfill's pass share it, so
    both solve the identically built problem."""
    cols = ssn.columns
    if cols is not None:
        return cols.device_snapshot(ssn)
    cluster = ClusterInfo(ssn.spec)
    cluster.nodes = ssn.nodes
    cluster.queues = ssn.queues
    cluster.jobs = ssn.jobs
    return build_snapshot(cluster, excluded_nodes=ssn.session_excluded_nodes)


def session_allocate_config(ssn) -> AllocateConfig:
    """The solve configuration a session implies: plugin enables and the
    session's score weights."""
    return AllocateConfig(
        gang=ssn.plugin_enabled("gang"),
        drf=ssn.plugin_enabled("drf"),
        proportion=ssn.plugin_enabled("proportion"),
        weights=ssn.score_weights,
    )


def _read_back(res: AllocateResult, T: int, sentinel=None):
    """(assigned [T] i32, pipelined [T] bool, rounds_run, topk_exhausted,
    topk_reentries, verdict, hist, checksum) of the first T task rows in
    ONE device-to-host transfer (``read_back``); the sentinel's (verdict,
    hist, checksum) ride it (0, None, 0 without a sentinel), so the guard
    adds no transfer.  The result rows are the padded task axis; an object
    snapshot has fewer live tasks (T) than rows."""
    parts = [res.assigned, res.pipelined, res.rounds_run, res.topk_exhausted,
             res.topk_reentries]
    if sentinel is not None:
        parts += list(sentinel)
    got = read_back(parts)
    out = (got[0][:T], got[1][:T], int(got[2]), int(got[3]), int(got[4]))
    if sentinel is None:
        return out + (0, None, 0)
    verdict, hist, check = got[5:]
    return out + (int(verdict), hist, int(check))


class AllocateAction(Action):
    name = "allocate"

    def __init__(self):
        # per-phase ms of the most recent execute(): snapshot_build, upload,
        # solve (dispatch and readback), fit_errors, replay (+ replay_*)
        self.last_phase_ms: Dict[str, float] = {}
        # bidding rounds the last solve ran
        self.last_solve_rounds = 0
        # "single" | "sharded": which solve the last execute dispatched
        self.last_solve_mode = "single"
        # {"k", "bucket", "exhausted", "reentries"} when the compacted
        # program ran, None for the full program
        self.last_topk = None
        # the warm plan's record ({"cold", "reranked", "changed",
        # "bucket_live", "w", "new", "dirty", "eroded"}) when the carried
        # table program ran, None otherwise
        self.last_warm = None
        # whether the last execute dispatched the fit-error histogram
        self.last_fit_histogram = False
        # fallback pressure: slow-replay jobs, host-ports jobs promoted back
        # to the bulk path, jobs the volume pre-check demoted, tasks placed
        # by the host scan
        self.last_fallback: Dict[str, int] = {}
        # jobs whose placements were discarded host-side this execute()
        self.last_host_discards = 0
        self._host_place_count = 0
        # placements applied this execute (bulk-committed and
        # statement-committed): the per-task latency's sample count
        self._n_applied = 0
        self._ports_by_node: Optional[Dict[int, list]] = None

    def execute(self, ssn) -> None:
        self.last_phase_ms = {}
        self.last_fallback = {}
        self.last_host_discards = 0
        self.last_solve_rounds = 0
        self.last_topk = None
        self.last_warm = None
        self.last_fit_histogram = False
        self._host_place_count = 0
        self._n_applied = 0
        self._ports_by_node = None
        if not ssn.jobs or not ssn.nodes:
            # an empty (or node-less) cluster still serves what-ifs
            republish_query_lease(ssn, build=lambda: build_session_snapshot(ssn))
            return
        cols = ssn.columns
        if cols is not None and not cols.has_schedulable_pending():
            # idle cycle: nothing schedulable anywhere — skip the snapshot,
            # the solve and the replay
            self.last_phase_ms = {"snapshot_build": 0.0, "upload": 0.0,
                                  "solve": 0.0, "fit_errors": 0.0, "replay": 0.0}
            # an idle cluster is when capacity-planning what-ifs arrive: the
            # lease is rebuilt only when ingest moved the version
            republish_query_lease(ssn, build=lambda: build_session_snapshot(ssn))
            return
        tracer = tracer_of(ssn.cache)
        t0 = telemetry.perf_counter()
        with tracer.span("snapshot_build"):
            snap, meta = build_session_snapshot(ssn)
        t1 = telemetry.perf_counter()
        gp = guard_of(ssn.cache)
        config = session_allocate_config(ssn)
        # a device span: the resident swap's scatters land on it.  Its
        # stamps hold the upload and the launches; the device time lands
        # in device_wait, whose readback waits for it
        with tracer.device_span("solve_dispatch", cols=cols) as sp_solve:
            # the session's mesh when the node axis shards, else its device
            target = solve_target(ssn, snap.node_alloc.shape[0])
            sharded = target is not ssn.device
            # the bucket plan from the host's own pending mask: no device
            # read; a 2-D mesh declines compaction
            plan = plan_topk_bucket(snap, dispatch_topk(gp))
            if sharded and target.task_shards != 1:
                plan = (None, 0)
            # the carried-table state is taken before the swap, so a fresh
            # one absorbs this swap's delta record
            wstate = (_warm_state(cols, target, config, gp, True, plan[1],
                                  impl=_dispatch_impl(gp) if sharded else None)
                      if plan[0] is not None else None)
            dev = resident_snap(cols, snap, target)
            # kbt: allow[KBT014] the upload/solve split of last_phase_ms (a port-only key); a child
            # span here would change the cycle's span tree, which is held equal to
            # the JAX package's
            t_up = telemetry.perf_counter()
            result, mode, topk_info, ginfo = dispatch_allocate_solve(
                dev, config, plan=plan, cols=cols, guard=gp, wstate=wstate,
                tracer=tracer)
        self.last_solve_mode = mode
        sp_solve.set(mode=mode, engaged=list(ginfo["engaged"]))
        if sharded:
            tracer.annotate_collectives(sp_solve, ginfo["config"], snap, target,
                                        pend_rows=ginfo.get("pend_rows"))
        # the shadow-oracle audit: every KB_AUDIT_EVERY-th engaged dispatch
        # runs the full solve (no compaction, no carry) on the same tensors
        # now, before any swap, and is compared after the host replay
        audit_dev = None
        if ginfo["engaged"] and gp.audit_due("allocate"):
            with tracer.device_span("audit_dispatch"):
                audit_dev = dispatch_allocate_oracle(dev, config)
        # the lease shares this dispatch's swap (memoized on the same snap)
        republish_query_lease(ssn, snap, meta)
        sentinel = ginfo["sentinel"]
        T = meta.n_tasks
        with tracer.device_span("device_wait") as sp_wait:
            (assigned, pipelined, rounds, exhausted, reentries, verdict, vhist,
             echeck) = _read_back(result, T, sentinel)
        sp_wait.set(rounds=int(rounds))
        self.last_solve_rounds = rounds
        if topk_info is not None:
            topk_info = dict(topk_info, exhausted=exhausted, reentries=reentries)
        self.last_topk = topk_info
        self.last_warm = (topk_info or {}).get("warm")
        if sentinel is not None and not consume_assignment_sentinel(
                gp, "allocate", ssn, snap, meta, ginfo, verdict, vhist, echeck,
                assigned, extra_report={"mode": mode}):
            # the solve is condemned: fail closed — no replay, no binds, no
            # fit errors (the guard demoted, healed and dumped already)
            self.last_phase_ms.update(
                snapshot_build=(t1 - t0) * 1e3, upload=(t_up - t1) * 1e3,
                solve=(telemetry.perf_counter() - t_up) * 1e3, fit_errors=0.0,
                replay=0.0)
            return
        t2 = telemetry.perf_counter()
        task_job = snap.task_job[:T]
        # fit errors only for tasks of jobs that are in this session (the row
        # space also carries rows of jobs the session dropped)
        pending = snap.task_pending[:T] & snap.job_valid[task_job]
        # the histogram is its own dispatch, launched before the host replay
        # and read after it, so the device computes it while the host
        # replays; only cycles with unplaced pending tasks pay it
        fail_hist_dev = None
        if bool(np.any(pending & (assigned < 0))):
            self.last_fit_histogram = True
            pend_rows = plan[0]
            with tracer.device_span("fit_histogram_dispatch"):
                fail_hist_dev = dispatch_failure_histogram(dev, pend_rows)
        t_fit1 = telemetry.perf_counter()
        with tracer.span("host_replay"):
            self._replay(ssn, snap, meta, assigned, pipelined, task_job)
        t3 = telemetry.perf_counter()
        if fail_hist_dev is not None:
            with tracer.device_span("fit_errors"):
                self._record_fit_errors(ssn, meta, fail_hist_dev.cpu().numpy(),
                                        assigned, task_job, pending)
        t4 = telemetry.perf_counter()
        # update, not replace: _replay folded its replay_* sub-phases in
        self.last_phase_ms.update(
            snapshot_build=(t1 - t0) * 1e3,
            upload=(t_up - t1) * 1e3,
            solve=(t2 - t_up) * 1e3,
            fit_errors=((t_fit1 - t2) + (t4 - t3)) * 1e3,
            replay=(t3 - t_fit1) * 1e3,
        )
        if self._n_applied:
            # the per-task latency, amortized over the placements actually
            # applied, so the histogram's count is the placements
            # (metrics.go:66-72)
            metrics.observe_task_latencies((t4 - t0) * 1e6 / self._n_applied,
                                           self._n_applied)
        if audit_dev is not None:
            self._compare_audit(ssn, gp, ginfo, audit_dev, assigned, pipelined, T, mode)

    # ------------------------------------------------------------------
    def _compare_audit(self, ssn, gp, ginfo, audit_dev, assigned, pipelined,
                       T: int, mode: str = "single") -> None:
        """Compare the committed fast-path result with the shadow oracle
        (read back after the host replay)."""
        a_assigned, a_pipelined = read_back((audit_dev.assigned, audit_dev.pipelined))
        mism = int(np.sum(a_assigned[:T] != assigned)
                   + np.sum(a_pipelined[:T] != pipelined))
        report = {"audit_mismatches": mism, "engaged": ginfo["engaged"],
                  "mode": mode}
        gp.note_audit(
            "allocate", ginfo["engaged"], mism == 0,
            detail=f"fast-vs-oracle mismatch at {mism} task rows",
            dump=sentinel_bundle_thunk(gp, "allocate", ginfo["dev"], ginfo["config"],
                                       report, pend_rows=ginfo.get("pend_rows")),
            heal=make_heal(ssn))

    # ------------------------------------------------------------------
    def _replay(self, ssn, snap, meta, assigned, pipelined, task_job) -> None:
        placed = np.flatnonzero(assigned >= 0)
        if placed.size == 0:
            return
        _mark = _PhaseMarks(self.last_phase_ms).mark
        # group placements by job, keeping device task order within a job
        order = np.argsort(task_job[placed], kind="stable")
        placed = placed[order]
        pjobs = task_job[placed]
        bounds = _run_bounds(pjobs)

        # the bulk path is sound only when the gang arithmetic is the whole
        # JobReady gate (gang.go:122-129: snapshot ready count + new
        # allocations vs min_available)
        gang_only_ready = ssn.enabled_plugin_names(JOB_READY) <= {"gang"}
        nJ, nN = len(meta.job_objs), len(meta.node_names)
        resreq64 = meta.task_resreq64
        R = resreq64.shape[1]
        pipe_flags = pipelined[placed]
        n_alloc_per_job = np.bincount(pjobs[~pipe_flags], minlength=nJ)
        if ssn.plugin_enabled("gang"):
            committed = (snap.job_ready[:nJ] + n_alloc_per_job) >= snap.job_min_avail[:nJ]
        else:
            # no gang plugin ⇒ JobReady is vacuously true
            committed = np.ones(nJ, bool)
        job_slow = np.zeros(nJ, bool)
        if not gang_only_ready or ssn.host_only_predicates:
            job_slow[:] = True
        else:
            np.logical_or.at(job_slow, pjobs, meta.task_needs_host[placed])

        # ---- bulk path first ------------------------------------------
        # Bulk placements need no host state (the solve guarantees their fit,
        # readiness is snapshot arithmetic), while the slow path's host
        # predicates must observe them live; host fallbacks happen strictly
        # after every bulk placement has landed.  The resreq sums are global
        # segment sums over the float64 resreq matrix, and the apply loop
        # runs over plain Python lists.
        placed_l = placed.tolist()
        pjobs_l = pjobs.tolist()
        pipe_l = pipe_flags.tolist()
        node_l = assigned[placed].tolist()
        task_objs = meta.task_objs
        node_names = meta.node_names
        n_groups = len(bounds) - 1
        _mark("replay_prep")

        # ---- promote host-ports-only jobs back to the bulk path --------
        # a placement's ports conflict iff its (node, port) is held by a
        # resident task or claimed earlier this cycle: conflict-free jobs
        # keep the solve's guarantees and bulk-apply; conflicted or
        # affinity-carrying jobs take the sequential Statement replay
        promoted_jobs = 0
        cols = ssn.columns
        if (job_slow.any() and gang_only_ready and not ssn.host_only_predicates
                and cols is not None):
            occupied = set()
            for r in cols._ported_rows:
                ni = int(cols.t_node[r])
                rt = cols.task_by_row[r]
                if ni >= 0 and rt is not None:
                    for p in rt.pod.host_ports:
                        occupied.add((ni, p))
            for g in range(n_groups):
                lo, hi = bounds[g], bounds[g + 1]
                ji = pjobs_l[lo]
                # uncommitted jobs never apply: promoting them would plant
                # phantom port claims
                if not job_slow[ji] or not committed[ji]:
                    continue
                claims: Optional[set] = set()
                for i in range(lo, hi):
                    t = task_objs[placed_l[i]]
                    if not t.needs_host_predicate:
                        continue
                    if t.pod.affinity is not None:
                        claims = None  # rich constraints → sequential path
                        break
                    ni = node_l[i]
                    for p in t.pod.host_ports:
                        key = (ni, p)
                        if key in occupied or key in claims:
                            claims = None
                            break
                        claims.add(key)
                    if claims is None:
                        break
                if claims is None:
                    continue  # conflict → the sequential replay re-decides
                occupied.update(claims)
                job_slow[ji] = False
                promoted_jobs += 1

        slow_l = job_slow.tolist()
        committed_l = committed.tolist()

        # volume pre-check (AllocateVolumes, session.go:252-257): a rejected
        # group demotes to the sequential path before anything is mutated;
        # skipped when the volume binder declares itself a no-op
        demoted_jobs: set = set()
        volume_noop = getattr(ssn.cache.volume_binder, "noop", False)
        if not volume_noop:
            allocate_volumes = ssn.cache.allocate_volumes
            release = getattr(ssn.cache.volume_binder, "release_task", None)
            for g in range(n_groups):
                lo = bounds[g]
                ji = pjobs_l[lo]
                if slow_l[ji] or not committed_l[ji]:
                    continue
                try:
                    for i in range(lo, bounds[g + 1]):
                        if not pipe_l[i]:
                            allocate_volumes(task_objs[placed_l[i]], node_names[node_l[i]])
                except FitFailure:
                    demoted_jobs.add(ji)
                    if release is not None:
                        for i in range(lo, bounds[g + 1]):
                            release(task_objs[placed_l[i]].uid)

        apply_job = committed & ~job_slow
        if demoted_jobs:
            apply_job[list(demoted_jobs)] = False
        apply_mask = apply_job[pjobs]          # placements to bulk-apply
        self._n_applied += int(apply_mask.sum())
        alloc_sel = apply_mask & ~pipe_flags
        pipe_sel = apply_mask & pipe_flags
        placed_rows = resreq64[placed]
        node_of = assigned[placed]
        job_alloc_sum = np.zeros((nJ, R))
        np.add.at(job_alloc_sum, pjobs[alloc_sel], placed_rows[alloc_sel])
        job_total_sum = np.zeros((nJ, R))
        np.add.at(job_total_sum, pjobs[apply_mask], placed_rows[apply_mask])
        node_alloc_sum = np.zeros((nN, R))
        np.add.at(node_alloc_sum, node_of[alloc_sel], placed_rows[alloc_sel])
        node_pipe_sum = np.zeros((nN, R))
        np.add.at(node_pipe_sum, node_of[pipe_sel], placed_rows[pipe_sel])
        apply_l = apply_job.tolist()
        n_alloc_applied = np.bincount(pjobs[alloc_sel], minlength=nJ)
        _mark("replay_sums")

        columnar = (cols is not None
                    and meta.task_objs is cols.task_by_row  # the row space
                    and ssn.all_handlers_columnar())
        if not columnar:
            binds = self._apply_objects(ssn, meta, bounds, pjobs_l, placed_l, node_l,
                                        pipe_l, apply_l, job_alloc_sum, job_total_sum,
                                        node_alloc_sum, node_pipe_sum)
            _mark("replay_residue")
            if binds:
                if not volume_noop:
                    for t, _ in binds:
                        ssn.cache.bind_volumes(t)
                # the cache's own tasks turn Binding with this replay's
                # segment sums ({key: (count, vec)})
                job_sums = {meta.job_objs[ji].uid: (int(n_alloc_applied[ji]),
                                                    job_alloc_sum[ji])
                            for ji in np.flatnonzero(n_alloc_applied).tolist()}
                node_of_alloc = assigned[placed][alloc_sel]
                node_cnt = np.bincount(node_of_alloc, minlength=nN)
                node_sums = {node_names[ni]: (int(node_cnt[ni]), node_alloc_sum[ni])
                             for ni in np.flatnonzero(node_cnt).tolist()}
                ssn.cache.bulk_bind(binds, job_sums=job_sums, node_sums=node_sums)
            _mark("replay_bind")
            self._finish_slow(ssn, meta, assigned, pipelined, bounds, pjobs_l,
                              slow_l, demoted_jobs, placed, promoted_jobs)
            return

        # ---- columnar apply: every ledger / count / status column updated
        # by whole-matrix ops; the loops below only touch what must be an
        # object (status-index buckets, node task dicts, the binds list).
        # The ledger matrices are the buffers the JobInfo / NodeInfo
        # Resources wrap, so the objects see every update.
        BINDING_I = int(TaskStatus.BINDING)
        PIPELINED_I = int(TaskStatus.PIPELINED)
        PENDING_I = int(TaskStatus.PENDING)
        cols.t_status[placed[alloc_sel]] = BINDING_I
        cols.t_status[placed[pipe_sel]] = PIPELINED_I
        cols.t_node[placed[apply_mask]] = node_of[apply_mask]
        cols.j_alloc += job_alloc_sum
        # the alloc-twin choke point: the float32 refresh visits these rows
        cols.note_job_alloc_rows(np.any(job_alloc_sum != 0.0, axis=1))
        cols.j_pend -= job_total_sum
        np.maximum(cols.j_pend, 0.0, out=cols.j_pend)
        n_pipe_applied = np.bincount(pjobs[pipe_sel], minlength=nJ)
        jc = cols.j_counts
        jc[:, PENDING_I] -= n_alloc_applied + n_pipe_applied
        jc[:, BINDING_I] += n_alloc_applied
        jc[:, PIPELINED_I] += n_pipe_applied
        # the count choke point: the delta close visits these rows
        cols.j_touched[(n_alloc_applied + n_pipe_applied) > 0] = True
        cols.n_idle -= node_alloc_sum
        np.maximum(cols.n_idle, 0.0, out=cols.n_idle)
        cols.n_used += node_alloc_sum + node_pipe_sum
        cols.n_rel -= node_pipe_sum
        np.maximum(cols.n_rel, 0.0, out=cols.n_rel)
        # the ledger choke point: the float32 twins refresh these rows
        cols.note_node_ledger_rows(np.any(node_alloc_sum != 0.0, axis=1)
                                   | np.any(node_pipe_sum != 0.0, axis=1))
        ssn.fire_columnar_allocations(cols, job_total_sum)
        _mark("replay_columns")

        binds: List[Tuple[object, str]] = []
        if not pipe_sel.any():
            # ---- flat residue (every placement allocates — the steady
            # state): binds, bucket moves and node registration from whole
            # arrays, one object gather and one dict insert per task
            ptasks_l = [task_objs[r] for r in placed_l]
            apply_pos = np.flatnonzero(apply_mask)
            app_tasks = (ptasks_l if apply_pos.size == len(ptasks_l)
                         else [ptasks_l[i] for i in apply_pos.tolist()])
            app_nodes = node_of[apply_mask]
            binds = list(zip(app_tasks, (node_names[n] for n in app_nodes.tolist())))
            job_objs = meta.job_objs
            for g in range(n_groups):
                lo = bounds[g]
                ji = pjobs_l[lo]
                if apply_l[ji]:
                    job_objs[ji].rebucket_moved(ptasks_l[lo:bounds[g + 1]],
                                                TaskStatus.BINDING)
            # node registration grouped by one argsort over the node column
            if app_nodes.size:
                nsort = np.argsort(app_nodes, kind="stable")
                nodes_sorted = app_nodes[nsort]
                run_bounds = _run_bounds(nodes_sorted)
                nsort_l = nsort.tolist()
                for k in range(len(run_bounds) - 1):
                    lo, hi = run_bounds[k], run_bounds[k + 1]
                    node = ssn.nodes.get(node_names[nodes_sorted[lo]])
                    if node is not None:
                        node.bulk_register_tasks([app_tasks[i] for i in nsort_l[lo:hi]], ())
        else:
            # ---- general residue: pipelined placements record their fit
            # shortfall (allocate.go:170-175) and stay session-only
            by_node: Dict[int, Tuple[list, list]] = {}
            for g in range(n_groups):
                lo, hi = bounds[g], bounds[g + 1]
                ji = pjobs_l[lo]
                if not apply_l[ji]:
                    continue
                job = meta.job_objs[ji]
                alloc_tasks: list = []
                pipe_tasks: list = []
                for i in range(lo, hi):
                    t = task_objs[placed_l[i]]
                    ni = node_l[i]
                    name = node_names[ni]
                    t._node_name = name
                    slot = by_node.get(ni)
                    if slot is None:
                        slot = by_node[ni] = ([], [])
                    if pipe_l[i]:
                        pnode = ssn.nodes.get(name)
                        if pnode is not None:
                            job.nodes_fit_delta[name] = t.init_resreq.fit_delta(pnode.idle)
                            ssn.note_fit_state(job)
                        pipe_tasks.append(t)
                        slot[1].append(t)
                    else:
                        alloc_tasks.append(t)
                        slot[0].append(t)
                        binds.append((t, name))
                job.rebucket_moved(alloc_tasks, TaskStatus.BINDING)
                if pipe_tasks:
                    job.rebucket_moved(pipe_tasks, TaskStatus.PIPELINED)
                    ssn.pipelined_tasks.extend(pipe_tasks)
            for ni, (allocs, pipes) in by_node.items():
                node = ssn.nodes.get(node_names[ni])
                if node is not None:
                    node.bulk_register_tasks(allocs, pipes)
        _mark("replay_residue")

        if binds:
            # BindVolumes precedes every dispatch (statement.go:253-277)
            if not volume_noop:
                for t, _ in binds:
                    ssn.cache.bind_volumes(t)
            ssn.cache.bulk_bind(binds)
        _mark("replay_bind")

        self._finish_slow(ssn, meta, assigned, pipelined, bounds, pjobs_l,
                          slow_l, demoted_jobs, placed, promoted_jobs)

    def _apply_objects(self, ssn, meta, bounds, pjobs_l, placed_l, node_l,
                       pipe_l, apply_l, job_alloc_sum, job_total_sum,
                       node_alloc_sum, node_pipe_sum) -> list:
        """The bulk apply on objects (an isolated session, or a handler
        without the columnar form): per job one ``bulk_transition`` per
        status and one batched event, per node one ``bulk_add_tasks`` with
        the presummed rows (node_info.go:165-222).  Returns the binds."""
        spec = ssn.spec
        wrap_vec = spec.wrap_vec
        EMPTY = spec.empty()
        task_objs = meta.task_objs
        node_names = meta.node_names
        binds: List[Tuple[object, str]] = []
        by_node: Dict[int, Tuple[list, list]] = {}
        for g in range(len(bounds) - 1):
            lo, hi = bounds[g], bounds[g + 1]
            ji = pjobs_l[lo]
            if not apply_l[ji]:
                continue
            job = meta.job_objs[ji]
            alloc_tasks: list = []
            pipe_tasks: list = []
            for i in range(lo, hi):
                t = task_objs[placed_l[i]]
                ni = node_l[i]
                t.node_name = node_names[ni]
                slot = by_node.get(ni)
                if slot is None:
                    slot = by_node[ni] = ([], [])
                if pipe_l[i]:
                    # pipelined on Releasing: the task did not fit Idle
                    # (allocate.go:170-175)
                    pnode = ssn.nodes.get(t.node_name)
                    if pnode is not None:
                        job.nodes_fit_delta[t.node_name] = t.init_resreq.fit_delta(pnode.idle)
                        ssn.note_fit_state(job)
                    pipe_tasks.append(t)
                    slot[1].append(t)
                else:
                    alloc_tasks.append(t)
                    slot[0].append(t)
                    binds.append((t, t.node_name))
            # committed and ready: every new allocation dispatches at once
            # (session.go:286-294), Binding directly
            asum = wrap_vec(job_alloc_sum[ji])
            job.bulk_transition(alloc_tasks, TaskStatus.BINDING, asum, pending_sum=asum)
            if pipe_tasks:
                job.bulk_transition(
                    pipe_tasks, TaskStatus.PIPELINED, EMPTY,
                    pending_sum=wrap_vec(job_total_sum[ji] - job_alloc_sum[ji]))
                ssn.pipelined_tasks.extend(pipe_tasks)
            ssn.fire_batch_allocations(job, alloc_tasks + pipe_tasks,
                                       wrap_vec(job_total_sum[ji]))
        for ni, (allocs, pipes) in by_node.items():
            node = ssn.nodes.get(node_names[ni])
            if node is not None:
                node.bulk_add_tasks(allocs, pipes, wrap_vec(node_alloc_sum[ni]),
                                    wrap_vec(node_pipe_sum[ni]))
        return binds

    def _finish_slow(self, ssn, meta, assigned, pipelined, bounds, pjobs_l,
                     slow_l, demoted_jobs, placed, promoted_jobs) -> None:
        """The slow path, after every bulk placement has landed (the host
        predicates observe them); jobs the volume pre-check demoted replay
        here too."""
        n_slow = 0
        for g in range(len(bounds) - 1):
            ji = pjobs_l[bounds[g]]
            if slow_l[ji] or ji in demoted_jobs:
                n_slow += 1
                self._slow_replay_job(ssn, meta, assigned, pipelined, ji,
                                      placed[bounds[g]:bounds[g + 1]])
        self.last_fallback = {
            "slow_jobs": n_slow,
            "promoted_ports_jobs": promoted_jobs,
            "volume_demoted_jobs": len(demoted_jobs),
            "host_place_tasks": self._host_place_count,
        }
        metrics.register_slow_replay_jobs(n_slow)
        metrics.register_host_fallback_tasks(self._host_place_count)

    # ------------------------------------------------------------------
    def _slow_replay_job(self, ssn, meta, assigned, pipelined, ji, idxs) -> None:
        """Per-task Statement replay: the host is authoritative for the
        commit gate (JobReady, allocate.go:192-196) and every predicate."""
        job = meta.job_objs[ji]
        stmt = ssn.statement()
        for ti in idxs:
            task = meta.task_objs[int(ti)]
            node_name = meta.node_names[int(assigned[ti])]
            pipe = bool(pipelined[ti])
            node = ssn.nodes.get(node_name)
            try:
                if node is not None and (task.needs_host_predicate
                                         or ssn.host_only_predicates):
                    ssn.predicate(task, node)
                # live fit re-check: a host-fallback placement may have taken
                # capacity the solve promised to this placement
                if node is not None and not (
                        (not pipe and task.init_resreq.less_equal(node.idle))
                        or (pipe and task.init_resreq.less_equal(node.releasing))):
                    raise FitFailure("node resources taken by host fallback")
                if pipe:
                    if node is not None:
                        job.nodes_fit_delta[node_name] = task.init_resreq.fit_delta(node.idle)
                        ssn.note_fit_state(job)
                    stmt.pipeline(task, node_name)
                else:
                    stmt.allocate(task, node_name)
            except FitFailure as e:
                logger.info("device placement %s→%s rejected by host predicate: %s",
                            task.key(), node_name, e.reason)
                # the deterministic solve would re-propose the same node next
                # cycle: take the reference's sequential path for this task
                self._host_place(ssn, stmt, task)
        if ssn.job_ready(job):
            self._n_applied += len(stmt.operations)
            stmt.commit()
        else:
            logger.info("job %s not ready after device solve (%d placements), "
                        "discarding", job.uid, int(idxs.size))
            self.last_host_discards += 1
            ssn.host_discards += 1
            stmt.discard()

    def _record_fit_errors(self, ssn, meta, fail_hist, assigned, task_job,
                           pending) -> None:
        """FitErrors for unplaced pending tasks (allocate.go:151-155), from
        the reason histogram."""
        from kube_batch_tpu_torch.api.job_info import FitErrors
        from kube_batch_tpu_torch.ops.feasibility import REASON_MESSAGES

        unplaced = np.flatnonzero(pending & (assigned < 0))
        hist = fail_hist[: meta.n_tasks]
        n_nodes = meta.live_nodes
        for ti in unplaced:
            job = meta.job_objs[int(task_job[ti])]
            task = meta.task_objs[int(ti)]
            if job is None or task is None:
                continue
            counts = dict(zip(REASON_MESSAGES, hist[ti].tolist()))
            if not any(counts.values()):
                # feasible at cycle start but lost the contention
                counts = {"node(s) resources were consumed by other tasks "
                          "this cycle": n_nodes}
            fe = FitErrors()
            fe.set_histogram(counts, n_nodes)
            job.nodes_fit_errors[task.uid] = fe
            ssn.note_fit_state(job)

    def _port_rows(self, cols) -> Dict[int, list]:
        """port → [task rows] of every ported task, built once per execute;
        occupancy is read live from the t_node column at query time."""
        idx = self._ports_by_node
        if idx is None:
            idx = self._ports_by_node = {}
            for row in cols._ported_rows:
                t = cols.task_by_row[row]
                if t is not None:
                    for p in t.pod.host_ports:
                        idx.setdefault(p, []).append(row)
        return idx

    def _port_held_nodes(self, cols, port: int, exclude_row: int) -> set:
        """Node rows currently holding ``port`` (live t_node view)."""
        rows = self._port_rows(cols).get(port)
        if not rows:
            return set()
        t_node = cols.t_node
        return {int(t_node[r]) for r in rows if r != exclude_row and t_node[r] >= 0}

    def _host_place_columns(self, ssn, stmt, task) -> Optional[bool]:
        """Vectorized residual placement over the column matrices for tasks
        whose only host-side constraint is hostPorts: fit, static predicates
        and port exclusion as array ops, the device weights' scoring, then
        the Idle-vs-Releasing decision.  None when the task needs the full
        object scan (affinity, host-only predicates, a custom scorer)."""
        cols = ssn.columns
        if (cols is None or ssn.host_only_predicates
                or task.pod.affinity is not None or task._row < 0
                # a custom scoring policy (an extension row, or a NODE_ORDER
                # scorer beyond nodeorder's) is not in the score below: the
                # object scan consults ssn.node_order
                or ssn.score_weights.extra_rows
                or set(ssn._fns.get(NODE_ORDER, {})) - {"nodeorder"}):
            return None
        req = task.init_resreq.vec
        quanta = cols.spec.quanta
        fit_idle = np.all(req <= cols.n_idle + quanta, axis=1)
        fit_rel = np.all(req <= cols.n_rel + quanta, axis=1)
        cand = (fit_idle | fit_rel) & cols.n_valid & cols.n_sched
        excluded_rows = cols.excluded_node_rows(ssn)
        if excluded_rows:
            cand[excluded_rows] = False
        row = task._row
        if cols.t_sel_impossible[row]:
            return False
        sel = cols.t_sel_bits[row]
        if sel.any():
            cand &= ~np.any(sel[None, :] & ~cols.n_label_bits, axis=1)
        cand &= ~np.any(cols.n_taint_bits & ~cols.t_tol_bits[row][None, :], axis=1)
        for p in task.pod.host_ports:
            held = self._port_held_nodes(cols, p, exclude_row=row)
            if held:
                cand[list(held)] = False
        if not cand.any():
            return False
        # the device weights' scoring rows (ops/scoring.py's host twin)
        w = ssn.score_weights
        alloc = cols.n_alloc
        with np.errstate(divide="ignore", invalid="ignore"):
            used_after = cols.n_used + req
            frac = np.where(alloc > 0,
                            np.minimum(used_after / np.maximum(alloc, 1e-9), 1.0), 1.0)
        free_cpu, free_mem = 1.0 - frac[:, 0], 1.0 - frac[:, 1]
        score = (w.least_requested * (free_cpu + free_mem) * 5.0
                 + w.balanced_resource * (10.0 - np.abs(free_cpu - free_mem) * 10.0)
                 + w.binpack * (frac[:, 0] + frac[:, 1]) * 5.0)
        score = np.where(cand, score, -np.inf)
        volume_ok = getattr(ssn.cache.volume_binder, "noop", False)
        for _ in range(8):  # volume-infeasible nodes retire and we re-pick
            ni = int(np.argmax(score))
            if score[ni] == -np.inf:
                return False
            name = cols.node_names[ni]
            if volume_ok or ssn.cache.volume_feasible(task, name):
                break
            score[ni] = -np.inf
        else:
            return None  # past 8 volume-infeasible picks: the object scan
        try:
            if fit_idle[ni]:
                stmt.allocate(task, name)
            else:
                job = ssn.jobs.get(task.job)
                node = ssn.nodes.get(name)
                if job is not None and node is not None:
                    job.nodes_fit_delta[name] = task.init_resreq.fit_delta(node.idle)
                    ssn.note_fit_state(job)
                stmt.pipeline(task, name)
        except FitFailure as e:
            logger.info("columns host placement %s→%s failed: %s",
                        task.key(), name, e.reason)
            return False
        return True

    def _host_place(self, ssn, stmt, task) -> bool:
        """Sequential placement for a task the device model could not
        encode: predicate every node, take the best-scoring fit —
        allocate.go:151-184 (PredicateNodes → PrioritizeNodes →
        SelectBestNode → Allocate on Idle / Pipeline on Releasing)."""
        self._host_place_count += 1
        fast = self._host_place_columns(ssn, stmt, task)
        if fast is not None:
            return fast
        best, best_score = None, None
        for node in ssn.nodes.values():
            try:
                ssn.predicate(task, node)
            except FitFailure:
                continue
            if not (task.init_resreq.less_equal(node.idle)
                    or task.init_resreq.less_equal(node.releasing)):
                continue
            if not ssn.cache.volume_feasible(task, node.name):
                continue
            score = ssn.node_order(task, node)
            if best is None or score > best_score:
                best, best_score = node, score
        if best is None:
            return False
        # allocate-vs-pipeline is decided on the selected node
        # (allocate.go:161-184)
        try:
            if task.init_resreq.less_equal(best.idle):
                stmt.allocate(task, best.name)
            else:
                job = ssn.jobs.get(task.job)
                if job is not None:
                    job.nodes_fit_delta[best.name] = task.init_resreq.fit_delta(best.idle)
                    ssn.note_fit_state(job)
                stmt.pipeline(task, best.name)
        except FitFailure as e:
            logger.info("host placement %s→%s failed: %s", task.key(), best.name, e.reason)
            return False
        return True
