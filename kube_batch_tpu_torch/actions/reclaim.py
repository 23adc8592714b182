"""reclaim action (actions/reclaim/reclaim.go) — cross-queue eviction,
solved on the device.

Mirrors ``kube_batch_tpu/actions/reclaim.py``.  The reference scans every
node per starved task (reclaim.go:107-199); here ``ops/eviction.py``
proposes (claimant → node, victims) on the device, and the host replays
each claim through the plugins' real victim verdicts (``ssn.reclaimable``,
the tier intersection), so the semantics stay the host's: victims are
evicted at once (reclaim holds no Statement, reclaim.go:166-179), and only
when the validated set still covers the claimant, which then pipelines
onto the freed resources.

``solve_claims`` is shared with preempt's phase 1.  The snapshot comes from
the column store and the resident tensors, as in allocate (an isolated
session's from its cloned objects, every job included); the guard's
sentinel follows the solve, and the three result fields and its verdict
come back in one transfer (a condemned solve evicts nothing).  The
solve's swap re-arms the what-if lease.  The dispatch and the readback
run in ``solve_dispatch`` and ``device_wait`` spans (``action=`` reclaim
or preempt, ``obs/trace.py``).  When the session's mesh shards the node
axis (``parallel/mesh.py``) the solve runs sharded: ``shard_map`` is then
the engaged fast path — demoted to the ``"pjit"`` oracle by a guard trip —
and every ``KB_AUDIT_EVERY``-th engaged solve is compared with the oracle
after the decode, as in the JAX package.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List

import numpy as np

from kube_batch_tpu_torch.actions.allocate import (
    build_session_snapshot,
    republish_query_lease,
    solve_target,
)
from kube_batch_tpu_torch.api.columns import resident_snap
from kube_batch_tpu_torch.api.convert import read_back
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import FitFailure
from kube_batch_tpu_torch.guard import consume_sentinel, guard_of, make_heal, sentinel_bundle_thunk
from kube_batch_tpu_torch.obs.trace import tracer_of
from kube_batch_tpu_torch.ops.eviction import EvictConfig, evict_solve
from kube_batch_tpu_torch.ops.invariants import evict_sentinel_solve
from kube_batch_tpu_torch.parallel import mesh as pm
from kube_batch_tpu_torch.utils import telemetry

logger = logging.getLogger("kube_batch_tpu_torch")

# plugins registering each Evictable fn kind
_VICTIM_REGISTRANTS = {
    "reclaim": ("gang", "conformance", "proportion"),
    "preempt": ("gang", "conformance", "drf"),
}


def victim_gates(ssn, mode: str) -> set:
    """The plugins whose victim veto binds: the Evictable dispatch takes the
    first tier with any voter (session_plugins.go:100-182)."""
    registrants = _VICTIM_REGISTRANTS[mode]
    flag = "enabled_reclaimable" if mode == "reclaim" else "enabled_preemptable"
    for tier in ssn.tiers:
        voters = {opt.name for opt in tier.plugins
                  if opt.name in registrants and getattr(opt, flag)}
        if voters:
            return voters
    return set()


def evict_config(ssn, mode: str) -> EvictConfig:
    """The solve configuration a session implies for ``mode``."""
    gates = victim_gates(ssn, mode)
    # the idle-fit claimant gate (a declared divergence from reclaim.go) is
    # sound only when allocate runs after reclaim to place the claimants it
    # skips and the device fit is exact for them; without the pipeline's
    # action names it fails closed to the reference behaviour
    names = ssn.action_names
    idle_gate = (
        mode == "reclaim"
        and not ssn.conf_flag("reclaim.referenceExact")
        and not ssn.host_only_predicates
        and names is not None
        and "allocate" in names and "reclaim" in names
        and names.index("allocate") > names.index("reclaim")
    )
    return EvictConfig(
        mode=mode,
        idle_gate=idle_gate,
        gang=ssn.plugin_enabled("gang"),
        drf=ssn.plugin_enabled("drf"),
        proportion=ssn.plugin_enabled("proportion"),
        victim_gang="gang" in gates,
        victim_conformance="conformance" in gates,
        victim_proportion="proportion" in gates,
        victim_drf="drf" in gates,
        weights=ssn.score_weights,
    )


def solve_claims(ssn, mode: str):
    """Run the eviction solve and decode it to ``(claims, stats)``: claims
    are ``[(claimant ref, node name, [victim refs])]`` in device claim
    order, a ref being ``(job uid, task key)``; stats hold the solve's
    rounds and wall ms, or are empty when no solve was needed."""
    if not ssn.jobs or not ssn.nodes:
        return [], {}
    cols = ssn.columns
    # no claimant anywhere, or no Running victim: the solve is vacuous
    if cols is not None and not (cols.has_schedulable_pending()
                                 and cols.has_running_victims()):
        return [], {}
    t0 = telemetry.perf_counter()
    # every job included: the Pending-phase gate (reclaim.go:58-62,
    # preempt.go:59-63) applies to claimants only, through the snapshot's
    # job_schedulable, so Pending-phase jobs' Running tasks stay in the
    # victim pool and their allocations in the fairness state
    snap, meta = build_session_snapshot(ssn)
    gp = guard_of(ssn.cache)
    tracer = tracer_of(ssn.cache)
    config = evict_config(ssn, mode)
    sentinel = None
    audit_dev = None
    engaged: List[str] = []
    # a device span: the resident swap's scatters land on it; shard_map is
    # the only demotable path of this solve, so nothing is engaged on one
    # device
    with tracer.device_span("solve_dispatch", cols=cols, action=mode) as sp:
        target = solve_target(ssn, snap.node_alloc.shape[0])
        dev = resident_snap(cols, snap, target)
        if target is not ssn.device:
            # demotion-aware: a tripped shard_map runs the pjit oracle until
            # its half-open probe re-promotes it
            impl = None if gp.allow("shard_map") else "pjit"
            if pm._impl(impl) == "shard_map":
                engaged = ["shard_map"]
            if gp.enabled:
                result, rounds, *sentinel = pm.sentinel_sharded_evict_solve(
                    dev, config, impl=impl)
            else:
                result, rounds = pm.sharded_evict_solve(dev, config, impl=impl)
            if engaged and gp.audit_due(mode):
                # the shadow oracle on the same tensors, read back after
                # the decode below
                audit_dev = pm.sharded_evict_solve(dev, config, impl="pjit")[0]
        elif gp.enabled:
            result, rounds, *sentinel = evict_sentinel_solve(dev, config)
        else:
            result, rounds = evict_solve(dev, config)
    sp.set(engaged=list(engaged))
    # this swap retired the what-if lease: re-arm it off the same
    # (memoized) resident snapshot, so serving is not dark until the next
    # cycle's allocate
    republish_query_lease(ssn, snap, meta)
    T = meta.n_tasks
    # one readback: the three result fields, and the sentinel's verdict,
    # histogram and checksum riding it
    parts = [result.claim_node, result.evicted, result.victim_claimant]
    if sentinel is not None:
        parts += sentinel
    with tracer.device_span("device_wait", action=mode):
        got = read_back(parts)
    claim_node, evicted, victim_claimant = (a[:T] for a in got[:3])
    stats = {"rounds": rounds, "solve_ms": (telemetry.perf_counter() - t0) * 1e3}
    if sentinel is not None:
        verdict, hist, check = got[3:]
        # host cross-checks: a claim must target a row the host believes
        # pending, a victim one it believes Running (the device copies are
        # what a corruption flips)
        host_bad = int(np.sum((claim_node >= 0) & ~snap.task_pending[:T])
                       + np.sum(evicted & (snap.task_status[:T] != int(TaskStatus.RUNNING))))
        if not consume_sentinel(gp, mode, ssn, snap, dev, config, int(verdict),
                                hist, int(check), engaged, host_bad=host_bad):
            # condemned: no evictions from it
            return [], stats

    task_job = snap.task_job[:T]

    def ref(ti: int):
        return (meta.job_uids[int(task_job[ti])], meta.task_keys[ti])

    victims_by_claim: Dict[int, List[tuple]] = defaultdict(list)
    for vi in np.flatnonzero(evicted).tolist():
        ci = int(victim_claimant[vi])
        if ci >= 0:
            victims_by_claim[ci].append(ref(vi))
    claims = [(ref(ti), meta.node_names[int(claim_node[ti])],
               victims_by_claim.get(ti, []))
              for ti in np.flatnonzero(claim_node >= 0).tolist()]
    if audit_dev is not None:
        a = read_back((audit_dev.claim_node, audit_dev.evicted, audit_dev.victim_claimant))
        mism = int(sum(np.sum(x[:T] != y)
                       for x, y in zip(a, (claim_node, evicted, victim_claimant))))
        gp.note_audit(
            mode, engaged, mism == 0,
            detail=f"{mode} shard_map-vs-pjit mismatch at {mism} rows",
            dump=sentinel_bundle_thunk(gp, mode, dev, config,
                                       {"audit_mismatches": mism, "engaged": engaged}),
            heal=make_heal(ssn))
        if mism:
            # the fast path is demoted; the claims decoded above came from
            # the mismatched program, so this cycle evicts nothing
            return [], stats
    return claims, stats


def find_task(ssn, ref: tuple):
    """(job uid, task key) → the session's TaskInfo, or None."""
    job = ssn.jobs.get(ref[0])
    return job.tasks.get(ref[1]) if job is not None else None


def host_predicate_ok(ssn, task, node_name: str) -> bool:
    """The host predicate re-check of a device claim, only for constraints
    the device mask approximates (rich affinity, host ports, host-only
    predicates)."""
    node = ssn.nodes.get(node_name)
    if node is None or not (task.needs_host_predicate or ssn.host_only_predicates):
        return True
    try:
        ssn.predicate(task, node)
    except FitFailure as e:
        logger.info("claim %s→%s rejected by host predicate: %s",
                    task.key(), node_name, e.reason)
        return False
    return True


def covers(ssn, task, victims) -> bool:
    """The victims cover the claimant's InitResreq in every dimension
    (reclaim.go:150-163)."""
    total = ssn.spec.empty()
    for v in victims:
        total.add_(v.resreq)
    return task.init_resreq.less_equal(total)


class ReclaimAction(Action):
    name = "reclaim"

    def __init__(self):
        # the last execute's solve stats (rounds, solve_ms), claims, and
        # the evictions and pipelines it made
        self.last_stats: Dict[str, float] = {}
        # (claimant, node name, evicted victims) of every claim it carried out
        self.last_evictions: List[tuple] = []

    def execute(self, ssn) -> None:
        claims, stats = solve_claims(ssn, "reclaim")
        self.last_evictions = []
        n_evicted = 0
        for claimant_ref, node_name, victim_refs in claims:
            task = find_task(ssn, claimant_ref)
            if task is None or not victim_refs:
                continue
            if not host_predicate_ok(ssn, task, node_name):
                continue
            preemptees = [v for v in (find_task(ssn, r) for r in victim_refs)
                          if v is not None]
            # the tier-intersected verdict (proportion's deserved, gang
            # survival, conformance) on the device-selected set only
            victims = ssn.reclaimable(task, preemptees)
            if not victims or not covers(ssn, task, victims):
                continue
            reclaimed = ssn.spec.empty()
            evicted = []
            for victim in victims:
                ssn.evict(victim, "reclaim")
                evicted.append(victim)
                reclaimed.add_(victim.resreq)
                if task.init_resreq.less_equal(reclaimed):
                    break
            ssn.pipeline(task, node_name)
            self.last_evictions.append((task, node_name, evicted))
            n_evicted += len(evicted)
        self.last_stats = dict(stats, claims=len(claims), evicted=n_evicted,
                               pipelined=len(self.last_evictions))
