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
the column store and one upload, as in allocate; the three result fields
come back in one transfer.  Not ported: the guard's sentinel and shadow
audit, the mesh dispatch, the resident snapshot and the query-lease
republish.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import FitFailure
from kube_batch_tpu_torch.ops.eviction import EvictConfig, evict_solve

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
    if not cols.has_schedulable_pending() or not cols.has_running_victims():
        return [], {}
    t0 = time.perf_counter()
    snap, meta = cols.device_snapshot(ssn)
    dev = snapshot_from_numpy(snap, ssn.device)
    result, rounds = evict_solve(dev, evict_config(ssn, mode))
    T = meta.n_tasks
    packed = torch.stack([result.claim_node, result.evicted.to(torch.int32),
                          result.victim_claimant]).cpu().numpy()
    claim_node, evicted, victim_claimant = packed[0], packed[1].astype(bool), packed[2]
    stats = {"rounds": rounds, "solve_ms": (time.perf_counter() - t0) * 1e3}

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
