"""backfill action (actions/backfill/backfill.go:42-93).

Mirrors ``kube_batch_tpu/actions/backfill.py``.  Two passes:

- BestEffort tasks (empty InitResreq) go to the first node passing the
  plugin predicates, with no scoring, allocated at once — the reference.
- The stranded-capacity pass, beyond the reference (its own TODO,
  backfill.go:87): when the allocate replay discarded placements on the
  host (``ssn.host_discards``), the capacity they freed would sit idle for
  the rest of the cycle.  The pass re-runs the allocate solve over the
  live session snapshot — K1 or K2 on the card, as allocate dispatches —
  restricted to gang-safe jobs (at or above MinAvailable, or not gangs),
  so no partial gang can commit, and replays the result through a
  throwaway ``AllocateAction``.  The solve is cold (no carried table) and
  guarded like allocate's: a condemned result binds nothing; its swap
  re-arms the what-if lease.  Its dispatch and readback run in
  ``solve_dispatch`` and ``device_wait`` spans (``action="backfill"``).
  ``backfill.realRequests: "false"`` on any tier turns it off.
"""

from __future__ import annotations

import logging

from kube_batch_tpu_torch.actions.allocate import (
    AllocateAction,
    _read_back,
    build_session_snapshot,
    dispatch_allocate_solve,
    dispatch_topk,
    plan_topk_bucket,
    republish_query_lease,
    session_allocate_config,
    solve_target,
)
from kube_batch_tpu_torch.api.columns import resident_snap
from kube_batch_tpu_torch.api.job_info import FitError, FitErrors
from kube_batch_tpu_torch.api.types import PodGroupPhase, TaskStatus
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import FitFailure
from kube_batch_tpu_torch.guard import consume_assignment_sentinel, guard_of
from kube_batch_tpu_torch.obs.trace import tracer_of

logger = logging.getLogger("kube_batch_tpu_torch")


class BackfillAction(Action):
    name = "backfill"

    def __init__(self):
        # tasks the last execute placed: best effort, and by the
        # stranded-capacity pass
        self.last_placed = {"best_effort": 0, "real_requests": 0}

    def execute(self, ssn) -> None:
        self.last_placed = {"best_effort": self._best_effort(ssn),
                            "real_requests": self._real_requests(ssn)}

    # ---- the reference: BestEffort first fit ----------------------------
    def _best_effort(self, ssn) -> int:
        placed = 0
        for job in ssn.jobs.values():
            if job.pod_group and job.pod_group.phase == PodGroupPhase.PENDING:
                continue
            pending = list(job.task_status_index.get(TaskStatus.PENDING, {}).values())
            for task in pending:
                if not task.best_effort:
                    continue
                fit_errors = FitErrors()
                for node in ssn.nodes.values():
                    try:
                        ssn.predicate(task, node)
                    except FitFailure as e:
                        fit_errors.set_node_error(
                            node.name, FitError(task, node.name, [e.reason]))
                        continue
                    ssn.allocate(task, node.name)
                    placed += 1
                    break
                else:
                    job.nodes_fit_errors[task.uid] = fit_errors
                    ssn.note_fit_state(job)
        return placed

    # ---- beyond the reference: the stranded-capacity pass ----------------
    def _real_requests(self, ssn) -> int:
        if not ssn.jobs or not ssn.nodes:
            return 0
        if not ssn.conf_flag("backfill.realRequests", default=True):
            return 0
        # the pass re-pays a [T, N] solve, so it runs only when allocate
        # stranded capacity this cycle; otherwise the pending set is exactly
        # what the solve just failed to place
        if not ssn.host_discards:
            return 0
        cols = ssn.columns
        if cols is not None:
            if not cols.has_schedulable_pending():
                return 0
        elif not any(_safe_pending(j) for j in ssn.jobs.values()):
            # an isolated session: the object pre-gate before the snapshot
            # rebuild — any gang-safe job with pending tasks?
            return 0
        snap, meta = build_session_snapshot(ssn)
        # gang-safe claimants only: a job at or above MinAvailable, or no
        # gang; an unready gang stays out (allocate just discarded it)
        safe = (((snap.job_min_avail <= 1) | (snap.job_ready >= snap.job_min_avail))
                & snap.job_schedulable)
        T = meta.n_tasks
        task_job = snap.task_job[:T]
        eligible = (snap.task_pending[:T] & snap.task_valid[:T]
                    & snap.job_valid[task_job] & safe[task_job])
        # cheap host check before the solve: the common trigger, a
        # discarded unready gang as the only pending work, gives nothing
        if not eligible.any():
            return 0
        snap = snap._replace(job_schedulable=safe)
        gp = guard_of(ssn.cache)
        tracer = tracer_of(ssn.cache)
        with tracer.device_span("solve_dispatch", cols=cols, action="backfill"):
            target = solve_target(ssn, snap.node_alloc.shape[0])
            plan = plan_topk_bucket(snap, dispatch_topk(gp))
            if target is not ssn.device and target.task_shards != 1:
                plan = (None, 0)  # a 2-D mesh declines compaction
            dev = resident_snap(cols, snap, target)
            # cold (no carried table): this mid-cycle snapshot must not
            # consume allocate's deltas
            result, _mode, _topk, ginfo = dispatch_allocate_solve(
                dev, session_allocate_config(ssn), plan=plan, cols=cols, guard=gp)
        # this swap retired the what-if lease: re-arm it off the same
        # resident snapshot.  The gang-safe job_schedulable mask is
        # invisible to a probe, whose only job row is the appended one
        republish_query_lease(ssn, snap, meta)
        sentinel = ginfo["sentinel"]
        with tracer.device_span("device_wait", action="backfill"):
            assigned, pipelined, *_, verdict, vhist, echeck = _read_back(result, T, sentinel)
        if sentinel is not None and not consume_assignment_sentinel(
                gp, "backfill", ssn, snap, meta, ginfo, verdict, vhist, echeck,
                assigned):
            # condemned: strand the capacity this cycle rather than bind
            # from an unlawful result
            return 0
        n = int((assigned >= 0).sum())
        if n == 0:
            return 0
        logger.info("backfill real-request pass placing %d stranded tasks", n)
        # a throwaway action, so the allocate action's recorded phases and
        # fallback stay those of its own pass
        AllocateAction()._replay(ssn, snap, meta, assigned, pipelined, task_job)
        return n



def _safe_pending(job) -> bool:
    """A schedulable job with pending tasks that may take placements with
    no atomicity risk: not a gang, or already at MinAvailable."""
    if job.pod_group and job.pod_group.phase == PodGroupPhase.PENDING:
        return False
    if not job.task_status_index.get(TaskStatus.PENDING):
        return False
    return job.min_available <= 1 or job.ready()
