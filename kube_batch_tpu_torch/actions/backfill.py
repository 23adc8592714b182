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
  throwaway ``AllocateAction``.  ``backfill.realRequests: "false"`` on any
  tier turns it off.
"""

from __future__ import annotations

import logging

from kube_batch_tpu_torch.actions.allocate import (
    AllocateAction,
    _read_back,
    build_session_snapshot,
    dispatch_allocate_solve,
    plan_topk_bucket,
    resolve_topk,
    session_allocate_config,
)
from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
from kube_batch_tpu_torch.api.job_info import FitError, FitErrors
from kube_batch_tpu_torch.api.types import PodGroupPhase, TaskStatus
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import FitFailure

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
        if not ssn.host_discards or not ssn.columns.has_schedulable_pending():
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
        dev = snapshot_from_numpy(snap, ssn.device)
        plan = plan_topk_bucket(snap, resolve_topk())
        result, _mode, _topk = dispatch_allocate_solve(
            dev, session_allocate_config(ssn), plan=plan)
        assigned, pipelined, *_ = _read_back(result, T)
        n = int((assigned >= 0).sum())
        if n == 0:
            return 0
        logger.info("backfill real-request pass placing %d stranded tasks", n)
        # a throwaway action, so the allocate action's recorded phases and
        # fallback stay those of its own pass
        AllocateAction()._replay(ssn, snap, meta, assigned, pipelined, task_job)
        return n

