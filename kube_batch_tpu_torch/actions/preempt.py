"""preempt action (actions/preempt/preempt.go) — same-queue preemption:
phase 1 solved on the device, phase 2 on the host.

Mirrors ``kube_batch_tpu/actions/preempt.py``.  Phase 1 (between jobs of a
queue, preempt.go:110-137): the eviction solve in preempt mode proposes
(preemptor → node, victims) under conformance, gang slack and DRF share
dominance; the host replays each preemptor job through a Statement whose
evictions and pipelines commit only when the job reaches Pipelined, the
reference's commit gate.

Phase 2 (within a job, preempt.go:145-174) stays a host loop, and runs only
for jobs where a task-order plugin ranks a pending task above a running
one; ``preempt.referenceExact: "true"`` on any tier restores the
reference's ungated loop.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

from kube_batch_tpu_torch.actions.reclaim import (
    covers,
    find_task,
    host_predicate_ok,
    solve_claims,
)
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.api.types import PodGroupPhase, TaskStatus
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import FitFailure
from kube_batch_tpu_torch.utils.priority_queue import PriorityQueue


def _evict_until_covered(ssn, stmt, preemptor: TaskInfo, victims):
    """Evict the lowest task order first until the preemptor's InitResreq
    is covered (preempt.go:219-237); returns (covered, evicted victims)."""
    vq = PriorityQueue(less=lambda l, r: not ssn.task_order_fn(l, r), items=victims)
    preempted = ssn.spec.empty()
    evicted = []
    while vq:
        victim = vq.pop()
        stmt.evict(victim, "preempt")
        evicted.append(victim)
        preempted.add_(victim.resreq)
        if preemptor.init_resreq.less_equal(preempted):
            break
    return preemptor.init_resreq.less_equal(preempted), evicted


class PreemptAction(Action):
    name = "preempt"

    def __init__(self):
        # phase 1's solve stats (rounds, solve_ms) and claims
        self.last_stats: Dict[str, float] = {}
        # (preemptor, node name, evicted victims) of every committed claim
        self.last_evictions: List[tuple] = []

    def execute(self, ssn) -> None:
        self.last_evictions = []
        self._phase1(ssn)
        self._phase2(ssn)

    # ---- phase 1: between jobs of a queue (device-solved) ---------------
    def _phase1(self, ssn) -> None:
        claims, stats = solve_claims(ssn, "preempt")
        self.last_stats = dict(stats, claims=len(claims))
        # the Statement boundary is the preemptor job
        by_job: Dict[str, List[Tuple[TaskInfo, str, List[tuple]]]] = defaultdict(list)
        for claimant_ref, node_name, victim_refs in claims:
            task = find_task(ssn, claimant_ref)
            if task is not None and victim_refs:
                by_job[task.job].append((task, node_name, victim_refs))

        for job_uid, job_claims in by_job.items():
            job = ssn.jobs.get(job_uid)
            if job is None:
                continue
            stmt = ssn.statement()
            done = []
            for task, node_name, victim_refs in job_claims:
                if not host_predicate_ok(ssn, task, node_name):
                    continue
                preemptees = [v for v in (find_task(ssn, r) for r in victim_refs)
                              if v is not None and v.status == TaskStatus.RUNNING]
                victims = ssn.preemptable(task, preemptees)
                if not victims or not covers(ssn, task, victims):
                    continue
                _, evicted = _evict_until_covered(ssn, stmt, task, victims)
                stmt.pipeline(task, node_name)
                done.append((task, node_name, evicted))
            if ssn.job_pipelined(job):
                stmt.commit()
                self.last_evictions.extend(done)
            else:
                stmt.discard()

    # ---- phase 2: within a job (host) ------------------------------------
    def _phase2(self, ssn) -> None:
        for job in ssn.jobs.values():
            # claimant gates (preempt.go:59-63)
            if job.pod_group and job.pod_group.phase == PodGroupPhase.PENDING:
                continue
            if job.queue not in ssn.queues:
                continue
            pending = job.task_status_index.get(TaskStatus.PENDING, {})
            running = job.task_status_index.get(TaskStatus.RUNNING, {})
            if not pending or not running:
                continue
            if not ssn.conf_flag("preempt.referenceExact") and not self._worth_it(
                    ssn, pending, running):
                continue
            tq = PriorityQueue(less=ssn.task_order_fn, items=pending.values())
            while tq:
                preemptor = tq.pop()

                def intra_job(task: TaskInfo) -> bool:
                    return task.status == TaskStatus.RUNNING and preemptor.job == task.job

                stmt = ssn.statement()
                assigned = self._preempt_host(ssn, stmt, preemptor, intra_job)
                stmt.commit()  # phase 2 commits unconditionally (preempt.go:168)
                if not assigned:
                    break

    @staticmethod
    def _worth_it(ssn, pending, running) -> bool:
        """Some task-order plugin ranks the best pending task above the
        worst running one; a mere creation-order tie-break does not count.
        With no task-order voter, the extreme raw priorities decide."""
        to = ssn.task_order_fn
        best_p = None
        for t in pending.values():
            if best_p is None or to(t, best_p):
                best_p = t
        worst_r = None
        for t in running.values():
            if worst_r is None or to(worst_r, t):
                worst_r = t
        verdict = ssn.task_order_plugin_verdict(best_p, worst_r)
        if verdict == 0:
            hi = max(t.priority for t in pending.values())
            lo = min(t.priority for t in running.values())
            verdict = -1 if hi > lo else 1
        return verdict < 0

    def _preempt_host(self, ssn, stmt, preemptor: TaskInfo,
                      victim_filter: Callable[[TaskInfo], bool]) -> bool:
        """Sequential preemption for one task (preempt.go:180-260)."""
        candidates = []
        for node in ssn.nodes.values():
            try:
                ssn.predicate(preemptor, node)
            except FitFailure:
                continue
            candidates.append((ssn.node_order(preemptor, node), node))
        candidates.sort(key=lambda sn: -sn[0])

        for _, node in candidates:
            preemptees = [t for t in node.tasks.values() if victim_filter(t)]
            victims = ssn.preemptable(preemptor, preemptees)
            if not victims or not covers(ssn, preemptor, victims):
                continue
            covered, evicted = _evict_until_covered(ssn, stmt, preemptor, victims)
            if covered:
                stmt.pipeline(preemptor, node.name)
                self.last_evictions.append((preemptor, node.name, evicted))
                return True
        return False
