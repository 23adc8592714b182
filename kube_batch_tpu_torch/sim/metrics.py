"""Longitudinal scheduling metrics over a simulated run.

A benchmark measures one frozen cycle; these measure what only a timeline
can: per-job queueing delay (arrival → first bind) and completion time
(arrival → last pod success), per-queue share-vs-entitlement over time,
eviction/preemption churn, and makespan — all in VIRTUAL seconds, so they
are properties of the scheduling policy, not of the host the simulation
ran on.

Mirrors ``kube_batch_tpu/sim/metrics.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def nearest_rank(values: List[float], p: float) -> float:
    """Nearest-rank percentile: ceil(p*n)-1.  `int(p*n)` sat one rank high
    (p50 of a 2-sample read the max), overstating small-n tails."""
    import math

    xs = sorted(values)
    n = len(xs)
    return xs[min(n - 1, max(0, math.ceil(p * n) - 1))]


def percentile_summary(values: List[float]) -> Optional[Dict]:
    """p50/p90/p99 + mean over a sample (nearest-rank, like e2e's density
    percentiles); None for an empty sample."""
    if not values:
        return None
    xs = sorted(values)
    n = len(xs)
    return {
        "n": n,
        "mean": round(sum(xs) / n, 6),
        "p50": round(nearest_rank(xs, 0.50), 6),
        "p90": round(nearest_rank(xs, 0.90), 6),
        "p99": round(nearest_rank(xs, 0.99), 6),
        "max": round(xs[-1], 6),
    }


class LongitudinalMetrics:
    def __init__(self):
        self.arrivals: Dict[str, float] = {}      # job uid → arrival vt
        self.first_bind: Dict[str, float] = {}    # job uid → first bind vt
        self.completions: Dict[str, float] = {}   # job uid → all-succeeded vt
        self.evictions = 0
        self.binds = 0
        # per-POD arrival→bind latency (every incarnation), the bind-storm
        # preset's headline: p99 must stay bounded while the binder flaps
        self.pod_bind_latency: List[float] = []
        self.fairness: List[Dict] = []            # per-cycle queue shares
        self.cycles = 0
        # cross-cycle resident-snapshot bookkeeping: which open/snapshot
        # path each cycle took ("delta" vs "full") and its churn fraction —
        # seed-deterministic evidence of the multi-cycle delta open
        self.snapshot_paths: Dict[str, int] = {}
        self.churn: List[float] = []

    # ---- job lifecycle ---------------------------------------------------
    def note_arrival(self, job_uid: str, t: float) -> None:
        self.arrivals.setdefault(job_uid, t)

    def note_bind(self, job_uid: str, t: float) -> None:
        self.binds += 1
        self.first_bind.setdefault(job_uid, t)

    def note_pod_bind_latency(self, dt: float) -> None:
        self.pod_bind_latency.append(dt)

    def note_eviction(self) -> None:
        self.evictions += 1

    def note_completion(self, job_uid: str, t: float) -> None:
        self.completions.setdefault(job_uid, t)

    # ---- per-cycle -------------------------------------------------------
    def note_cycle(self, t: float, queue_shares: Dict[str, Dict],
                   pending_tasks: int, running_tasks: int,
                   snapshot_path: Optional[str] = None,
                   churn: Optional[float] = None) -> None:
        self.cycles += 1
        rec = {
            "t": round(t, 6),
            "queues": queue_shares,
            "pending": pending_tasks,
            "running": running_tasks,
        }
        if snapshot_path is not None:
            rec["snapshot_path"] = snapshot_path
            self.snapshot_paths[snapshot_path] = (
                self.snapshot_paths.get(snapshot_path, 0) + 1
            )
        if churn is not None:
            rec["churn"] = round(churn, 6)
            self.churn.append(churn)
        self.fairness.append(rec)

    # ---- report ----------------------------------------------------------
    def report(self) -> Dict:
        jct = [self.completions[j] - self.arrivals[j]
               for j in self.completions if j in self.arrivals]
        wait = [self.first_bind[j] - self.arrivals[j]
                for j in self.first_bind if j in self.arrivals]
        completed_at = list(self.completions.values())
        arrived_at = list(self.arrivals.values())
        makespan = (round(max(completed_at) - min(arrived_at), 6)
                    if completed_at and arrived_at else None)
        # fairness summarized as each queue's mean |share − entitlement|
        # over cycles where anything was allocated, plus the raw series
        drift: Dict[str, List[float]] = {}
        for rec in self.fairness:
            for q, s in rec["queues"].items():
                drift.setdefault(q, []).append(
                    abs(s["share"] - s["entitlement"])
                )
        return {
            "jobs": {
                "submitted": len(self.arrivals),
                "started": len(self.first_bind),
                "completed": len(self.completions),
            },
            "jct_vt": percentile_summary(jct),
            "wait_vt": percentile_summary(wait),
            "pod_bind_latency_vt": percentile_summary(self.pod_bind_latency),
            "makespan_vt": makespan,
            "binds": self.binds,
            "evictions": self.evictions,
            "cycles": self.cycles,
            "fairness_mean_abs_drift": {
                q: round(sum(v) / len(v), 6) for q, v in drift.items() if v
            },
            # per-cycle open/snapshot path counts + churn-fraction summary
            # (the raw per-cycle values ride the fairness series records)
            "snapshot_paths": dict(self.snapshot_paths),
            "churn_fraction": percentile_summary(self.churn),
            "fairness_series": self.fairness,
        }
