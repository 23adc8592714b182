"""Prometheus-compatible metrics (pkg/scheduler/metrics/metrics.go:27-121),
mirroring ``kube_batch_tpu/metrics/metrics.py``.

The same metric names and label sets under the ``volcano`` subsystem, the
reference's 5·2^k exponential buckets, and the Prometheus text exposition
format (``render_prometheus``), standalone, with no client library.  The
registry is module-level, as in the JAX package: one process has one set
of series.  Metrics that the JAX package declares and never writes
(``SCHEDULE_ATTEMPTS``, ``POD_PREEMPTION_VICTIMS``, the unschedule
counts) are declared here too and stay unwritten.

One difference in form: ``observe_decision_latencies`` buckets a cycle's
batch with numpy (``np.searchsorted(EXP_BUCKETS, v, side="left")`` is
``bisect.bisect_left``), so a cycle of 50 000 bind decisions is one
update; the buckets, the count and the sequential sum come out as the
per-sample loop gives them.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

# 5·2^k, k=0..9 (metrics.go:38-72)
EXP_BUCKETS = [5.0 * (2**k) for k in range(10)]
_EXP_BUCKETS_NP = np.asarray(EXP_BUCKETS, np.float64)


class Histogram:
    def __init__(self, name: str, help_text: str, labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_text
        self.label_names = labels
        self._lock = threading.Lock()
        self._buckets: Dict[Tuple[str, ...], List[int]] = defaultdict(
            lambda: [0] * (len(EXP_BUCKETS) + 1)
        )
        self._sum: Dict[Tuple[str, ...], float] = defaultdict(float)
        self._count: Dict[Tuple[str, ...], int] = defaultdict(int)

    def observe(self, value: float, *label_values: str) -> None:
        self.observe_many(value, 1, *label_values)

    def observe_many(self, value: float, count: int, *label_values: str) -> None:
        """Record `count` samples of `value` in one update — the vectorized
        cycle's amortized per-task observations (50k individual observe()
        calls per cycle would be pure lock churn)."""
        if count <= 0:
            return
        with self._lock:
            b = self._buckets[label_values]
            b[bisect.bisect_left(EXP_BUCKETS, value)] += count
            self._sum[label_values] += value * count
            self._count[label_values] += count

    def observe_values(self, values, *label_values: str) -> None:
        """Record every sample of ``values`` (finite floats) in one update:
        the same buckets, count and left-to-right sum as one observe() per
        sample."""
        vals = np.asarray(values, np.float64).reshape(-1)
        if vals.size == 0:
            return
        counts = np.bincount(np.searchsorted(_EXP_BUCKETS_NP, vals, side="left"),
                             minlength=len(EXP_BUCKETS) + 1).tolist()
        with self._lock:
            b = self._buckets[label_values]
            for i, c in enumerate(counts):
                b[i] += c
            # np.add.accumulate adds strictly left to right
            self._sum[label_values] = float(np.add.accumulate(
                np.concatenate(([self._sum[label_values]], vals)))[-1])
            self._count[label_values] += int(vals.size)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for labels, buckets in self._buckets.items():
                base = ",".join(
                    f'{n}="{v}"' for n, v in zip(self.label_names, labels)
                )
                cum = 0
                for le, cnt in zip(EXP_BUCKETS, buckets):
                    cum += cnt
                    sep = "," if base else ""
                    lines.append(f'{self.name}_bucket{{{base}{sep}le="{le:g}"}} {cum}')
                cum += buckets[-1]
                sep = "," if base else ""
                lines.append(f'{self.name}_bucket{{{base}{sep}le="+Inf"}} {cum}')
                lines.append(f"{self.name}_sum{{{base}}} {self._sum[labels]:g}")
                lines.append(f"{self.name}_count{{{base}}} {self._count[labels]}")
        return "\n".join(lines)


class Counter:
    #: Prometheus exposition type — Gauge overrides (a counter that goes
    #: down reads as a reset to Prometheus clients)
    prom_type = "counter"

    def __init__(self, name: str, help_text: str, labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_text
        self.label_names = labels
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = defaultdict(float)

    def add(self, value: float, *label_values: str) -> None:
        with self._lock:
            self._values[label_values] += value

    def inc(self, *label_values: str) -> None:
        self.add(1.0, *label_values)

    def set(self, value: float, *label_values: str) -> None:
        with self._lock:
            self._values[label_values] = value

    def remove(self, *label_values: str) -> None:
        """Drop a labeled series — per-job series are pruned when the job
        is collected, or long-running servers grow /metrics unboundedly."""
        with self._lock:
            self._values.pop(label_values, None)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.prom_type}"]
        with self._lock:
            for labels, v in self._values.items():
                base = ",".join(f'{n}="{val}"' for n, val in zip(self.label_names, labels))
                lines.append(f"{self.name}{{{base}}} {v:g}")
        return "\n".join(lines)


class Gauge(Counter):
    """A settable series rendered with TYPE gauge (Counter already carries
    set(); only the exposition type differs — Prometheus clients treat a
    counter that goes down as a reset, so shares/versions must not render
    as counters)."""

    prom_type = "gauge"


_SUBSYSTEM = "volcano"

E2E_LATENCY = Histogram(
    f"{_SUBSYSTEM}_e2e_scheduling_latency_milliseconds",
    "E2E scheduling latency in milliseconds",
)
PLUGIN_LATENCY = Histogram(
    f"{_SUBSYSTEM}_plugin_scheduling_latency_microseconds",
    "Plugin scheduling latency in microseconds",
    ("plugin", "OnSession"),
)
ACTION_LATENCY = Histogram(
    f"{_SUBSYSTEM}_action_scheduling_latency_microseconds",
    "Action scheduling latency in microseconds",
    ("action",),
)
TASK_LATENCY = Histogram(
    f"{_SUBSYSTEM}_task_scheduling_latency_microseconds",
    "Task scheduling latency in microseconds",
)
SCHEDULE_ATTEMPTS = Counter(
    f"{_SUBSYSTEM}_schedule_attempts_total",
    "Number of attempts to schedule pods, by the result",
    ("result",),
)
POD_PREEMPTION_VICTIMS = Counter(
    f"{_SUBSYSTEM}_pod_preemption_victims",
    "Number of selected preemption victims",
)
PREEMPTION_ATTEMPTS = Counter(
    f"{_SUBSYSTEM}_total_preemption_attempts",
    "Total preemption attempts in the cluster till now",
)
UNSCHEDULE_TASK_COUNT = Counter(
    f"{_SUBSYSTEM}_unschedule_task_count",
    "Number of tasks could not be scheduled",
    ("job_id",),
)
UNSCHEDULE_JOB_COUNT = Counter(
    f"{_SUBSYSTEM}_unschedule_job_count",
    "Number of jobs could not be scheduled",
)
# metrics.go:113-121 — declared by the reference (never incremented there);
# here it counts jobs re-entering a cycle still unschedulable
JOB_RETRY_COUNTS = Counter(
    f"{_SUBSYSTEM}_job_retry_counts",
    "Number of retry attempts per job",
    ("job_id",),
)
# fallback-pressure counters: how much of the allocate replay ran
# outside the vectorized bulk path
SLOW_REPLAY_JOBS = Counter(
    f"{_SUBSYSTEM}_slow_replay_jobs_total",
    "Jobs replayed through the sequential Statement path",
)
HOST_FALLBACK_TASKS = Counter(
    f"{_SUBSYSTEM}_host_fallback_tasks_total",
    "Tasks placed by the O(nodes) host fallback scan",
)
# fault-hardening counters: classified transport retries,
# per-host circuit-breaker state, degraded-cycle parking/shedding, failover
TRANSPORT_RETRIES = Counter(
    f"{_SUBSYSTEM}_transport_retries_total",
    "Apiserver transport retries by endpoint class and error kind",
    ("endpoint_class", "kind"),
)
BREAKER_TRANSITIONS = Counter(
    f"{_SUBSYSTEM}_circuit_breaker_transitions_total",
    "Circuit breaker state transitions",
    ("host", "state"),
)
BREAKER_OPEN = Counter(
    f"{_SUBSYSTEM}_circuit_breaker_open",
    "1 while the named host's circuit breaker is open",
    ("host",),
)
RESYNC_PARKED = Counter(
    f"{_SUBSYSTEM}_resync_parked_total",
    "Failed bind/evict decisions parked in the resync queue, by reason",
    ("reason",),
)
RESYNC_DEPTH = Counter(
    f"{_SUBSYSTEM}_resync_queue_depth",
    "Tasks currently awaiting resync repair",
)
RESYNC_QUARANTINED = Counter(
    f"{_SUBSYSTEM}_resync_quarantined",
    "Tasks shelved after exhausting their resync budget",
)
STATUS_WRITES_SHED = Counter(
    f"{_SUBSYSTEM}_status_writes_shed_total",
    "Status writebacks skipped or made async by a degraded cycle",
)
CYCLE_BUDGET_EXCEEDED = Counter(
    f"{_SUBSYSTEM}_cycle_budget_exceeded_total",
    "Cycles whose soft time budget elapsed before close",
)
LEADER_FAILOVER = Counter(
    f"{_SUBSYSTEM}_leader_failover_total",
    "Leadership takeovers, by resident-cache outcome (warm|cold)",
    ("mode",),
)
# query-plane counters (serve/): the amortization story is readable straight
# off /metrics — requests_total vs device_dispatches_total is the
# requests-per-dispatch ratio the serving bench asserts
WHATIF_REQUESTS = Counter(
    f"{_SUBSYSTEM}_whatif_requests_total",
    "What-if probe requests, by verdict (feasible|infeasible|error)",
    ("verdict",),
)
WHATIF_DISPATCHES = Counter(
    f"{_SUBSYSTEM}_whatif_device_dispatches_total",
    "Batched probe device dispatches (one per flush window)",
)
WHATIF_BATCH_SIZE = Histogram(
    f"{_SUBSYSTEM}_whatif_batch_size",
    "Requests amortized into one probe dispatch",
)
WHATIF_QUEUE_DEPTH = Histogram(
    f"{_SUBSYSTEM}_whatif_queue_depth",
    "Whatif requests still queued at flush time",
)
WHATIF_LATENCY = Histogram(
    f"{_SUBSYSTEM}_whatif_request_latency_milliseconds",
    "Whatif request latency (enqueue to verdict) in milliseconds",
)
WHATIF_SNAPSHOT_VERSION = Gauge(
    f"{_SUBSYSTEM}_whatif_snapshot_version",
    "Dirty-tracker version token of the published snapshot lease",
)
# pipelined-cycle metrics (the event-driven loop): the latency the pipeline
# exists to optimize (pod ARRIVAL → bind DECISION, not just cycle ms), what
# woke each cycle, and how much egress the writeback stage hid behind the
# next cycle's compute
DECISION_LATENCY = Histogram(
    f"{_SUBSYSTEM}_arrival_to_decision_latency_milliseconds",
    "Pod-arrival to bind-decision latency in milliseconds",
)
TRIGGER_WAKES = Counter(
    f"{_SUBSYSTEM}_cycle_trigger_wakes_total",
    "Scheduling-cycle wakeups, by trigger (ingest|floor)",
    ("trigger",),
)
PIPELINE_OVERLAP = Histogram(
    f"{_SUBSYSTEM}_pipeline_writeback_overlap_milliseconds",
    "Writeback-stage time overlapped behind the next cycle (ms)",
)
STAGED_INGEST = Counter(
    f"{_SUBSYSTEM}_staged_ingest_events_total",
    "Ingest events applied through the staged (one-lock) drain",
)
# longitudinal fairness surfaced live (sim runner + any caller with
# per-queue share samples): dominant share vs weight entitlement per queue
QUEUE_SHARE = Gauge(
    f"{_SUBSYSTEM}_queue_dominant_share",
    "Per-queue dominant share of cluster capacity (0..1)",
    ("queue",),
)
QUEUE_ENTITLEMENT = Gauge(
    f"{_SUBSYSTEM}_queue_share_entitlement",
    "Per-queue weight entitlement (weight / Σ weights)",
    ("queue",),
)
# result-integrity guard plane (guard/): sentinel trips /
# fail-closed solves, shadow-oracle audit outcomes, and per-fast-path
# demotion state — the runtime twin of the KB_* oracle knobs
GUARD_TRIPS = Counter(
    f"{_SUBSYSTEM}_guard_trips_total",
    "Result-integrity trips (condemned solves), by action and reason "
    "(invariant|audit)",
    ("action", "reason"),
)
GUARD_AUDITS = Counter(
    f"{_SUBSYSTEM}_guard_audits_total",
    "Shadow-oracle audit comparisons, by result (match|mismatch)",
    ("result",),
)
GUARD_PATH_DEMOTED = Gauge(
    f"{_SUBSYSTEM}_guard_path_demoted",
    "1 while a fast path is demoted to its oracle (topk|shard_map|pallas)",
    ("path",),
)
# cycle tracing plane (obs/): per-stage latency straight off
# the span recorder (the histogram twin of the trace tree), flight-recorder
# dumps by trigger reason, and the guard trip-rate SLO alerts
STAGE_LATENCY = Histogram(
    f"{_SUBSYSTEM}_cycle_stage_latency_milliseconds",
    "Per-stage scheduling-cycle latency (span recorder) in milliseconds",
    ("stage",),
)
FLIGHT_DUMPS = Counter(
    f"{_SUBSYSTEM}_flight_recorder_dumps_total",
    "Flight-recorder trace dumps, by trigger reason",
    ("reason",),
)
ALERTS_FIRING = Gauge(
    f"{_SUBSYSTEM}_alerts_firing",
    "1 while the named SLO alert fires (guard trip-rate thresholds)",
    ("alert",),
)
# replicated follower read plane (replicate/): the leader's
# published stream (records/bytes by kind), the follower's apply/resync
# outcomes, and its live lag behind the stream head in cycles
REPLICATION_RECORDS = Counter(
    f"{_SUBSYSTEM}_replication_records_total",
    "Replication records published, by kind (full|delta|heartbeat)",
    ("kind",),
)
REPLICATION_BYTES = Counter(
    f"{_SUBSYSTEM}_replication_bytes_total",
    "Replication wire bytes published (encoded frames)",
)
REPLICATION_APPLIED = Counter(
    f"{_SUBSYSTEM}_replication_applied_total",
    "Replication records applied by this follower, by kind (full|delta)",
    ("kind",),
)
REPLICATION_RESYNCS = Counter(
    f"{_SUBSYSTEM}_replication_resyncs_total",
    "Delta-chain gaps that escalated this follower to a full resync",
)
REPLICATION_LAG = Gauge(
    f"{_SUBSYSTEM}_replication_lag_cycles",
    "Cycles this follower's applied state trails the stream head",
)
WHATIF_SWEEPS = Counter(
    f"{_SUBSYSTEM}_whatif_sweeps_total",
    "Capacity sweeps (/v1/whatif/sweep) served",
)

METRICS = [
    E2E_LATENCY,
    PLUGIN_LATENCY,
    ACTION_LATENCY,
    TASK_LATENCY,
    SCHEDULE_ATTEMPTS,
    POD_PREEMPTION_VICTIMS,
    PREEMPTION_ATTEMPTS,
    UNSCHEDULE_TASK_COUNT,
    UNSCHEDULE_JOB_COUNT,
    JOB_RETRY_COUNTS,
    SLOW_REPLAY_JOBS,
    HOST_FALLBACK_TASKS,
    TRANSPORT_RETRIES,
    BREAKER_TRANSITIONS,
    BREAKER_OPEN,
    RESYNC_PARKED,
    RESYNC_DEPTH,
    RESYNC_QUARANTINED,
    STATUS_WRITES_SHED,
    CYCLE_BUDGET_EXCEEDED,
    LEADER_FAILOVER,
    WHATIF_REQUESTS,
    WHATIF_DISPATCHES,
    WHATIF_BATCH_SIZE,
    WHATIF_QUEUE_DEPTH,
    WHATIF_LATENCY,
    WHATIF_SNAPSHOT_VERSION,
    DECISION_LATENCY,
    TRIGGER_WAKES,
    PIPELINE_OVERLAP,
    STAGED_INGEST,
    QUEUE_SHARE,
    QUEUE_ENTITLEMENT,
    GUARD_TRIPS,
    GUARD_AUDITS,
    GUARD_PATH_DEMOTED,
    STAGE_LATENCY,
    FLIGHT_DUMPS,
    ALERTS_FIRING,
    REPLICATION_RECORDS,
    REPLICATION_BYTES,
    REPLICATION_APPLIED,
    REPLICATION_RESYNCS,
    REPLICATION_LAG,
    WHATIF_SWEEPS,
]


def observe_e2e_latency(ms: float) -> None:
    E2E_LATENCY.observe(ms)


def observe_action_latency(action: str, us: float) -> None:
    ACTION_LATENCY.observe(us, action)


def observe_plugin_latency(plugin: str, on_session: str, us: float) -> None:
    PLUGIN_LATENCY.observe(us, plugin, on_session)


def observe_task_latency(us: float) -> None:
    TASK_LATENCY.observe(us)


def observe_task_latencies(us_each: float, count: int) -> None:
    """Amortized per-task latency for `count` placements of one cycle —
    the vectorized analog of the reference's per-task observation
    (metrics.go:66-72, session.go:321)."""
    TASK_LATENCY.observe_many(us_each, count)


def register_schedule_attempt(result: str) -> None:
    SCHEDULE_ATTEMPTS.inc(result)


def update_preemption_victims(count: int) -> None:
    POD_PREEMPTION_VICTIMS.add(count)


def register_preemption_attempt() -> None:
    PREEMPTION_ATTEMPTS.inc()


def update_unschedule_task_count(job_id: str, count: int) -> None:
    UNSCHEDULE_TASK_COUNT.set(count, job_id)


def update_unschedule_job_count(count: int) -> None:
    UNSCHEDULE_JOB_COUNT.set(count)


def register_job_retry(job_id: str) -> None:
    JOB_RETRY_COUNTS.inc(job_id)


def prune_job_series(job_id: str) -> None:
    """Forget a collected job's labeled series (job_retry_counts,
    unschedule_task_count) — the cardinality bound for per-job labels."""
    JOB_RETRY_COUNTS.remove(job_id)
    UNSCHEDULE_TASK_COUNT.remove(job_id)


def register_slow_replay_jobs(count: int) -> None:
    if count:
        SLOW_REPLAY_JOBS.add(count)


def register_host_fallback_tasks(count: int) -> None:
    if count:
        HOST_FALLBACK_TASKS.add(count)


def register_transport_retry(endpoint_class: str, kind: str) -> None:
    TRANSPORT_RETRIES.inc(endpoint_class, kind)


def register_breaker_transition(host: str, state: str) -> None:
    BREAKER_TRANSITIONS.inc(host, state)


def set_breaker_open(host: str, is_open: int) -> None:
    BREAKER_OPEN.set(float(is_open), host)


def register_resync_parked(reason: str) -> None:
    RESYNC_PARKED.inc(reason)


def set_resync_depth(depth: int, quarantined: int) -> None:
    RESYNC_DEPTH.set(float(depth))
    RESYNC_QUARANTINED.set(float(quarantined))


def register_status_writes_shed(count: int) -> None:
    if count:
        STATUS_WRITES_SHED.add(count)


def register_cycle_budget_exceeded() -> None:
    CYCLE_BUDGET_EXCEEDED.inc()


def register_leader_failover(mode: str) -> None:
    LEADER_FAILOVER.inc(mode)


def register_guard_trip(action: str, reason: str) -> None:
    GUARD_TRIPS.inc(action, reason)


def register_guard_audit(result: str) -> None:
    GUARD_AUDITS.inc(result)


def set_guard_path_demoted(path: str, demoted: int) -> None:
    GUARD_PATH_DEMOTED.set(demoted, path)


def observe_stage_latency(stage: str, ms: float) -> None:
    STAGE_LATENCY.observe(ms, stage)


def register_flight_dump(reason: str) -> None:
    FLIGHT_DUMPS.inc(reason)


def set_alert_firing(alert: str, firing: int) -> None:
    ALERTS_FIRING.set(float(firing), alert)


def register_whatif_request(verdict: str) -> None:
    WHATIF_REQUESTS.inc(verdict)


def register_whatif_dispatch() -> None:
    WHATIF_DISPATCHES.inc()


def observe_whatif_batch(size: int, queue_depth: int) -> None:
    WHATIF_BATCH_SIZE.observe(float(size))
    WHATIF_QUEUE_DEPTH.observe(float(queue_depth))


def observe_whatif_latency(ms: float) -> None:
    WHATIF_LATENCY.observe(ms)


def set_whatif_snapshot_version(version: int) -> None:
    WHATIF_SNAPSHOT_VERSION.set(float(version))


def register_replication_record(kind: str, nbytes: int) -> None:
    REPLICATION_RECORDS.inc(kind)
    if nbytes:
        REPLICATION_BYTES.add(float(nbytes))


def register_replication_applied(kind: str) -> None:
    REPLICATION_APPLIED.inc(kind)


def register_replication_resync() -> None:
    REPLICATION_RESYNCS.inc()


def set_replication_lag(lag: int) -> None:
    REPLICATION_LAG.set(float(lag))


def register_whatif_sweep() -> None:
    WHATIF_SWEEPS.inc()


# optional exact-sample sink for the decision-latency stream: a drive that
# needs true p50/p99 over the raw samples, which the 5·2^k histogram
# buckets are far too coarse for — a registered list receives every ms
# value alongside the histogram observation
_decision_sink = None


def set_decision_latency_sink(sink) -> None:
    """Register (or clear, sink=None) a list that receives every raw
    arrival→decision latency sample in ms."""
    global _decision_sink
    _decision_sink = sink


def observe_decision_latencies(ms_values) -> None:
    """Record arrival→decision latencies for one cycle's bind decisions."""
    DECISION_LATENCY.observe_values(ms_values)
    sink = _decision_sink
    if sink is not None:
        sink.extend(ms_values)


def register_trigger_wake(trigger: str) -> None:
    TRIGGER_WAKES.inc(trigger)


def observe_pipeline_overlap(ms: float) -> None:
    PIPELINE_OVERLAP.observe(ms)


def register_staged_ingest(count: int) -> None:
    if count:
        STAGED_INGEST.add(count)


def set_queue_shares(shares: dict) -> None:
    """Export per-queue {share, entitlement} samples as live gauges — the
    simulator (``sim/runner.py``) feeds its fairness series here every
    cycle; any caller with the same sample shape may.  Queues absent
    from the sample are pruned: a deleted queue must not export a phantom
    share forever."""
    live = {(q,) for q in shares}
    for gauge in (QUEUE_SHARE, QUEUE_ENTITLEMENT):
        for stale in [k for k in list(gauge._values) if k not in live]:
            gauge.remove(*stale)
    for queue, s in shares.items():
        QUEUE_SHARE.set(float(s.get("share", 0.0)), queue)
        QUEUE_ENTITLEMENT.set(float(s.get("entitlement", 0.0)), queue)


def render_prometheus() -> str:
    return "\n".join(m.render() for m in METRICS) + "\n"
