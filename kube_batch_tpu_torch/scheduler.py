"""Scheduler — the L1 loop (pkg/scheduler/scheduler.go:38-102), mirroring
``kube_batch_tpu/scheduler.py``.

Each cycle opens an exclusive session, runs the configured actions in
order and closes the session.  ``run_forever`` is the reference's
wait.Until(runOnce, period) and, by default, its pipelined successor: the
cycle is a staged pipeline

    ingest drain → resync drain → session open → actions → status derive
                 ║ writeback (status flush + bind drain)

where everything left of ║ runs on the cycle thread and the writeback
stage runs on one worker: cycle N+1's ingest drain, open and device
programs proceed while cycle N's status flush and bind drain complete.
The cycle thread is the only one that launches work on the card; the
writeback and dispatch workers touch host values and pods only.  Cycles
are triggered by events: the cache's dirty-version advance wakes a
condition variable, so an arrival schedules at once instead of waiting
out the 1 s tick, while an idle cluster ticks at the slow floor.

    sched = Scheduler(cache, conf=parse_scheduler_conf(text), device="cpu")
    sched.run_once()            # one serial cycle, the oracle
    sched.run_forever()         # until stop(), pipelined unless KB_PIPELINE=0

Knobs: ``KB_PIPELINE=0`` restores the serial loop (the bit-exactness
oracle); ``KB_PERIOD_MIN`` pins the minimum spacing between cycle starts
(unset, it follows an EWMA of the measured cycle cost,
:meth:`Scheduler._note_cycle_cost`); ``KB_PERIOD_MAX`` is the idle tick
(default: the schedule period); ``KB_CYCLE_BUDGET`` (seconds, 0 = off) a
soft cycle budget whose overrun sheds the close's status writes.  A conf
loaded from ``conf_path`` is reloaded at a cycle boundary when the file
changes, and a broken edit keeps the running conf.  ``device=None`` means
CUDA and raises without a card.  ``mesh=`` (``parallel/mesh.py``) is where
the solves run sharded once the node axis reaches ``SHARD_MIN_NODES``;
by default every CUDA card (no mesh with one card or on the CPU).

Every stage of the cycle runs inside a span of the cache's tracer
(``obs/trace.py``): ``ingest_drain``, ``resync``, ``session_open``,
``action:<name>``, ``status_derive``, then ``writeback_barrier``
(pipelined) or ``bind_drain`` (serial), and the worker's ``writeback`` on
the originating cycle's record.  The spans are the measurement: the
action latency histogram reads each action span's stamps, and
``last_cycle_ms`` holds the cycle's span times.  After the guard plane's
cycle clock advances, the trip-rate alerts are evaluated
(``obs/alerts.py``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from kube_batch_tpu_torch import actions as _actions  # noqa: F401 — registers actions
from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch import plugins as _plugins  # noqa: F401 — registers plugins
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.framework.conf import SchedulerConfiguration, load_scheduler_conf
from kube_batch_tpu_torch.framework.interface import Action, get_action, get_plugin_builder
from kube_batch_tpu_torch.framework.session import close_session, open_session
from kube_batch_tpu_torch.obs.alerts import alerts_of
from kube_batch_tpu_torch.obs.trace import tracer_of
from kube_batch_tpu_torch.utils import telemetry
from kube_batch_tpu_torch.utils.switches import switch_on
from kube_batch_tpu_torch.utils.worker import SerialWorker

logger = logging.getLogger("kube_batch_tpu_torch")


class CycleTrigger:
    """Event-driven cycle pacing: the cache's dirty-version advance and the
    staged-ingest arrival call :meth:`notify`; the loop waits on the
    condition variable between cycles.  A pending signal, even one raised
    mid-cycle, wakes the next cycle as soon as the ``min_period`` rate
    floor allows; with no signal the loop idles until ``max_period`` since
    the last cycle start.  Deadlines read the injected clock; the blocking
    is the condition variable's real-time wait, re-armed each lap."""

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else time
        self._cond = threading.Condition(lock=threading.Lock())
        self._pending = False

    def notify(self) -> None:
        """Wake the loop.  Never blocks; safe from any thread, also under
        the cache's locks (the condition's lock is a leaf)."""
        with self._cond:
            self._pending = True
            self._cond.notify_all()

    def poll(self) -> bool:
        """Consume a pending signal without waiting."""
        with self._cond:
            pending, self._pending = self._pending, False
            return pending

    def wait_for_work(self, cycle_start: float, min_period: float,
                      max_period: float) -> str:
        """Block until the next cycle should start; returns why it woke:
        ``"ingest"`` (a signal) or ``"floor"`` (the idle period elapsed).
        The rate floor comes first, so a burst coalesces into one cycle per
        ``min_period``."""
        clock = self.clock
        floor_rem = min_period - (clock.monotonic() - cycle_start)
        if floor_rem > 0:
            clock.sleep(floor_rem)
        deadline = cycle_start + max_period
        with self._cond:
            while not self._pending:
                rem = deadline - clock.monotonic()
                if rem <= 0:
                    return "floor"
                self._cond.wait(rem)
            self._pending = False
            return "ingest"


class Scheduler:
    # EWMA smoothing of the adaptive coalescing floor, and its clamps: the
    # floor never drops below 5 ms (a degenerate idle cycle must not let a
    # hot ingest stream busy-spin the loop) and never exceeds max_period
    EWMA_ALPHA = 0.2
    MIN_PERIOD_FLOOR = 0.005

    def __init__(
        self,
        cache: SchedulerCache,
        conf: Optional[SchedulerConfiguration] = None,
        conf_path: Optional[str] = None,
        schedule_period: float = 1.0,
        on_cycle_end=None,
        clock=None,
        device=None,
        mesh=None,
    ):
        self.cache = cache
        # the loop's time source (monotonic() and sleep())
        self.clock = clock if clock is not None else time
        self.conf = conf if conf is not None else load_scheduler_conf(conf_path)
        # resolve actions at construction — unknown names raise (util.go:63-70)
        self.actions: List[Action] = [get_action(n) for n in self.conf.actions]
        self.device = resolve_device(device)
        # where the solves run sharded (parallel/mesh.py): the caller's
        # mesh, else every CUDA card (None with one card and on the CPU)
        from kube_batch_tpu_torch.parallel.mesh import default_mesh

        self.mesh = mesh if mesh is not None else default_mesh(self.device)
        self.schedule_period = schedule_period
        self.on_cycle_end = on_cycle_end
        self._stop = False
        # conf hot-reload: a conf loaded from a path is re-read at a cycle
        # boundary when the file's mtime changes; the first cycle checks
        self._conf_path = conf_path if conf is None else None
        self._conf_mtime: Optional[float] = None
        # soft per-cycle time budget (seconds; 0 = off)
        self.cycle_budget = float(os.environ.get("KB_CYCLE_BUDGET", "0") or 0)
        # the pipelined loop (KB_PIPELINE=0 gives the serial oracle)
        self.pipelined = switch_on("KB_PIPELINE")
        # cycle-start spacing: bursts coalesce to one cycle per min_period
        # (adaptive unless KB_PERIOD_MIN pins it); an idle cluster ticks
        # every max_period
        raw_min = os.environ.get("KB_PERIOD_MIN", "")
        self.min_period_pinned = bool(raw_min.strip())
        self.min_period = float(raw_min or min(0.05, schedule_period))
        self.max_period = float(os.environ.get("KB_PERIOD_MAX", "") or schedule_period)
        # EWMA of the measured cycle cost (seconds); None before the first
        # pipelined cycle
        self.cycle_cost_ewma: Optional[float] = None
        self.trigger = CycleTrigger(clock=self.clock)
        # the cache's span recorder and flight-recorder ring; virtual-time
        # stamps follow an injected clock
        self.tracer = tracer_of(cache, clock=self.clock)
        # the writeback stage: one worker, at most one cycle's flush in
        # flight while the next cycle computes (_await_writeback joins it)
        self._wb_worker: Optional[SerialWorker] = None
        self._wb_future = None
        # wall-clock ms of the last cycle's stage spans: ingest_drain,
        # resync, open (session_open), action:<name>, close
        # (status_derive), writeback_barrier (pipelined) or bind_drain
        # (serial)
        self.last_cycle_ms: Dict[str, float] = {}
        # wall-clock ms of the last writeback span, on its worker
        self.last_writeback_ms: Optional[float] = None
        # cycles and writeback stages that raised (each is logged, and the
        # next cycle re-derives the state)
        self.failed_cycles = 0
        self.failed_writebacks = 0
        # why each pipelined cycle of run_forever woke: "ingest" or "floor"
        self.wake_reasons: Dict[str, int] = {"ingest": 0, "floor": 0}

    # ---- conf hot-reload -------------------------------------------------
    def _stat_conf(self) -> Optional[float]:
        if not self._conf_path:
            return None
        try:
            return os.path.getmtime(self._conf_path)
        except OSError:
            return None

    def _maybe_reload_conf(self) -> None:
        if not self._conf_path:
            return
        mtime = self._stat_conf()
        if mtime is None or mtime == self._conf_mtime:
            return
        try:
            conf = load_scheduler_conf(self._conf_path)
            # resolve everything the conf names before swapping: an unknown
            # action or plugin rejects the edit here
            actions = [get_action(n) for n in conf.actions]
            for tier in conf.tiers:
                for opt in tier.plugins:
                    get_plugin_builder(opt.name)
        except Exception as e:  # noqa: BLE001 — keep the running conf
            logger.error("scheduler conf reload failed (%s); keeping the "
                         "running configuration", e)
            self._conf_mtime = mtime  # don't re-log every cycle
            return
        if conf.actions != self.conf.actions or conf.tiers != self.conf.tiers:
            logger.info("scheduler conf hot-reloaded: actions=%s", conf.actions)
            self.conf, self.actions = conf, actions
        self._conf_mtime = mtime

    # ---- cycles ----------------------------------------------------------
    def run_once(self) -> None:
        """One serial cycle (scheduler.go:88-102): every stage inline, the
        bind drain at the end, a deterministic post-cycle state.  This form
        is the bit-exactness oracle (KB_PIPELINE=0)."""
        self._cycle(pipelined=False)

    def run_once_pipelined(self) -> None:
        """One pipelined cycle: staged ingest drains under one lock, the
        session opens and the actions run on this thread, the close derives
        the status pass and hands its egress (status flush and bind drain)
        to the writeback worker, to overlap the caller's next cycle.
        :meth:`drain_pipeline`, or the next cycle's barrier, joins it."""
        self._cycle(pipelined=True)

    def _cycle(self, pipelined: bool) -> None:
        tracer = self.tracer
        # the cycle's trace record: every stage below runs inside a span;
        # the pipelined writeback attaches to this record from its worker
        record = tracer.begin_cycle("pipelined" if pipelined else "serial")
        try:
            self._cycle_body(pipelined, record)
        finally:
            tracer.end_cycle()

    def _cycle_body(self, pipelined: bool, record) -> None:
        cache = self.cache
        tracer = self.tracer
        cycle: Dict[str, float] = {}
        if pipelined:
            # ingest stage: applied before the resync drain, so repair
            # decisions see the freshest pod store
            with tracer.span("ingest_drain") as sp:
                n_staged = cache.drain_staged_ingest()
                sp.set(events=n_staged)
            cycle["ingest_drain"] = sp.dur_ms
            metrics.register_staged_ingest(n_staged)
        # the resync queue drains at every cycle boundary, so a failed bind
        # or evict is repaired within one cycle
        with tracer.span("resync") as sp:
            cache.process_resync_tasks()
        cycle["resync"] = sp.dur_ms
        self._maybe_reload_conf()
        start = telemetry.perf_counter()
        budget_start = self.clock.monotonic() if self.cycle_budget > 0 else 0.0
        with tracer.span("session_open") as sp:
            ssn = open_session(cache, self.conf.tiers, self.device, mesh=self.mesh)
        cycle["open"] = sp.dur_ms
        # the configured pipeline, for actions whose behaviour depends on
        # what runs after them (reclaim's idle-fit claimant gate)
        ssn.action_names = [a.name for a in self.actions]
        staged_flush = None
        try:
            for action in self.actions:
                # the span is the measurement: the action latency histogram
                # reads its stamps
                with tracer.span("action:" + action.name) as sp:
                    action.execute(ssn)
                cycle["action:" + action.name] = sp.dur_ms
                metrics.observe_action_latency(action.name, sp.dur_us)
        finally:
            shed = (self.cycle_budget > 0
                    and self.clock.monotonic() - budget_start > self.cycle_budget)
            if shed:
                logger.warning("cycle over its %.2fs soft budget before close; "
                               "shedding the status flush", self.cycle_budget)
                metrics.register_cycle_budget_exceeded()
                # a shed is a flight-recorder anomaly: the cycles around it
                # show where the budget went
                tracer.anomaly("budget_shed",
                               detail=f"cycle over KB_CYCLE_BUDGET={self.cycle_budget}s")
                cache.shed_status_writes = True
            try:
                # pipelined: the close stages the flush (the degraded verdict
                # taken now, while the shed flag is visible) and skips the
                # bind drain; both run on the writeback worker
                with tracer.span("status_derive") as sp:
                    staged_flush = close_session(ssn, stage_flush=pipelined)
                cycle["close"] = sp.dur_ms
            finally:
                if shed:
                    cache.shed_status_writes = False
                if pipelined:
                    # the stage barrier: join cycle N-1's writeback, then
                    # hand off ours.  Inside the finally: a cycle that died
                    # in an action still staged its flush, whose queue
                    # deltas are already recorded as written; a close whose
                    # own finally raised is recovered from the session
                    if staged_flush is None:
                        staged_flush = ssn.staged_flush
                    with tracer.span("writeback_barrier") as sp:
                        self._await_writeback()
                    cycle["writeback_barrier"] = sp.dur_ms
                    self._submit_writeback(staged_flush, record)
                self.last_cycle_ms = cycle
        metrics.observe_e2e_latency((telemetry.perf_counter() - start) * 1e3)
        if not pipelined:
            # the serial close joined the dispatcher already; a bind
            # dispatched after it (none today) is joined here
            with tracer.span("bind_drain") as sp:
                cache.flush_binds()
            cycle["bind_drain"] = sp.dur_ms
        # the guard plane's breaker clock counts scheduling cycles, and the
        # trip-rate alerts ride the same clock
        guard = getattr(cache, "guard_plane", None)
        if guard is not None:
            guard.end_cycle()
            alerts_of(cache).evaluate(guard)
        if self.on_cycle_end is not None:
            self.on_cycle_end()

    # ---- the writeback stage (the overlapped half of the pipeline) -------
    def _writeback(self, staged_flush, record=None) -> float:
        """The status flush, then the bind drain, in a span on the
        originating cycle's record; returns its wall ms."""
        with self.tracer.cycle_span("writeback", record) as sp:
            if staged_flush:
                self.cache.run_status_flush(staged_flush)
            self.cache.flush_binds()
        metrics.observe_pipeline_overlap(sp.dur_ms)
        return sp.dur_ms

    def _submit_writeback(self, staged_flush, record=None) -> None:
        if self._wb_worker is None:
            self._wb_worker = SerialWorker("kb-writeback")
        self._wb_future = self._wb_worker.submit(self._writeback, staged_flush, record)

    def _await_writeback(self) -> None:
        fut, self._wb_future = self._wb_future, None
        if fut is not None:
            try:
                self.last_writeback_ms = fut.result()
            except Exception:  # noqa: BLE001 — the next close re-derives
                self.failed_writebacks += 1
                logger.exception("writeback stage failed; statuses will "
                                 "re-derive next cycle")

    def _note_cycle_cost(self, elapsed: float) -> None:
        """Feed one measured cycle cost (seconds, injected clock) into the
        adaptive min period: EWMA-smooth it and, unless KB_PERIOD_MIN
        pinned the floor, retarget the trigger's coalescing window."""
        if elapsed < 0:
            return
        prev = self.cycle_cost_ewma
        self.cycle_cost_ewma = (
            elapsed if prev is None
            else self.EWMA_ALPHA * elapsed + (1.0 - self.EWMA_ALPHA) * prev)
        if not self.min_period_pinned:
            self.min_period = min(max(self.cycle_cost_ewma, self.MIN_PERIOD_FLOOR),
                                  self.max_period)

    def drain_pipeline(self) -> None:
        """Join the in-flight writeback stage and the replication encode, and
        apply any staged ingest: the deterministic post-cycle state that the
        serial run_once gives inline."""
        self._await_writeback()
        # the replication publisher's encode overlaps the next cycle like the
        # writeback stage: joined at the same barrier, so a drained pipeline
        # has the cycle's record on the stream
        rep = getattr(self.cache, "replication", None)
        if rep is not None:
            rep.barrier()
        metrics.register_staged_ingest(self.cache.drain_staged_ingest())

    def _recover_failed_cycle(self) -> None:
        # an exclusive session mutates the cache in place: a cycle that
        # died partway may have left partial state — rebuild from the pod
        # store (the informer re-list) before the next cycle.  The binds
        # the dead cycle dispatched are joined first, so the rebuild sees
        # their acks (a pipelined close leaves that join to the writeback;
        # without it a bind acked after the rebuild would be placed again)
        self.cache.flush_binds()
        try:
            self.cache.rebuild_from_pod_store()
        except Exception:  # noqa: BLE001
            logger.exception("re-list recovery failed")

    def run_forever(self) -> None:
        """The L1 loop, preceded by the cache's background repair loop
        (scheduler.go:63-86, cache.go:342-384) and followed by its stop.
        KB_PIPELINE=0 gives the reference's serial wait.Until(runOnce,
        period); the default is the event-driven pipelined loop.  A failed
        cycle is logged, the cache is rebuilt from the pod store, and the
        loop goes on."""
        self.cache.run(resync_period=min(self.schedule_period, 1.0))
        self._stop = False
        try:
            if self.pipelined:
                self._run_forever_pipelined()
                return
            while not self._stop:
                tick = self.clock.monotonic()
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001 — the next cycle self-corrects
                    self.failed_cycles += 1
                    logger.exception("scheduling cycle failed")
                    self._recover_failed_cycle()
                elapsed = self.clock.monotonic() - tick
                self.clock.sleep(max(self.schedule_period - elapsed, 0.0))
        finally:
            self.cache.stop()

    def _run_forever_pipelined(self) -> None:
        """The event-driven pipelined loop (run_forever holds the cache's
        run / stop bracket): ingest stages into the leaf buffer, the dirty
        tracker's advance wakes the trigger, and shutdown drains every
        in-flight stage before the cache stops."""
        cache = self.cache
        cache.set_ingest_signal(self.trigger.notify)
        cache.enable_ingest_staging()
        logger.info("pipelined cycle loop: min_period=%.3fs max_period=%.3fs "
                    "(KB_PIPELINE=0 for the serial oracle)",
                    self.min_period, self.max_period)
        try:
            while not self._stop:
                tick = self.clock.monotonic()
                try:
                    self.run_once_pipelined()
                    # successful cycles only: a fast-crashing cycle must not
                    # drag the adaptive floor down into a crash-retry spin
                    self._note_cycle_cost(self.clock.monotonic() - tick)
                except Exception:  # noqa: BLE001 — the next cycle self-corrects
                    self.failed_cycles += 1
                    logger.exception("scheduling cycle failed")
                    self._recover_failed_cycle()
                reason = self.trigger.wait_for_work(tick, self.min_period,
                                                    self.max_period)
                self.wake_reasons[reason] += 1
                metrics.register_trigger_wake(reason)
        finally:
            # shutdown drain: apply staged ingest, join the writeback, and
            # detach the trigger so a re-armed run_forever starts clean
            try:
                cache.disable_ingest_staging()
                self.drain_pipeline()
            finally:
                cache.set_ingest_signal(None)
                self._retire_writeback()

    def _retire_writeback(self) -> None:
        worker, self._wb_worker = self._wb_worker, None
        if worker is not None and not worker.shutdown(timeout=30.0):
            logger.error("writeback worker did not stop within 30 s")

    def stop(self) -> None:
        """End run_forever after its current cycle (a pipelined loop idling
        at the slow floor is woken)."""
        self._stop = True
        self.trigger.notify()

    def close(self) -> None:
        """Join the in-flight writeback and retire its worker.  run_forever
        does this itself; a caller of run_once_pipelined calls close()."""
        self.drain_pipeline()
        self._retire_writeback()
