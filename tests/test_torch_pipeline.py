"""The port's pipelined loop against its serial cycle and the JAX package.

The cases of the JAX package's ``tests/test_pipeline.py``, on the port:
the pipelined cycle (``run_once_pipelined`` + ``drain_pipeline``) against
the serial one over seeded churn, staged ingest, the ``CycleTrigger``, the
adaptive min period, ``run_forever``'s burst and shutdown drain, the
budget shed with the overlapped close, the writeback's robustness, the
close's edge cases and the in-flight bind guard.  Where a case makes a
decision, the JAX package runs on the same events: the port's serial
cycles, its pipelined cycles and the JAX package's cycles must agree
after every cycle (binds, evictions, task statuses and nodes, PodGroup
phases and conditions, pod conditions, queue statuses), under the
built-in and the shipped conf, with the port at its defaults and as the
oracle, with direct and with staged ingest.  The chip drives' pipelined
steady leg and loop drive run small on the CPU at the end.

Every threaded case waits with a timeout and stops what it started in a
``finally``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest

from kube_batch_tpu.api.pod import GROUP_NAME_ANNOTATION, Node, Pod, PodGroup, Queue
from kube_batch_tpu.api.types import PodPhase
from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
from kube_batch_tpu.framework.session import close_session as jax_close
from kube_batch_tpu.framework.session import open_session as jax_open
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.cache.cache import SchedulerCache, StatusFlush
from kube_batch_tpu_torch.framework.session import close_session, open_session
from kube_batch_tpu_torch.scheduler import CycleTrigger, Scheduler
from kube_batch_tpu_torch.testing.cycle_drive import oracle_switches
from test_torch_cycle import CONFS, _assert_same, mirror, observed

GiB = float(1 << 30)


# --------------------------------------------------------------------------
# three caches fed the same events
# --------------------------------------------------------------------------


def cluster_events(n_nodes: int = 4, cpu: float = 4000.0):
    """Two queues and ``n_nodes`` nodes small enough that churn leaves
    gangs pending (conditions, queue statuses) and, under the shipped
    conf, gives reclaim and preempt work."""
    events = [("add_queue", Queue(name=f"q{q}", uid=f"uq{q}", weight=q + 1))
              for q in range(2)]
    events += [("add_node", Node(name=f"n{i}", allocatable={
        "cpu": cpu, "memory": 64 * GiB, "pods": 110.0})) for i in range(n_nodes)]
    return events


class Caches:
    """A JAX cache (serial cycles at its defaults), a port cache run
    serially and a port cache run pipelined, built from the same events;
    the port's pair at its defaults or as the oracle."""

    def __init__(self, conf: str, oracle: bool = False, staged: bool = False):
        self.j = JaxCache()
        self.s, self.p = SchedulerCache(), SchedulerCache()
        self.port = (self.s, self.p)
        for cache in (self.j, *self.port):
            # compaction, the resident snapshot and the warm carry engage
            cache.columns.reserve(n_tasks=1024, n_nodes=64)
        self.oracle = oracle
        for cache in self.port:
            cache.delta_enabled = not oracle
        self.apply(cluster_events())
        jconf, pconf = CONFS[conf]()
        self.jsched = JaxScheduler(self.j, conf=jconf)
        self.ssched = Scheduler(self.s, conf=pconf, device="cpu")
        self.psched = Scheduler(self.p, conf=CONFS[conf]()[1], device="cpu")
        if staged:
            self.p.enable_ingest_staging()

    def apply(self, events) -> None:
        for kind, obj in events:
            getattr(self.j, kind)(obj)
            for cache in self.port:
                getattr(cache, kind)(mirror(obj))

    def cycle(self, where: str) -> None:
        self.jsched.run_once()
        with oracle_switches(self.oracle):
            self.ssched.run_once()
            self.psched.run_once_pipelined()
            self.psched.drain_pipeline()
        want = observed(self.j)
        _assert_same(want, observed(self.s), f"{where} serial")
        _assert_same(want, observed(self.p), f"{where} pipelined")
        for cache in self.port:
            assert cache.columns.check_consistency(cache) == [], where
        channel = self.p.binder.channel
        assert len(channel) == len(set(channel)), f"{where}: a pod was bound twice"

    def close(self) -> None:
        self.psched.close()
        for cache in self.port:
            cache.stop()


class Churn:
    """``tests/test_pipeline.py``'s seeded churn as ingest events, decided
    on the JAX cache: gangs arrive, complete (pods and PodGroup deleted) or
    move on (bound pods start Running, running pods succeed), and evicted
    pods are deleted."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.serial = 0
        self.gangs = []

    def add_gang(self):
        self.serial += 1
        g, rng = f"g{self.serial}", self.rng
        size = int(rng.integers(1, 4))
        events = [("add_pod_group", PodGroup(
            name=g, namespace="churn", uid=f"pg-{g}", min_member=size,
            queue=f"q{int(rng.integers(2))}", creation_index=self.serial))]
        for k in range(size):
            events.append(("add_pod", Pod(
                name=f"{g}-{k}", namespace="churn", uid=f"pod-{g}-{k}",
                requests={"cpu": float(rng.choice([250.0, 500.0, 1000.0])),
                          "memory": 1 * GiB},
                annotations={GROUP_NAME_ANNOTATION: g}, phase=PodPhase.PENDING,
                creation_index=self.serial * 100 + k)))
        self.gangs.append(g)
        return events

    def complete_gang(self, jcache):
        if not self.gangs:
            return []
        g = self.gangs.pop(int(self.rng.integers(len(self.gangs))))
        job = jcache.jobs.get(f"churn/{g}")
        keys = sorted(job.tasks) if job is not None else []
        return ([("delete_pod", jcache.pods[k]) for k in keys if k in jcache.pods]
                + [("delete_pod_group", f"churn/{g}")])

    def flip_statuses(self, jcache):
        pods = sorted((p for p in jcache.pods.values() if p.node_name),
                      key=lambda p: p.key())
        events = []
        for p in pods[: int(self.rng.integers(1, 3))] if pods else []:
            if p.phase == PodPhase.PENDING:
                events.append(("update_pod", dataclasses.replace(p, phase=PodPhase.RUNNING)))
            elif p.phase == PodPhase.RUNNING and self.rng.random() < 0.5:
                events.append(("update_pod", dataclasses.replace(p, phase=PodPhase.SUCCEEDED)))
        return events

    def step(self, jcache):
        evicted = [("delete_pod", jcache.pods[k])
                   for k in sorted(set(jcache.evictor.evicts)) if k in jcache.pods]
        r = self.rng.random()
        if r < 0.45:
            return evicted + self.add_gang()
        if r < 0.70:
            return evicted + self.complete_gang(jcache)
        return evicted + self.flip_statuses(jcache)


def run_churn(caches: Caches, seed: int, cycles: int = 10) -> None:
    churn = Churn(seed)
    for _ in range(3):
        caches.apply(churn.add_gang())
    for c in range(cycles):
        caches.apply(churn.step(caches.j))
        caches.cycle(f"seed {seed} cycle {c}")


PATHS = [pytest.param(conf, path, id=f"{conf}-{path}")
         for conf in sorted(CONFS) for path in ("defaults", "oracle")]


class TestPipelinedBitExact:
    @pytest.mark.parametrize("conf,path", PATHS)
    @pytest.mark.parametrize("seed", [0, 11, 42])
    def test_pipelined_matches_serial_and_jax_over_churn(self, seed, conf, path):
        """The same churn stream: the port's serial and pipelined cycles and
        the JAX package's agree after every one of 10 cycles, with no
        duplicate bind."""
        caches = Caches(conf, oracle=path == "oracle")
        try:
            run_churn(caches, seed)
            assert caches.p.binder.binds and caches.p.status_updater.queue_statuses
        finally:
            caches.close()

    @pytest.mark.parametrize("conf,path", PATHS)
    def test_pipelined_with_staged_ingest_matches(self, conf, path):
        """The churn lands in the pipelined cache's staging buffer and the
        next cycle's drain applies it under one lock: the same end state
        after every cycle as direct ingest and the JAX package."""
        caches = Caches(conf, oracle=path == "oracle", staged=True)
        try:
            run_churn(caches, 5, cycles=8)
            assert caches.p.ingest_staging
            with caches.p._ingest_lock:
                assert caches.p._ingest_staged == []
        finally:
            caches.close()


# --------------------------------------------------------------------------
# staged ingest (no decision: the port alone)
# --------------------------------------------------------------------------


def small_cache(n_nodes: int = 1) -> SchedulerCache:
    cache = SchedulerCache()
    for kind, obj in cluster_events(n_nodes, cpu=16000.0):
        getattr(cache, kind)(mirror(obj))
    return cache


def port_pod(name: str, **kw):
    return mirror(Pod(name=name, namespace="ns", uid=f"u-{name}",
                      requests={"cpu": 100.0}, phase=PodPhase.PENDING,
                      creation_index=1, **kw))


class TestStagedIngest:
    def test_staged_events_invisible_until_drain(self):
        cache = small_cache()
        cache.enable_ingest_staging()
        cache.add_pod(port_pod("p0"))
        assert "ns/p0" not in cache.pods
        assert cache.drain_staged_ingest() == 1
        assert "ns/p0" in cache.pods

    def test_staged_arrival_fires_wake_signal(self):
        cache = small_cache()
        wakes = []
        cache.set_ingest_signal(lambda: wakes.append(1))
        cache.enable_ingest_staging()
        cache.add_pod(port_pod("p1"))
        assert wakes, "a staged arrival must wake the cycle trigger"

    def test_direct_dirty_advance_fires_wake_signal(self):
        cache = small_cache()
        wakes = []
        cache.set_ingest_signal(lambda: wakes.append(1))
        cache.add_pod(port_pod("p2"))
        assert wakes, "an unstaged ingest's dirty advance must wake too"

    def test_disable_drains_residue(self):
        cache = small_cache()
        cache.enable_ingest_staging()
        cache.add_pod(port_pod("p3"))
        cache.disable_ingest_staging()
        assert "ns/p3" in cache.pods

    def test_drain_does_not_retrigger_its_own_cycle(self):
        cache = small_cache()
        wakes = []
        cache.set_ingest_signal(lambda: wakes.append(1))
        cache.enable_ingest_staging()
        cache.add_pod(port_pod("d0"))
        staged_wakes = len(wakes)
        assert staged_wakes >= 1
        assert cache.drain_staged_ingest() == 1
        assert len(wakes) == staged_wakes, "the drain's own applies re-woke the trigger"

    def test_no_wake_inside_a_session(self):
        """Dirty advances inside a session are the cycle's own bookkeeping."""
        cache = small_cache()
        wakes = []
        cache.set_ingest_signal(lambda: wakes.append(1))
        cache.begin_exclusive_session()
        cache.dirty.note_job("ns/x")
        assert wakes == []
        cache.end_exclusive_session()

    def test_direct_batch_apply_still_wakes(self):
        cache = small_cache()
        wakes = []
        cache.set_ingest_signal(lambda: wakes.append(1))
        cache.ingest_batch([(cache.add_pod, port_pod("d1"))])
        assert wakes

    def test_staged_batch_stages_whole(self):
        cache = small_cache()
        cache.enable_ingest_staging()
        pods = [port_pod(f"sb{i}") for i in range(3)]
        assert cache.ingest_batch([(cache.add_pod, p) for p in pods]) == 3
        assert not any(f"ns/sb{i}" in cache.pods for i in range(3))
        assert cache.drain_staged_ingest() == 3
        assert all(f"ns/sb{i}" in cache.pods for i in range(3))

    def test_ingest_batch_reports_partial_failure(self):
        cache = small_cache()

        def boom(obj):
            raise ValueError("bad element")

        applied = cache.ingest_batch([(cache.add_pod, port_pod("pf0")), (boom, object())])
        assert applied == 1, "only successful applies count"
        assert "ns/pf0" in cache.pods

    def test_ingest_batch_single_version_advance(self):
        cache = small_cache()
        v0 = cache.dirty.version
        pods = [port_pod(f"b{i}") for i in range(5)]
        assert cache.ingest_batch([(cache.add_pod, p) for p in pods]) == 5
        assert all(f"ns/b{i}" in cache.pods for i in range(5))
        assert cache.dirty.version == v0 + 1, "a batch advances the version once"
        assert len(cache.dirty.pods) >= 5


# --------------------------------------------------------------------------
# the trigger and the adaptive floor
# --------------------------------------------------------------------------


class TestCycleTrigger:
    def test_notify_wakes_as_ingest(self):
        trig = CycleTrigger()
        trig.notify()
        t0 = time.monotonic()
        assert trig.wait_for_work(time.monotonic(), 0.0, 5.0) == "ingest"
        assert time.monotonic() - t0 < 1.0

    def test_idle_wakes_at_the_floor(self):
        trig = CycleTrigger()
        start = time.monotonic()
        assert trig.wait_for_work(start, 0.0, 0.08) == "floor"
        assert time.monotonic() - start >= 0.07

    def test_min_period_coalesces_bursts(self):
        trig = CycleTrigger()
        start = time.monotonic()
        trig.notify()
        assert trig.wait_for_work(start, 0.08, 5.0) == "ingest"
        assert time.monotonic() - start >= 0.07

    def test_poll_consumes_pending(self):
        trig = CycleTrigger()
        trig.notify()
        assert trig.poll() is True
        assert trig.poll() is False

    def test_cross_thread_notify(self):
        trig = CycleTrigger()
        timer = threading.Timer(0.03, trig.notify)
        timer.start()
        try:
            assert trig.wait_for_work(time.monotonic(), 0.0, 5.0) == "ingest"
        finally:
            timer.join(5.0)
        assert not timer.is_alive()

    def test_injected_clock_sets_the_deadline(self):
        """The deadlines read the injected clock: a clock already past the
        idle period wakes at once, without a real wait."""
        class Clock:
            def __init__(self):
                self.now = 100.0

            def monotonic(self):
                return self.now

            def sleep(self, s):
                self.now += s

        clock = Clock()
        trig = CycleTrigger(clock=clock)
        t0 = time.monotonic()
        assert trig.wait_for_work(clock.now - 10.0, 0.5, 5.0) == "floor"
        assert time.monotonic() - t0 < 1.0


class TestAdaptiveMinPeriod:
    def sched(self, monkeypatch, **env):
        monkeypatch.delenv("KB_PERIOD_MIN", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        return Scheduler(small_cache(), conf=CONFS["default"]()[1],
                         schedule_period=1.0, device="cpu")

    def test_adapts_to_measured_cost(self, monkeypatch):
        sched = self.sched(monkeypatch)
        assert not sched.min_period_pinned
        assert sched.min_period == pytest.approx(0.05)
        sched._note_cycle_cost(0.2)
        assert sched.cycle_cost_ewma == pytest.approx(0.2)
        assert sched.min_period == pytest.approx(0.2)
        sched._note_cycle_cost(0.0)
        expect = (1.0 - Scheduler.EWMA_ALPHA) * 0.2
        assert sched.cycle_cost_ewma == pytest.approx(expect)
        assert sched.min_period == pytest.approx(expect)

    def test_floor_and_ceiling_clamps(self, monkeypatch):
        sched = self.sched(monkeypatch)
        for _ in range(50):
            sched._note_cycle_cost(0.0)
        assert sched.min_period == pytest.approx(Scheduler.MIN_PERIOD_FLOOR)
        for _ in range(50):
            sched._note_cycle_cost(100.0)
        assert sched.min_period == pytest.approx(sched.max_period)
        ewma = sched.cycle_cost_ewma
        sched._note_cycle_cost(-1.0)  # clock skew: ignored
        assert sched.cycle_cost_ewma == ewma

    def test_env_pin_restores_static_floor(self, monkeypatch):
        sched = self.sched(monkeypatch, KB_PERIOD_MIN="0.123", KB_PERIOD_MAX="2.5")
        assert sched.min_period_pinned and sched.max_period == pytest.approx(2.5)
        assert sched.min_period == pytest.approx(0.123)
        sched._note_cycle_cost(0.5)
        assert sched.cycle_cost_ewma == pytest.approx(0.5)
        assert sched.min_period == pytest.approx(0.123)

    def test_injected_clock_drives_the_adaptive_floor(self, monkeypatch):
        """The loop measures each cycle on the injected clock: a clock that
        advances 0.2 s per read makes every cycle cost exactly 0.2 s, so
        the EWMA, and the unpinned floor, settle on 0.2."""
        class Clock:
            def __init__(self):
                self.t = 0.0
                self.mu = threading.Lock()

            def monotonic(self):
                with self.mu:
                    self.t += 0.2
                    return self.t

            def sleep(self, s):
                with self.mu:
                    self.t += s

        monkeypatch.delenv("KB_PERIOD_MIN", raising=False)
        sched = Scheduler(small_cache(), conf=CONFS["default"]()[1], schedule_period=1.0,
                          device="cpu", clock=Clock())
        sched.pipelined = True
        loop = threading.Thread(target=sched.run_forever, daemon=True)
        loop.start()
        try:
            time.sleep(0.3)
        finally:
            sched.stop()
            loop.join(timeout=5.0)
        assert not loop.is_alive()
        assert sched.cycle_cost_ewma == pytest.approx(0.2)
        assert sched.min_period == pytest.approx(0.2)

    def test_pipelined_loop_feeds_the_ewma(self, monkeypatch):
        sched = self.sched(monkeypatch)
        sched.pipelined = True
        sched.max_period = 0.01  # tick fast so several cycles run
        loop = threading.Thread(target=sched.run_forever, daemon=True)
        loop.start()
        try:
            time.sleep(0.5)
        finally:
            sched.stop()
            loop.join(timeout=5.0)
        assert not loop.is_alive()
        assert sched.cycle_cost_ewma is not None
        assert sched.min_period < 0.05
        assert sched.wake_reasons["floor"] > 0


# --------------------------------------------------------------------------
# run_forever, pipelined
# --------------------------------------------------------------------------


def burst_events():
    return [("add_pod_group", PodGroup(name="burst", namespace="ns", uid="pg-burst",
                                       min_member=1, queue="q0", creation_index=1)),
            ("add_pod", Pod(name="burst-0", namespace="ns", uid="u-burst",
                            requests={"cpu": 500.0}, phase=PodPhase.PENDING,
                            annotations={GROUP_NAME_ANNOTATION: "burst"},
                            creation_index=2))]


class TestRunForeverPipelined:
    def test_burst_binds_and_shutdown_drains(self):
        """A pod arriving while the loop idles is bound well before the 5 s
        idle period, where the JAX package binds it; stop() drains every
        stage: the staging buffer is empty and the writeback joined."""
        jcache = JaxCache()
        cache = small_cache(n_nodes=6)
        for kind, obj in cluster_events(6, cpu=16000.0) + burst_events():
            getattr(jcache, kind)(obj)
        JaxScheduler(jcache, conf=CONFS["default"]()[0]).run_once()
        sched = Scheduler(cache, conf=CONFS["default"]()[1], schedule_period=5.0,
                          device="cpu")
        sched.pipelined = True
        sched.min_period = 0.0
        sched.max_period = 5.0
        loop = threading.Thread(target=sched.run_forever, daemon=True)
        loop.start()
        try:
            time.sleep(0.2)  # the loop reaches its idle wait
            for kind, obj in burst_events():
                getattr(cache, kind)(mirror(obj))
            assert cache.binder.event.wait(3.0), (
                "the arrival did not trigger a cycle before the idle period")
        finally:
            sched.stop()
            loop.join(timeout=10.0)
        assert not loop.is_alive()
        with cache._ingest_lock:
            assert cache._ingest_staged == [], "shutdown must drain staging"
        assert sched._wb_future is None and sched._wb_worker is None
        assert not cache.ingest_staging and cache._ingest_listener is None
        assert cache.binder.binds == jcache.binder.binds
        assert list(cache.binder.binds) == ["ns/burst-0"]
        assert sched.wake_reasons["ingest"] >= 1

    def test_serial_oracle_knob(self, monkeypatch):
        monkeypatch.setenv("KB_PIPELINE", "0")
        sched = Scheduler(small_cache(), conf=CONFS["default"]()[1], device="cpu")
        assert sched.pipelined is False
        monkeypatch.delenv("KB_PIPELINE")
        sched = Scheduler(small_cache(), conf=CONFS["default"]()[1], device="cpu")
        assert sched.pipelined is True


# --------------------------------------------------------------------------
# the budget shed with the overlapped close; writeback robustness; close
# --------------------------------------------------------------------------


def jax_and_port(seed: int, gangs: int = 1):
    """A JAX cache and a port cache with ``gangs`` churn gangs."""
    jcache, pcache = JaxCache(), small_cache(n_nodes=6)
    churn = Churn(seed)
    events = cluster_events(6, cpu=16000.0)
    for kind, obj in events:
        getattr(jcache, kind)(obj)
    for _ in range(gangs):
        for kind, obj in churn.add_gang():
            getattr(jcache, kind)(obj)
            getattr(pcache, kind)(mirror(obj))
    return jcache, pcache, churn


def port_apply(jcache, pcache, events) -> None:
    for kind, obj in events:
        getattr(jcache, kind)(obj)
        getattr(pcache, kind)(mirror(obj))


def run_actions(ssn, sched) -> None:
    ssn.action_names = [a.name for a in sched.actions]
    for action in sched.actions:
        action.execute(ssn)


class TestBudgetShedOverlappedClose:
    def test_stage_captures_degraded_verdict(self):
        """The degraded verdict is taken at stage time, while the shed flag
        is set: the flush run later sheds its PodGroup writes though the
        flag was reset, on the port as on the JAX package."""
        jcache, pcache, churn = jax_and_port(3)
        jsched = JaxScheduler(jcache, conf=CONFS["default"]()[0])
        psched = Scheduler(pcache, conf=CONFS["default"]()[1], device="cpu")
        jsched.run_once()
        psched.run_once()
        port_apply(jcache, pcache, churn.add_gang())
        outcome = []
        for cache, ssn, sched, close in (
                (jcache, jax_open(jcache, jsched.conf.tiers), jsched, jax_close),
                (pcache, open_session(pcache, psched.conf.tiers, "cpu"), psched,
                 close_session)):
            run_actions(ssn, sched)
            cache.shed_status_writes = True
            try:
                flush = close(ssn, stage_flush=True)
            finally:
                cache.shed_status_writes = False
            wrote_before = len(cache.status_updater.pod_groups)
            cache.run_status_flush(flush)
            cache.flush_binds()
            outcome.append((flush.degraded, len(flush.to_write) > 0,
                            len(cache.status_updater.pod_groups) - wrote_before,
                            dict(cache.binder.binds)))
        assert outcome[1] == outcome[0]
        assert outcome[1][:3] == (True, True, 0)
        pcache.stop()

    def test_statusflush_is_value_snapshotted(self):
        _j, pcache, _c = jax_and_port(9)
        sched = Scheduler(pcache, conf=CONFS["default"]()[1], device="cpu")
        ssn = open_session(pcache, sched.conf.tiers, "cpu")
        run_actions(ssn, sched)
        flush = close_session(ssn, stage_flush=True)
        assert isinstance(flush, StatusFlush) and flush
        assert ssn.staged_flush is flush
        live = {id(j.pod_group) for j in pcache.jobs.values() if j.pod_group is not None}
        assert flush.to_write and all(id(pg) not in live for pg in flush.to_write)
        pcache.run_status_flush(flush)
        pcache.flush_binds()
        pcache.stop()

    def test_cycle_budget_sheds_the_overlapped_flush(self, monkeypatch):
        """KB_CYCLE_BUDGET overrun: the pipelined cycle stages a degraded
        flush, the writeback sheds its PodGroup writes, the binds still go
        out, and the next healthy cycle writes again."""
        monkeypatch.setenv("KB_CYCLE_BUDGET", "0.001")
        _j, pcache, churn = jax_and_port(4, gangs=2)

        class Clock:
            t = 0.0

            def monotonic(self):
                self.t += 1.0  # every read is a second later: over budget
                return self.t

            def sleep(self, s):
                pass

        sched = Scheduler(pcache, conf=CONFS["default"]()[1], device="cpu", clock=Clock())
        try:
            sched.run_once_pipelined()
            sched.drain_pipeline()
            assert pcache.binder.binds and pcache.status_updater.pod_groups == []
            assert not pcache.shed_status_writes
            sched.cycle_budget = 0.0
            for kind, obj in churn.add_gang():
                getattr(pcache, kind)(mirror(obj))
            sched.run_once_pipelined()
            sched.drain_pipeline()
            assert pcache.status_updater.pod_groups
        finally:
            sched.close()
            pcache.stop()


class TestWritebackRobustness:
    def test_failed_cycle_still_flushes_staged_writeback(self):
        """A cycle that dies in an action has already staged its flush and
        recorded its queue deltas as written: the writeback must still run
        them, and the queue statuses equal the JAX package's."""
        jcache, pcache, churn = jax_and_port(7)
        jsched = JaxScheduler(jcache, conf=CONFS["default"]()[0])
        psched = Scheduler(pcache, conf=CONFS["default"]()[1], device="cpu")

        class Boom:
            name = "boom"

            def execute(self, ssn):
                raise RuntimeError("injected action failure")

        try:
            for sched in (jsched, psched):
                sched.run_once_pipelined()
                sched.drain_pipeline()
            port_apply(jcache, pcache, churn.add_gang())
            for sched in (jsched, psched):
                sched.actions = sched.actions + [Boom()]
                try:
                    with pytest.raises(RuntimeError):
                        sched.run_once_pipelined()
                finally:
                    sched.actions = sched.actions[:-1]
                sched.drain_pipeline()
            assert pcache.status_updater.queue_statuses == pcache._queue_status_written
            assert (pcache.status_updater.queue_statuses
                    == jcache.status_updater.queue_statuses)
            assert pcache.binder.binds == jcache.binder.binds
        finally:
            jsched.close()
            psched.close()
            pcache.stop()

    def test_one_failing_podgroup_write_does_not_abort_queue_writes(self):
        jcache, pcache, churn = jax_and_port(13, gangs=2)
        for cache in (jcache, pcache):
            fails = {"n": 1}
            real = cache.status_updater.update_pod_group

            def flaky(pg, fails=fails, real=real):
                if fails["n"]:
                    fails["n"] -= 1
                    raise OSError("transient apiserver error")
                real(pg)

            cache.status_updater.update_pod_group = flaky
            cache.fails = fails
        jsched = JaxScheduler(jcache, conf=CONFS["default"]()[0])
        psched = Scheduler(pcache, conf=CONFS["default"]()[1], device="cpu")
        try:
            for sched in (jsched, psched):
                sched.run_once_pipelined()
                sched.drain_pipeline()
            assert pcache.fails["n"] == 0 == jcache.fails["n"]
            assert pcache.status_updater.queue_statuses == pcache._queue_status_written
            assert (pcache.status_updater.queue_statuses
                    == jcache.status_updater.queue_statuses)
            assert (len(pcache.status_updater.pod_groups)
                    == len(jcache.status_updater.pod_groups))
        finally:
            jsched.close()
            psched.close()
            pcache.stop()

    def test_raising_writeback_is_counted_and_the_next_cycle_recovers(self):
        """A writeback stage that raises is logged and counted, and the
        loop goes on: the next cycle's writeback runs."""
        _j, pcache, churn = jax_and_port(17)
        sched = Scheduler(pcache, conf=CONFS["default"]()[1], device="cpu")
        real = pcache.run_status_flush
        calls = {"n": 0}

        def boom_once(flush):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected writeback failure")
            real(flush)

        pcache.run_status_flush = boom_once
        try:
            sched.run_once_pipelined()
            sched.drain_pipeline()
            assert sched.failed_writebacks == 1
            for kind, obj in churn.add_gang():
                getattr(pcache, kind)(mirror(obj))
            sched.run_once_pipelined()
            sched.drain_pipeline()
            assert sched.failed_writebacks == 1 and calls["n"] == 2
            assert sched.last_writeback_ms is not None
        finally:
            sched.close()
            pcache.stop()


class TestCloseEdgeCases:
    def test_empty_session_close_stages_queue_writes(self):
        """A session with no jobs stages its queue zero-outs instead of
        writing them inline; run, they equal the JAX package's."""
        jcache, pcache, churn = jax_and_port(21)
        jsched = JaxScheduler(jcache, conf=CONFS["default"]()[0])
        psched = Scheduler(pcache, conf=CONFS["default"]()[1], device="cpu")
        try:
            for sched in (jsched, psched):
                sched.run_once_pipelined()
                sched.drain_pipeline()
            port_apply(jcache, pcache, churn.complete_gang(jcache))
            for cache, ssn, sched, close in (
                    (jcache, jax_open(jcache, jsched.conf.tiers), jsched, jax_close),
                    (pcache, open_session(pcache, psched.conf.tiers, "cpu"), psched,
                     close_session)):
                run_actions(ssn, sched)
                before = dict(cache.status_updater.queue_statuses)
                flush = close(ssn, stage_flush=True)
                assert flush is not None, "an empty close must stage, not write"
                assert cache.status_updater.queue_statuses == before
                cache.run_status_flush(flush)
                cache.flush_binds()
            assert pcache.status_updater.queue_statuses == pcache._queue_status_written
            assert (pcache.status_updater.queue_statuses
                    == jcache.status_updater.queue_statuses)
        finally:
            jsched.close()
            psched.close()
            pcache.stop()

    def test_close_failure_after_staging_still_flushes(self):
        """end_exclusive_session raising after the stage must not drop the
        flush: the scheduler recovers it from the session."""
        _j, pcache, churn = jax_and_port(29)
        sched = Scheduler(pcache, conf=CONFS["default"]()[1], device="cpu")
        try:
            sched.run_once_pipelined()
            sched.drain_pipeline()
            for kind, obj in churn.add_gang():
                getattr(pcache, kind)(mirror(obj))
            real_end = pcache.end_exclusive_session
            fired = {"n": 0}

            def flaky_end():
                real_end()
                if fired["n"] == 0:
                    fired["n"] = 1
                    raise RuntimeError("injected close failure")

            pcache.end_exclusive_session = flaky_end
            try:
                with pytest.raises(RuntimeError):
                    sched.run_once_pipelined()
            finally:
                pcache.end_exclusive_session = real_end
            sched.drain_pipeline()
            assert fired["n"] == 1
            assert pcache.status_updater.queue_statuses == pcache._queue_status_written
        finally:
            sched.close()
            pcache.stop()


# --------------------------------------------------------------------------
# the in-flight bind guard
# --------------------------------------------------------------------------


class TestInflightBindGuard:
    def test_update_pod_keeps_unacked_dispatch(self):
        cache = small_cache()
        cache.add_pod(port_pod("w0"))
        cache._inflight_bind_hosts["ns/w0"] = "n0"
        cache.update_pod(port_pod("w0"))
        assert cache.pods["ns/w0"].node_name == "n0", (
            "an unacked bind was clobbered by a stale client update")

    def test_failed_dispatch_rolls_back_optimistic_stamp(self):
        cache = small_cache()
        pod = port_pod("w1")
        cache.add_pod(pod)
        cache._inflight_bind_hosts["ns/w1"] = "n0"
        cache.update_pod(port_pod("w1"))  # copies the in-flight placement
        assert cache.pods["ns/w1"].node_name == "n0"
        version = cache.dirty.version
        cache._settle_inflight([("ns/w1", pod, "n0")], bound=False)
        assert cache.pods["ns/w1"].node_name is None
        assert "ns/w1" not in cache._inflight_bind_hosts
        assert cache.dirty.version > version and "ns/w1" in cache.dirty.pods

    def test_settle_after_delete_touches_nothing(self):
        cache = small_cache()
        pod = port_pod("w2")
        cache.add_pod(pod)
        cache._inflight_bind_hosts["ns/w2"] = "n0"
        cache.delete_pod(pod)
        assert "ns/w2" not in cache._inflight_bind_hosts
        cache._settle_inflight([("ns/w2", pod, "n0")], bound=False)
        assert "ns/w2" not in cache.pods

    def test_deferred_update_keeps_the_pipelined_binding(self):
        """A client update deferred past a pipelined cycle (the close leaves
        the bind drain to the writeback) keeps the dispatched placement,
        and the next cycle does not bind the pod again."""
        cache = small_cache()
        sched = Scheduler(cache, conf=CONFS["default"]()[1], device="cpu")
        group = {GROUP_NAME_ANNOTATION: "w3"}
        cache.add_pod_group(mirror(PodGroup(name="w3", namespace="ns", min_member=1,
                                            queue="q0")))
        cache.add_pod(port_pod("w3", annotations=group))
        gate = threading.Event()
        real_bind_many = cache.binder.bind_many

        def slow_bind_many(pairs):
            assert gate.wait(5.0)
            real_bind_many(pairs)

        cache.binder.bind_many = slow_bind_many
        real_end = cache.end_exclusive_session

        def end_with_update():
            # the update was deferred while the session owned the cache
            cache._deferred.append((cache.update_pod,
                                    (port_pod("w3", annotations=group),)))
            real_end()

        cache.end_exclusive_session = end_with_update
        try:
            sched.run_once_pipelined()
            cache.end_exclusive_session = real_end
            assert cache.pods["ns/w3"].node_name == "n0"
            gate.set()
            sched.drain_pipeline()
            sched.run_once_pipelined()
            sched.drain_pipeline()
            assert cache.binder.channel == ["ns/w3"]
            task = cache.jobs["ns/w3"].tasks["ns/w3"]
            assert task.status == TaskStatus.BOUND
            assert task.node_name == "n0"
            assert cache.columns.check_consistency(cache) == []
        finally:
            gate.set()
            cache.end_exclusive_session = real_end
            sched.close()
            cache.stop()


def test_concurrent_ingest_stress():
    """Eight feeder threads ingest gangs (staged and batched) while the
    cycle thread runs pipelined cycles, with the interpreter switching
    threads every 10 µs: no staged event is lost or applied twice, every
    pod is bound exactly once, and the cache stays consistent."""
    import sys

    cache = small_cache(n_nodes=6)
    sched = Scheduler(cache, conf=CONFS["default"]()[1], device="cpu")
    cache.enable_ingest_staging()
    per_thread, n_threads = 12, 8
    errors = []

    def feed(t: int):
        try:
            for i in range(per_thread):
                name = f"s{t}-{i}"
                pg = mirror(PodGroup(name=name, namespace="st", min_member=1,
                                     queue=f"q{i % 2}", creation_index=t * 1000 + i))
                pod = mirror(Pod(name=f"{name}-0", namespace="st",
                                 requests={"cpu": 10.0, "memory": GiB},
                                 annotations={GROUP_NAME_ANNOTATION: name},
                                 phase=PodPhase.PENDING, creation_index=t * 1000 + i))
                if i % 2:
                    cache.ingest_batch([(cache.add_pod_group, pg), (cache.add_pod, pod)])
                else:
                    cache.add_pod_group(pg)
                    cache.add_pod(pod)
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            errors.append(e)

    switch = sys.getswitchinterval()
    feeders = [threading.Thread(target=feed, args=(t,), daemon=True)
               for t in range(n_threads)]
    sys.setswitchinterval(1e-5)
    try:
        for f in feeders:
            f.start()
        deadline = time.monotonic() + 60.0
        while any(f.is_alive() for f in feeders) and time.monotonic() < deadline:
            sched.run_once_pipelined()
        for f in feeders:
            f.join(10.0)
        assert not any(f.is_alive() for f in feeders) and errors == []
        for _ in range(2):  # what the last cycle did not see
            sched.run_once_pipelined()
        sched.drain_pipeline()
    finally:
        sys.setswitchinterval(switch)
        sched.close()
        cache.stop()
    keys = {f"st/s{t}-{i}-0" for t in range(n_threads) for i in range(per_thread)}
    assert keys <= set(cache.pods)
    channel = [k for k in cache.binder.channel if k.startswith("st/")]
    assert sorted(channel) == sorted(keys), "a pod was lost or bound twice"
    assert cache.columns.check_consistency(cache) == []
    assert cache.dispatch_failures == 0 and sched.failed_writebacks == 0


# --------------------------------------------------------------------------
# the chip drives, small on the CPU
# --------------------------------------------------------------------------


def test_pipelined_steady_leg_on_the_cpu():
    """chip_smoke's pipelined steady leg, small: every cycle's digest equals
    the defaults leg's, every swap equals a fresh upload, and each cycle
    reports its barrier, join and writeback."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_steady

    kw = dict(n_tasks=1024, n_nodes=128, cycles=3, device="cpu", check_swaps=True)
    base = drive_steady(**kw)
    pipe = drive_steady(**kw, leg="pipelined")
    assert [c["digest"] for c in pipe["cycles"]] == [c["digest"] for c in base["cycles"]]
    assert all(c["swaps_checked"] == c["swaps"] for c in pipe["cycles"])
    assert all(c["overlap"] is None for c in base["cycles"])
    for c in pipe["cycles"]:
        ov = c["overlap"]
        assert ov["writeback_ms"] is not None and ov["writeback_ms"] >= 0.0
        assert ov["wall_plus_join_ms"] == pytest.approx(c["wall_ms"] + ov["join_ms"])
        assert "writeback_barrier" in c["stages_ms"]
    assert pipe["steady"]["wall_plus_join_ms_p50"] > 0.0
    assert all(c["period_ms"] >= c["wall_ms"] for c in pipe["cycles"] + base["cycles"])


def test_loop_drive_on_the_cpu():
    """chip_smoke's loop phase, small: both loops bind every arrival once,
    and stop() drains; the serial loop wakes on its tick, the pipelined one
    on arrivals."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_loop

    r = drive_loop(512, 64, feed=4, period=1.0, device="cpu")
    for mode in ("serial", "pipelined"):
        m = r[mode]
        assert m["bound"] == 4 and m["staged_left"] == 0 and m["writeback_joined"]
        assert m["cycles"] > 0
    assert r["pipelined"]["wakes"]["ingest"] > 0
    assert r["serial"]["wakes"] == {"tick": r["serial"]["cycles"]}


def test_drain_pipeline_leaves_the_cycles_record_on_the_stream():
    """The replication encode overlaps the next cycle like the writeback
    stage; ``drain_pipeline`` joins it, so the drained cycle's record is on
    the stream: ``record_for(head - 1)`` returns it."""
    from kube_batch_tpu_torch.replicate import stream
    from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher
    from kube_batch_tpu_torch.serve.plane import QueryPlane
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    cache = synthetic_cluster(64, 8)
    qp = QueryPlane(cache, start_thread=False)
    cache.replication = pub = ReplicationPublisher()
    sched = Scheduler(cache, device="cpu")
    release = threading.Event()
    encode = pub._encode_locked

    def held(*a):
        release.wait(30)
        return encode(*a)

    pub._encode_locked = held
    try:
        for cycle in (1, 2):
            if cycle == 2:
                cache.add_pod(port_pod("late"))
            sched.run_once_pipelined()
            assert pub._pending is not None  # the encode is still in flight
            seq = pub._next_seq
            release.set()
            sched.drain_pipeline()
            release.clear()
            assert pub._pending is None and pub.counters()["head_seq"] == seq
            rec = stream.decode_record(pub.record_for(seq - 1))
            assert rec.seq == seq
            assert rec.kind == (stream.FULL if cycle == 1 else stream.DELTA)
            assert qp.broker.current().seq == seq
    finally:
        release.set()
        sched.close()
        pub.close()
        qp.close()
        cache.stop()
