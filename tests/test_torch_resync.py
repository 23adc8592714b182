"""The port's repair path, status shedding, crashed-cycle recovery and conf
hot-reload against the JAX package's.

Each case is one of the JAX package's own (``tests/test_cache.py``
``TestResyncRepair``, ``TestResyncBackoffAndQuarantine``,
``TestDegradedStatusShedding``, the crashed cycle of
``TestExclusiveSessionSafety``; ``tests/test_conf.py``
``TestConfHotReload``), driven on a JAX cache and a port cache built from
the same events, with the same failures injected into both: the repair
backlog, the quarantine, the written conditions, the task states and the
parks by reason must be equal after every step.  The crashed cycle is
compared over the two cycles that follow its pod-store rebuild, on a
cluster whose capacities are reserved so that the resident snapshot, the
compacted solve and the warm carry engage: the port's next open is full,
every swap equals a fresh upload, and both packages bind alike.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np
import pytest

from kube_batch_tpu.api.pod import PodGroup, Queue
from kube_batch_tpu.api.types import PodPhase, queue_phase_counts
from kube_batch_tpu.cache.resync import ResyncQueue as JaxResyncQueue
from kube_batch_tpu.framework.conf import parse_scheduler_conf as jax_parse_conf
from kube_batch_tpu.framework.interface import Action as JaxAction
from kube_batch_tpu.framework.interface import register_action as jax_register_action
from kube_batch_tpu.k8s.transport import CircuitOpenError as JaxCircuitOpenError
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.cache.resync import ResyncQueue
from kube_batch_tpu_torch.framework.conf import parse_scheduler_conf, shipped_conf_path
from kube_batch_tpu_torch.framework.interface import register_action
from kube_batch_tpu_torch.k8s.transport import CircuitOpenError
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing.cycle_drive import SwapCheck
from fixtures import GiB, build_node, build_pod
from test_torch_cycle import _assert_same, _from_events, apply, kubelet, observed
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


class Exploding:
    """A binder whose every call fails with ``error``."""

    def __init__(self, error):
        self.error = error
        self.calls = 0

    def bind(self, pod, hostname):
        self.calls += 1
        raise self.error("apiserver down")


class ExplodingBatch(Exploding):
    """A binder with the batch path; both paths fail with ``error``."""

    def bind_many(self, pairs):
        self.calls += 1
        raise self.error("apiserver down")


def failing_pair(binder=Exploding, errors=(RuntimeError, RuntimeError)):
    """A JAX cache and a port cache holding one pending pod ``ns/p1`` on one
    node, each with a binder that fails (test_cache.py ``_failing_cache``)."""
    jcache, pcache = _from_events([
        ("add_queue", Queue(name="default")),
        ("add_node", build_node("n1")),
        ("add_pod", build_pod("ns", "p1", None, PodPhase.PENDING,
                              {"cpu": 1000, "memory": GiB}))])
    jcache.binder, pcache.binder = binder(errors[0]), binder(errors[1])
    return jcache, pcache


def task_of(cache):
    return next(iter(cache.jobs["ns/p1"].tasks.values()))


def repair_state(cache) -> dict:
    """What the repair path decided: the backlog, the quarantine, parks by
    reason, the written conditions and the task's state."""
    jobs = {uid: {k: (int(t.status), t.node_name) for k, t in j.tasks.items()}
            for uid, j in cache.jobs.items()}
    return {"backlog": sorted(t.key() for t in cache.err_tasks),
            "quarantined": sorted(cache.resync.quarantined),
            "parked": dict(cache.resync.parked_by_reason),
            "released": cache.resync.released_total,
            "conditions": {k: c["message"] for k, c in cache.pod_conditions.items()},
            "tasks": jobs}


def both(jcache, pcache, fn) -> None:
    """``fn(cache)`` on each side, then the repair states must be equal."""
    fn(jcache)
    fn(pcache)
    assert repair_state(pcache) == repair_state(jcache)


# --------------------------------------------------------------------------
# the resync queue (test_cache.py TestResyncRepair, TestResyncBackoffAndQuarantine)
# --------------------------------------------------------------------------


def test_failed_bind_resyncs_task():
    """A binder failure queues the task; the repair pass restores it to
    its pre-bind state from the pod store (cache.go:478-484, 559-581)."""
    jcache, pcache = failing_pair()
    both(jcache, pcache, lambda c: c.bind(task_of(c), "n1"))
    assert [t.key() for t in pcache.err_tasks] == ["ns/p1"]
    both(jcache, pcache, lambda c: c.process_resync_tasks())
    assert pcache.err_tasks == []
    task = task_of(pcache)
    assert int(task.status) == 0 and task.node_name is None  # Pending again


def test_repeat_failures_escalate_backoff():
    jcache, pcache = failing_pair()
    both(jcache, pcache, lambda c: c.bind(task_of(c), "n1"))   # attempt 1 parks
    both(jcache, pcache, lambda c: c.process_resync_tasks())   # tick 1: due
    assert pcache.err_tasks == []
    both(jcache, pcache, lambda c: c.bind(task_of(c), "n1"))   # attempt 2: delay 2
    both(jcache, pcache, lambda c: c.process_resync_tasks())   # tick 2: not yet due
    assert len(pcache.err_tasks) == 1
    both(jcache, pcache, lambda c: c.process_resync_tasks())   # tick 3: due
    assert pcache.err_tasks == []


def test_poison_task_quarantined_with_condition():
    jcache, pcache = failing_pair()
    for cache in (jcache, pcache):
        cache.resync.poison_after = 3
        cache.resync.backoff_cap = 1
    for _ in range(3):
        both(jcache, pcache, lambda c: c.bind(task_of(c), "n1"))
        both(jcache, pcache, lambda c: c.process_resync_tasks())
    # the 3rd real failure used up the budget: one more pass shelves it
    both(jcache, pcache, lambda c: c.process_resync_tasks())
    assert "ns/p1" in pcache.resync.quarantined and pcache.err_tasks == []
    cond = pcache.pod_conditions["ns/p1"]
    assert cond["status"] == "False" and "quarantined" in cond["message"]
    assert pcache.status_updater.pod_conditions[-1] == ("ns/p1", cond)
    # a stray late failure re-parks nothing: still shelved
    both(jcache, pcache, lambda c: c.resync_task(task_of(c)))
    both(jcache, pcache, lambda c: c.process_resync_tasks())
    assert "ns/p1" in pcache.resync.quarantined


def test_external_pod_update_releases_quarantine():
    jcache, pcache = failing_pair()
    for cache in (jcache, pcache):
        cache.resync.poison_after = 1
    both(jcache, pcache, lambda c: c.bind(task_of(c), "n1"))
    both(jcache, pcache, lambda c: c.process_resync_tasks())
    assert "ns/p1" in pcache.resync.quarantined
    # the user edits the pod: the quarantine releases, the history resets
    both(jcache, pcache, lambda c: c.update_pod(dataclasses.replace(c.pods["ns/p1"])))
    assert "ns/p1" not in pcache.resync.quarantined
    assert pcache.resync.released_total == 1


def test_pod_deletion_forgets_all_bookkeeping():
    jcache, pcache = failing_pair()
    both(jcache, pcache, lambda c: c.bind(task_of(c), "n1"))
    assert len(pcache.err_tasks) == 1
    both(jcache, pcache, lambda c: c.delete_pod(c.pods["ns/p1"]))
    assert pcache.err_tasks == []
    both(jcache, pcache, lambda c: c.process_resync_tasks())  # nothing resurrects
    assert "ns/p1" not in pcache.jobs


def test_breaker_parks_never_poison():
    jcache, pcache = failing_pair()
    for cache in (jcache, pcache):
        cache.resync.poison_after = 2
    for _ in range(10):
        both(jcache, pcache, lambda c: c.resync_task(task_of(c), reason="breaker-open"))
        both(jcache, pcache, lambda c: c.process_resync_tasks())
    for _ in range(pcache.resync.backoff_cap + 1):
        both(jcache, pcache, lambda c: c.process_resync_tasks())
    assert pcache.resync.quarantined == {}
    assert pcache.resync.parked_by_reason["breaker-open"] == 10


@pytest.mark.parametrize("binder", [Exploding, ExplodingBatch], ids=["bind", "bind_many"])
@pytest.mark.parametrize("error", ["breaker", "error"])
def test_async_dispatch_failure_parks(binder, error):
    """A cycle's batch (``bulk_bind``) that the binder refuses: a breaker
    refusal parks every task as ``breaker-open`` without a per-pod call
    after ``bind_many``, any other failure retries pod by pod and parks
    each failed pod as ``error``; the in-flight markers clear and the
    repair pass re-derives the pods as Pending."""
    errors = ((JaxCircuitOpenError, CircuitOpenError) if error == "breaker"
              else (RuntimeError, RuntimeError))
    jcache, pcache = failing_pair(binder, errors)
    for cache in (jcache, pcache):
        cache.add_pod(type(cache.pods["ns/p1"])(
            name="p2", namespace="ns", requests={"cpu": 1000.0, "memory": GiB},
            phase=cache.pods["ns/p1"].phase))
    keys = ["ns/p1", "ns/p2"]

    def dispatch(cache):
        tasks = [cache.jobs[k].tasks[k] for k in keys]
        cache.bulk_bind([(t, "n1") for t in tasks])
        cache.flush_binds()

    both(jcache, pcache, dispatch)
    assert sorted(t.key() for t in pcache.err_tasks) == keys
    assert pcache._inflight_bind_hosts == {}
    assert pcache.binder.calls == jcache.binder.calls
    reason = "breaker-open" if error == "breaker" else "error"
    assert pcache.resync.parked_by_reason == {reason: 2}
    both(jcache, pcache, lambda c: c.process_resync_tasks())
    assert pcache.err_tasks == []
    pcache.stop()


def test_dispatch_failure_is_counted_not_lost():
    """A dispatched batch whose worker call raises past its own handlers is
    logged and counted whether the next dispatch or the join reads it, and
    the join itself does not raise (a serial close must still release the
    cache's gate)."""
    from kube_batch_tpu_torch.cache.fake import FakeBinder

    _j, pcache = failing_pair()
    pcache.binder = FakeBinder()

    def broken_settle(entries, bound):
        raise RuntimeError("injected settle failure")

    pcache._settle_inflight = broken_settle
    task = task_of(pcache)
    pcache.bulk_bind([(task, "n1")])
    pcache.bulk_bind([(task, "n1")])  # its dispatch may read the first's failure
    pcache.flush_binds()
    assert pcache.dispatch_failures == 2
    assert pcache.binder.channel == ["ns/p1", "ns/p1"]
    pcache.stop()


def test_background_repair_loop_drains_and_stops():
    """``run()`` starts the repair thread (cache.go:342-384): it drains the
    resync queue and collects terminated jobs without a cycle, and
    ``stop()`` joins it.  The sync barrier reads the explicit signal."""
    jcache, pcache = failing_pair()
    both(jcache, pcache, lambda c: c.bind(task_of(c), "n1"))
    assert not pcache.wait_for_cache_sync()
    assert not pcache.wait_for_cache_sync(timeout=0.01)
    pcache.mark_synced()
    assert pcache.wait_for_cache_sync(timeout=0.01)
    pcache.run(resync_period=0.01)
    thread = pcache._repair_thread
    try:
        deadline = time.monotonic() + 10.0
        while pcache.err_tasks and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pcache.err_tasks == []
        assert int(task_of(pcache).status) == 0  # Pending again
    finally:
        pcache.stop()
    assert not thread.is_alive() and pcache._repair_thread is None


def test_overflow_forces_oldest_due_instead_of_dropping():
    class T:
        def __init__(self, k):
            self._k = k

        def key(self):
            return self._k

    results = []
    for cls in (JaxResyncQueue, ResyncQueue):
        q = cls(backoff_cap=64, poison_after=99, max_entries=4)
        for i in range(8):
            t = T(f"t{i}")
            q.park(t)
            q.park(t)  # the second park is due far in the future
        assert len(q) == 8
        due, poisoned = q.tick()
        results.append(([t.key() for t in due], poisoned, len(q), q.stats()))
    assert results[1] == results[0]
    due, poisoned, depth, _stats = results[1]
    assert poisoned == [] and due == ["t0", "t1", "t2", "t3"] and depth == 4


def test_resync_knobs_read_from_the_environment(monkeypatch):
    monkeypatch.setenv("KB_RESYNC_BACKOFF_CAP", "3")
    monkeypatch.setenv("KB_RESYNC_POISON", "7")
    monkeypatch.setenv("KB_RESYNC_MAX", "11")
    q = SchedulerCache().resync
    assert (q.backoff_cap, q.poison_after, q.max_entries) == (3, 7, 11)


# --------------------------------------------------------------------------
# degraded status shedding (test_cache.py TestDegradedStatusShedding)
# --------------------------------------------------------------------------


def test_shed_flag_skips_serial_status_writes():
    outcome = []
    jcache, pcache = _from_events([
        ("add_queue", Queue(name="default")),
        ("add_pod_group", PodGroup(name="pg", namespace="ns", queue="default"))])
    for cache in (jcache, pcache):
        writes = []

        class Updater:
            def update_pod_group(self, pg):
                writes.append(pg.name)

        cache.status_updater = Updater()
        job = cache.jobs["ns/pg"]
        cache.shed_status_writes = True
        cache.update_job_statuses_bulk([(job, True, False)])
        shed = list(writes)              # shed (not parallel-safe: skipped)
        cache.shed_status_writes = False
        cache._status_next_write.clear()
        cache.update_job_statuses_bulk([(job, True, False)])
        outcome.append((shed, list(writes)))
    assert outcome[1] == outcome[0] == ([], ["pg"])


def test_updater_degraded_probe_sheds_queue_status():
    outcome = []
    jcache, pcache = _from_events([("add_queue", Queue(name="default"))])
    for cache in (jcache, pcache):
        wrote = []

        class Updater:
            degraded_now = True

            def update_pod_group(self, pg):
                pass

            def update_queue_status(self, name, counts):
                wrote.append(name)

            def degraded(self):
                return self.degraded_now

        cache.status_updater = Updater()
        counts = {"default": queue_phase_counts()}
        counts["default"]["pending"] = 1
        cache.update_queue_statuses(counts)
        shed = list(wrote)               # breaker open: shed
        Updater.degraded_now = False
        cache.update_queue_statuses(counts)
        outcome.append((shed, list(wrote)))
    assert outcome[1] == outcome[0] == ([], ["default"])


# --------------------------------------------------------------------------
# a crashed cycle recovers through the pod-store rebuild
# --------------------------------------------------------------------------


class _JaxExplode(JaxAction):
    name = "explode-port-test"
    armed = [0]

    def execute(self, ssn):
        if self.armed[0] > 0:
            self.armed[0] -= 1
            raise RuntimeError("mid-cycle crash")


class _PortExplode:
    name = "explode-port-test"
    armed = [0]

    def execute(self, ssn):
        if self.armed[0] > 0:
            self.armed[0] -= 1
            raise RuntimeError("mid-cycle crash")


jax_register_action(_JaxExplode())
register_action("explode-port-test", _PortExplode)


def _explode_conf(parse):
    """The shipped conf with the exploding action after allocate."""
    with open(shipped_conf_path()) as f:
        text = f.read()
    return parse(text.replace("allocate, backfill",
                              "allocate, explode-port-test, backfill"))


def _crash_pair():
    jcache, pcache = _from_events([("add_queue", Queue(name=q, weight=1 + i))
                                   for i, q in enumerate(("q0", "q1"))]
                                  + [("add_node", build_node(f"n{i}", cpu=8000, mem=32 * GiB))
                                     for i in range(6)])
    for cache in (jcache, pcache):
        cache.columns.reserve(n_tasks=1024, n_nodes=64)
    rng = np.random.default_rng(3)
    events = []
    for g in range(8):
        n = int(rng.integers(2, 5))
        events.append(("add_pod_group", PodGroup(name=f"g{g}", namespace="ns",
                                                 queue=f"q{g % 2}", min_member=n)))
        events += [("add_pod", build_pod("ns", f"g{g}-{i}", None, PodPhase.PENDING,
                                         {"cpu": float(rng.choice([500, 1000, 2000])),
                                          "memory": GiB}, group_name=f"g{g}"))
                   for i in range(n)]
    apply(jcache, pcache, events)
    return jcache, pcache


def test_crashed_cycle_recovers_via_pod_store_rebuild():
    """A cycle that dies after allocate dispatched its binds: both
    packages rebuild from the pod store (the acked binds survive, the rest
    is Pending again, no phantom allocation), and the two cycles after it
    decide alike.  The port's first open after the rebuild is full and its
    swaps equal fresh uploads."""
    jcache, pcache = _crash_pair()
    jsched = JaxScheduler(jcache, conf=_explode_conf(jax_parse_conf))
    psched = Scheduler(pcache, conf=_explode_conf(parse_scheduler_conf), device="cpu")
    check = SwapCheck()
    pcache.columns.on_swap = check.on_swap
    rng = np.random.default_rng(5)
    try:
        jsched.run_once()
        psched.run_once()
        _assert_same(observed(jcache), observed(pcache), "before the crash")
        apply(jcache, pcache, kubelet(jcache, rng, 0))
        _JaxExplode.armed[0] = _PortExplode.armed[0] = 1
        for sched in (jsched, psched):
            with pytest.raises(RuntimeError, match="mid-cycle crash"):
                sched.run_once()
            sched._recover_failed_cycle()
        _assert_same(observed(jcache), observed(pcache), "after the rebuild")
        assert pcache.columns.check_consistency(pcache) == []
        for node in pcache.nodes.values():
            used = sum(t.resreq.vec for t in node.tasks.values())
            np.testing.assert_allclose(node.used.vec, used if node.tasks else 0.0)
        for cycle in range(2):
            jsched.run_once()
            psched.run_once()
            if cycle == 0:
                assert pcache.last_open_path == "full"
            _assert_same(observed(jcache), observed(pcache), f"cycle {cycle} after")
            assert pcache.columns.check_consistency(pcache) == []
            apply(jcache, pcache, kubelet(jcache, rng, cycle + 1))
        assert check.verify("after the rebuild") == check.swaps > 0
    finally:
        _JaxExplode.armed[0] = _PortExplode.armed[0] = 0
        pcache.columns.on_swap = None


@pytest.mark.parametrize("pipelined", [False, True], ids=["serial", "pipelined"])
def test_run_forever_recovers_a_crashed_cycle(pipelined, monkeypatch):
    """test_cache.py's crashed-cycle drive on the port's loop: two cycles
    die after allocate; run_forever rebuilds from the pod store each time,
    and every pod ends up bound once with its node charged once."""
    monkeypatch.setenv("KB_PIPELINE", "1" if pipelined else "0")
    cache = SchedulerCache()
    apply_port(cache, [("add_queue", Queue(name="default")), ("add_node", build_node("n1"))]
               + [("add_pod", build_pod("c1", f"p{i}", None, PodPhase.PENDING,
                                        {"cpu": 1000, "memory": GiB})) for i in range(3)])
    conf = parse_scheduler_conf('actions: "allocate, explode-port-test"\n'
                                "tiers:\n- plugins:\n  - name: gang\n  - name: drf\n")
    sched = Scheduler(cache, conf=conf, schedule_period=0.05, device="cpu")
    assert sched.pipelined is pipelined
    sched.min_period = 0.0
    _PortExplode.armed[0] = 2
    loop = threading.Thread(target=sched.run_forever, daemon=True)
    try:
        loop.start()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and (len(cache.binder.binds) < 3
                                                 or _PortExplode.armed[0] > 0
                                                 or sched.failed_cycles < 2):
            cache.binder.event.wait(0.05)
    finally:
        sched.stop()
        loop.join(5.0)
        _PortExplode.armed[0] = 0
        sched.close()
        cache.stop()
    assert not loop.is_alive()
    assert len(cache.binder.binds) == 3 and sched.failed_cycles == 2
    assert len(cache.binder.channel) == 3
    node = cache.nodes["n1"]
    assert node.used.vec[0] == 3000  # cpu
    assert node.idle.vec[0] == node.allocatable.vec[0] - 3000
    assert cache.columns.check_consistency(cache) == []


def apply_port(cache, events) -> None:
    from test_torch_cycle import mirror

    for kind, obj in events:
        getattr(cache, kind)(mirror(obj))


# --------------------------------------------------------------------------
# conf hot-reload (test_conf.py TestConfHotReload)
# --------------------------------------------------------------------------


def _write(path, actions):
    path.write_text(f'actions: "{actions}"\ntiers:\n- plugins:\n  - name: gang\n')


def _step_mtime(path):
    os.utime(path, (time.time() + 2, time.time() + 2))


def _schedulers(conf_path):
    from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache

    return (JaxScheduler(JaxCache(), conf_path=str(conf_path)),
            Scheduler(SchedulerCache(), conf_path=str(conf_path), device="cpu"))


def test_valid_edit_swaps_in(tmp_path):
    conf = tmp_path / "conf.yaml"
    _write(conf, "allocate")
    scheds = _schedulers(conf)
    for s in scheds:
        assert s.conf.actions == ["allocate"]
        s.run_once()
    _write(conf, "allocate, backfill")
    _step_mtime(conf)
    for s in scheds:
        s.run_once()
        assert s.conf.actions == ["allocate", "backfill"]
        assert [a.name for a in s.actions] == ["allocate", "backfill"]


@pytest.mark.parametrize("edit", [
    'actions: "no-such-action"\n',
    'actions: "allocate"\ntiers:\n- plugins:\n  - name: gangg\n',
], ids=["unknown-action", "unknown-plugin"])
def test_broken_edit_keeps_running_conf(tmp_path, edit):
    conf = tmp_path / "conf.yaml"
    _write(conf, "allocate")
    scheds = _schedulers(conf)
    for s in scheds:
        s.run_once()
    conf.write_text(edit)
    _step_mtime(conf)
    for s in scheds:
        s.run_once()  # must not raise
        assert s.conf.actions == ["allocate"]
        assert s.conf.tiers[0].plugins[0].name == "gang"
        s.run_once()  # still scheduling with the running conf


def test_explicit_conf_object_never_reloads():
    from kube_batch_tpu_torch.framework.conf import load_scheduler_conf

    sched = Scheduler(SchedulerCache(), conf=load_scheduler_conf(None), device="cpu")
    assert sched._conf_path is None
    sched.run_once()  # no file to watch: the reload is a no-op
