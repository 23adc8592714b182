"""The port's failover and restart paths against the JAX package's, on the
CPU: the file-lock ``LeaderElector`` (single leader, handover, re-arm),
``run_warm_standby``'s re-contend loop, ``SchedulerCache.failover_recover``
over the leader's ``ColumnStore.revalidate_resident`` (the report equal to
the JAX package's on the same churned cluster; warm keeps the resident
cache object and costs no more full uploads than a steady cycle; an
unsynced or inconsistent cache cold-starts), the crash-recovery drive of
``tests/test_failover.py`` (save, load in a fresh cache,
``failover_recover``, the next cycle decided as the uninterrupted run and
as the JAX package decides it, no acked bind back to Pending), and state
files across packages in both directions."""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
from kube_batch_tpu.api.pod import GROUP_NAME_ANNOTATION, Node, Pod, PodGroup, Queue
from kube_batch_tpu.api.types import PodPhase
from kube_batch_tpu_torch import actions as _port_actions  # noqa: F401 — registers
from kube_batch_tpu_torch import plugins as _port_plugins  # noqa: F401 — registers
from kube_batch_tpu_torch.api.resident import PER_CYCLE_FIELDS
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.cmd.leader_election import LeaderElector, LostLeadership
from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
from kube_batch_tpu_torch.framework.interface import get_action
from kube_batch_tpu_torch.framework.session import close_session, open_session
from kube_batch_tpu_torch.scheduler import Scheduler
from fixtures import GiB
from test_torch_cycle import mirror
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

CPU = torch.device("cpu")
RESERVE = dict(n_tasks=2048, n_nodes=128, n_jobs=512)


# --------------------------------------------------------------------------
# both packages fed the same events
# --------------------------------------------------------------------------


def _jax():
    from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
    from kube_batch_tpu.cache.persistence import load_state, save_state
    from kube_batch_tpu.framework.conf import load_scheduler_conf as jconf
    from kube_batch_tpu.framework.conf import shipped_conf_path as jshipped
    from kube_batch_tpu.framework.interface import get_action as jget
    from kube_batch_tpu.framework.session import close_session as jclose
    from kube_batch_tpu.framework.session import open_session as jopen

    return dict(cache=JaxCache, load=load_state, save=save_state, conf=jconf,
                shipped=jshipped, get=jget, open=jopen, close=jclose)


def _port():
    from kube_batch_tpu_torch.cache.persistence import load_state, save_state

    return dict(cache=SchedulerCache, load=load_state, save=save_state,
                conf=load_scheduler_conf, shipped=shipped_conf_path, get=get_action,
                open=lambda cache, tiers: open_session(cache, tiers, "cpu"),
                close=close_session)


PKGS = {"jax": _jax, "port": _port}


def _base_events(n_nodes=6):
    ev = [("add_queue", Queue(name=f"q{q}", uid=f"uq{q}", weight=q + 1)) for q in range(2)]
    ev += [("add_node", Node(name=f"n{i}", allocatable={
        "cpu": 16000.0, "memory": 64 * GiB, "pods": 110.0})) for i in range(n_nodes)]
    return ev


def _gang_events(serial, size=2, cpu=500.0):
    g = f"g{serial}"
    ev = [("add_pod_group", PodGroup(name=g, namespace="fo", uid=f"pg-{g}", min_member=size,
                                     queue=f"q{serial % 2}", creation_index=serial))]
    ev += [("add_pod", Pod(name=f"{g}-{k}", namespace="fo", uid=f"pod-{g}-{k}",
                           requests={"cpu": cpu, "memory": 1 * GiB},
                           annotations={GROUP_NAME_ANNOTATION: g},
                           phase=PodPhase.PENDING, creation_index=serial * 100 + k))
           for k in range(size)]
    return ev


class Side:
    """One package's cache with the conf it runs and its persistence."""

    def __init__(self, pkg: str, conf: str = "default", reserve=True):
        self.pkg = pkg
        self.m = PKGS[pkg]()
        self.cache = self.m["cache"]()
        if reserve:
            self.cache.columns.reserve(**RESERVE)
        self.conf = self.m["conf"](self.m["shipped"]() if conf == "shipped" else None)

    def apply(self, events):
        for kind, obj in events:
            getattr(self.cache, kind)(obj if self.pkg == "jax" else mirror(obj))

    def cycle(self, flush=True):
        ssn = self.m["open"](self.cache, self.conf.tiers)
        ssn.action_names = list(self.conf.actions)
        try:
            for name in self.conf.actions:
                self.m["get"](name).execute(ssn)
        finally:
            self.m["close"](ssn)
        if flush:
            self.cache.flush_binds()

    def set_running(self, key):
        pod = self.cache.pods.get(key)
        if pod is not None and pod.node_name and pod.phase.value == "Pending":
            self.cache.update_pod(dataclasses.replace(pod, phase=type(pod.phase)("Running")))

    def resident(self):
        return self.cache.columns._per_cycle_dev.get(None if self.pkg == "jax" else CPU)

    def binds(self):
        return dict(self.cache.binder.binds)

    def statuses(self):
        def canon(st):
            # a restored acked bind is BOUND where the uninterrupted process
            # still shows BINDING (its ack just landed): decision-equivalent
            return "BOUND" if st.name == "BINDING" else st.name

        return {t.uid: canon(t.status) for j in self.cache.jobs.values()
                for t in j.tasks.values()}

    def stop(self):
        self.cache.stop()


@pytest.fixture
def sides():
    made = []

    def make(*a, **kw):
        s = Side(*a, **kw)
        made.append(s)
        return s

    yield make
    for s in made:
        s.stop()


def _warm(pair, cycles=6):
    """Churny cycles on every side until the per-cycle device cache exists
    and its scatter path engaged (``tests/test_failover.py``'s
    ``_warm_resident``)."""
    for s in pair:
        s.apply(_base_events())
    for i in range(cycles):
        for s in pair:
            s.apply(_gang_events(i + 1))
            s.cycle()
        keys = [k for k in sorted(pair[0].cache.pods)[:2]]
        for s in pair:
            for key in keys:
                s.set_running(key)


# --------------------------------------------------------------------------
# failover_recover and revalidate_resident
# --------------------------------------------------------------------------


def test_failover_report_matches_jax_and_keeps_the_resident_cache(sides):
    """On the same churned cluster the report equals the JAX package's and
    reads ``warm``; the resident cache object survives, the next cycle
    costs no more full uploads than a steady cycle and is consistent."""
    pair = [sides("jax"), sides("port")]
    _warm(pair)
    jax, port = pair
    rc = port.resident()
    assert rc is not None and rc.version > 0
    # a steady cycle's full uploads, for the comparison below
    for s in pair:
        s.apply(_gang_events(100))
    pre = rc.counters()["full_uploads"]
    for s in pair:
        s.cycle()
    steady = rc.counters()["full_uploads"] - pre
    reports = {s.pkg: s.cache.failover_recover() for s in pair}
    assert reports["port"] == reports["jax"]
    assert reports["port"]["mode"] == "warm" and reports["port"]["errors"] == []
    assert reports["port"]["resident_tokens"]["single"] > 0
    assert port.resident() is rc
    before = rc.counters()["full_uploads"]
    for s in pair:
        s.apply(_gang_events(101))
        s.cycle()
    after = rc.counters()["full_uploads"] - before
    assert after <= steady and after < len(PER_CYCLE_FIELDS)
    assert port.binds() == jax.binds()
    assert port.cache.columns.check_consistency(port.cache) == []


def test_failed_revalidation_cold_starts(sides, monkeypatch):
    pair = [sides("jax"), sides("port")]
    _warm(pair, cycles=3)
    for s in pair:
        monkeypatch.setattr(type(s.cache.columns), "check_consistency",
                            lambda self, c: ["planted inconsistency"])
    reports = {s.pkg: s.cache.failover_recover() for s in pair}
    assert reports["port"] == reports["jax"]
    assert reports["port"]["mode"] == "cold"
    assert reports["port"]["errors"] == ["planted inconsistency"]
    assert pair[1].cache.columns._per_cycle_dev == {}


def test_unsynced_resident_cache_never_survives():
    from kube_batch_tpu_torch.api.resident import PerCycleDeviceCache

    cache = SchedulerCache()
    try:
        cache.columns._per_cycle_dev[CPU] = PerCycleDeviceCache(CPU)
        report = cache.columns.revalidate_resident(cache)
        assert report == {"mode": "cold", "resident_tokens": {"single": 0}, "errors": []}
        assert cache.columns._per_cycle_dev == {}
        # no residency at all: nothing to drop, and nothing unsynced
        assert cache.columns.revalidate_resident(cache)["mode"] == "warm"
    finally:
        cache.stop()


def test_failover_counts_in_the_failover_series(sides):
    from test_torch_metrics import assert_same_series, recording

    pair = [sides("jax"), sides("port")]
    _warm(pair, cycles=2)
    with recording() as logs:
        for s in pair:
            s.cache.failover_recover()
    assert_same_series(logs, "failover")
    adds = logs["port"].summary()["adds"]
    assert adds[("volcano_leader_failover_total", ("warm",))] == 1


def test_failover_flushes_the_quarantine(sides):
    port = sides("port")
    _warm([port], cycles=2)
    port.cache.resync.poison_after = 1

    class Exploding:
        def bind(self, pod, hostname):
            raise RuntimeError("down")

    port.cache.binder = Exploding()
    port.apply(_gang_events(50, size=1))
    port.cycle()
    port.cache.process_resync_tasks()
    port.cache.process_resync_tasks()
    assert port.cache.resync.quarantined
    port.cache.failover_recover()
    assert port.cache.resync.quarantined == {}


def test_failover_mid_churn_open_matches_the_full_view(sides):
    port = sides("port")
    _warm([port])
    port.cache.failover_recover()
    ssn = open_session(port.cache, port.conf.tiers, "cpu")
    try:
        expected = port.cache.session_view()
        assert set(ssn.jobs) | {j.uid for j in ssn.gate_dropped_jobs} == set(expected.jobs)
    finally:
        close_session(ssn)


# --------------------------------------------------------------------------
# crash recovery: save → a fresh process's load → failover_recover
# --------------------------------------------------------------------------


def _churn(pair, rng, serial):
    """``tests/test_failover.py``'s churn: gangs with heterogeneous requests
    (no decision falls to the row-keyed tie-break, so the restart's row
    permutation cannot change one), and random progressions to Running,
    decided once and applied to every side."""
    events = []
    for g in range(int(rng.integers(1, 3))):
        size = int(rng.integers(1, 4))
        events += _gang_events(serial * 10 + g, size=size, cpu=300.0 + 97.0 * serial + 31.0 * g)
    for s in pair:
        s.apply(events)
    ref = pair[0].cache
    run = [k for k in sorted(ref.pods) if ref.pods[k].node_name
           and ref.pods[k].phase.value == "Pending" and rng.random() < 0.4]
    for s in pair:
        for key in run:
            s.set_running(key)


def test_restart_recovers_bit_exact_with_no_bind_regression(sides, tmp_path):
    """Shipped conf; five churn cycles with binds left in flight at the
    save.  The restarted port cache recovers warm-or-cold with no error, no
    acked bind regresses, and the next cycle's binds and statuses equal
    the uninterrupted port run's and the JAX package's (uninterrupted and
    restarted alike)."""
    rng = np.random.default_rng(7)
    live = [sides("jax", "shipped"), sides("port", "shipped")]
    for s in live:
        s.apply(_base_events())
    for serial in range(1, 6):
        _churn(live, rng, serial)
        for s in live:
            s.cycle(flush=False)  # binds stay in flight: save_state drains them
    restarted = []
    for s in live:
        path = str(tmp_path / f"{s.pkg}.json")
        s.m["save"](s.cache, path)
        fresh = sides(s.pkg, "shipped")
        assert fresh.m["load"](fresh.cache, path)
        report = fresh.cache.failover_recover()
        assert report["errors"] == []
        acked = {k: p.node_name for k, p in s.cache.pods.items() if p.node_name}
        assert acked
        for key, node in acked.items():
            assert fresh.cache.pods[key].node_name == node, key
        uids = {s.cache.pods[k].uid for k in acked}
        for job in fresh.cache.jobs.values():
            for t in job.tasks.values():
                if t.uid in uids:
                    assert t.status.name != "PENDING"
        restarted.append(fresh)
    before = {s.pkg: s.binds() for s in live}
    for s in live + restarted:
        s.apply(_gang_events(999, size=2, cpu=777.0))
        s.cycle()
    new = {}
    for s in live:
        new[("live", s.pkg)] = {k: v for k, v in s.binds().items() if k not in before[s.pkg]}
    for s in restarted:
        new[("restarted", s.pkg)] = s.binds()
    assert new[("live", "port")], new
    assert len({json.dumps(v, sort_keys=True) for v in new.values()}) == 1, new
    statuses = [s.statuses() for s in live + restarted]
    assert all(st == statuses[0] for st in statuses)
    for s in live[1:] + restarted[1:]:
        assert s.cache.columns.check_consistency(s.cache) == []


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_state_files_load_across_packages(sides, tmp_path, writer, reader):
    """A state file written by one package loads into the other: the same
    objects (pods with their placements, PodGroups with their phases,
    queues, priority classes, PDBs, the PV ledger and its bindings), and
    the next cycle is decided as the writer's own reload decides it."""
    from kube_batch_tpu_torch.cache.volume import StandalonePVBinder

    from kube_batch_tpu.api.pod import PersistentVolume, PodDisruptionBudget, PriorityClass
    from kube_batch_tpu.cache.volume import StandalonePVBinder as JaxPVBinder

    def make(pkg):
        s = sides(pkg, "shipped", reserve=False)
        s.cache.volume_binder = (JaxPVBinder if pkg == "jax" else StandalonePVBinder)()
        return s

    src = make(writer)
    src.apply(_base_events(n_nodes=3) + [
        ("add_priority_class", PriorityClass(name="high", value=50)),
        ("add_pdb", PodDisruptionBudget(name="pdb0", namespace="fo", min_available=1,
                                        owner="owner-x"))])
    pv = PersistentVolume(name="pv0", node="n1")
    src.cache.volume_binder.add_pv(pv if writer == "jax" else mirror(pv))
    src.cache.volume_binder.bound["fo/claim0"] = "pv0"
    for serial in range(1, 4):
        src.apply(_gang_events(serial, size=2, cpu=700.0 + 100 * serial))
        src.cycle()
    path = str(tmp_path / "state.json")
    src.m["save"](src.cache, path)
    state = json.loads(open(path).read())
    assert state["pods"] and state["pdbs"] and state["pvs"] and state["pv_bound"]
    mine, theirs = make(writer), make(reader)
    for s in (mine, theirs):
        assert s.m["load"](s.cache, path)
    # the reloads hold the same objects: each package's save of its reload
    # equals the other's, key for key
    saved = {}
    for s in (mine, theirs):
        p = str(tmp_path / f"re-{s.pkg}.json")
        s.m["save"](s.cache, p)
        saved[s.pkg] = json.loads(open(p).read())
    assert saved[reader] == saved[writer]
    for s in (mine, theirs):
        s.apply(_gang_events(50, size=2, cpu=900.0))
        s.cycle()
    assert mine.binds() == theirs.binds()
    assert mine.binds(), "the next cycle placed nothing"
    assert mine.statuses() == theirs.statuses()


def test_missing_state_file_loads_nothing(tmp_path):
    from kube_batch_tpu_torch.cache.persistence import load_state

    cache = SchedulerCache()
    try:
        assert load_state(cache, str(tmp_path / "missing.json")) is False
        assert cache.pods == {}
    finally:
        cache.stop()


# --------------------------------------------------------------------------
# the file-lock elector and the warm-standby loop
# --------------------------------------------------------------------------


def test_single_leader_and_handover(tmp_path):
    """One leads, the standby blocks while the lease is valid, a release
    hands over (the first leader holds until told, so no timing decides
    the order)."""
    kw = dict(lease_duration=2.0, renew_deadline=1.5, retry_period=0.05)
    a = LeaderElector(str(tmp_path), identity="a", **kw)
    b = LeaderElector(str(tmp_path), identity="b", **kw)
    order = []
    release_a = threading.Event()

    def lead(elector, name, body):
        def run():
            order.append(name)
            body()
        elector.run(run)

    ta = threading.Thread(target=lead, args=(a, "a", lambda: release_a.wait(10)),
                          daemon=True)
    tb = threading.Thread(target=lead, args=(b, "b", lambda: None), daemon=True)
    ta.start()
    try:
        deadline = time.monotonic() + 10
        while not a.is_leader() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert a.is_leader() and not b.is_leader()
        tb.start()
        time.sleep(0.3)
        assert order == ["a"]  # b blocked while a's lease is valid
    finally:
        release_a.set()
        ta.join(10)
        if tb.ident is not None:
            tb.join(10)
    assert not ta.is_alive() and not tb.is_alive()
    assert order == ["a", "b"]
    assert not a.is_leader() and not b.is_leader()


def test_lost_renewal_raises_lost_leadership(tmp_path):
    """A leader whose renewals fail past the deadline is stopped and
    raises (the crash-on-loss contract)."""
    e = LeaderElector(str(tmp_path), identity="a", lease_duration=0.4,
                      renew_deadline=0.1, retry_period=0.03)
    stopped = threading.Event()
    e._try_acquire_or_renew = iter([True] + [False] * 1000).__next__
    with pytest.raises(LostLeadership):
        e.run(lambda: stopped.wait(5), on_stopped_leading=stopped.set)
    assert stopped.is_set()


def test_elector_reset_rearms_for_the_same_process(tmp_path):
    e = LeaderElector(str(tmp_path), identity="a")
    e.release()
    assert e._stop.is_set()
    e.reset()
    assert not e._stop.is_set() and e._renew_thread is None


def test_rfc3339_stamps_match_jax():
    from kube_batch_tpu.cmd import leader_election as J
    from kube_batch_tpu_torch.cmd import leader_election as P

    for ts in (0.0, 1.5, 1_700_000_000.123456):
        assert P._rfc3339_micro(ts) == J._rfc3339_micro(ts)
        assert P._parse_rfc3339(P._rfc3339_micro(ts)) == J._parse_rfc3339(J._rfc3339_micro(ts))
    assert P._parse_rfc3339(None) == P._parse_rfc3339("junk") == 0.0


def _stub_scheduler():
    cache = SchedulerCache()
    sched = Scheduler(cache, conf=load_scheduler_conf(None), schedule_period=0.0,
                      device="cpu")
    sched.on_cycle_end = sched.stop  # each reign runs exactly one cycle
    return cache, sched


def test_warm_standby_recovers_and_recontends(monkeypatch):
    """Reign 1 loses the lease, the loop re-arms the elector, reign 2
    recovers through ``failover_recover`` before its first cycle."""
    from kube_batch_tpu_torch.cmd.server import run_warm_standby

    cache, sched = _stub_scheduler()
    recoveries = []
    monkeypatch.setattr(cache, "failover_recover", lambda: recoveries.append(1) or {
        "mode": "warm", "resident_tokens": {}, "errors": []})

    class StubElector:
        def __init__(self):
            self.runs = 0
            self.resets = 0

        def run(self, lead, on_stopped_leading=None):
            self.runs += 1
            if self.runs == 1:
                raise LostLeadership("reign 1 lost the lease")
            lead()

        def reset(self):
            self.resets += 1

    elector = StubElector()
    try:
        run_warm_standby(elector, sched, cache, max_takeovers=3)
    finally:
        sched.close()
        cache.stop()
    assert elector.runs == 2 and elector.resets == 1
    assert recoveries == [1]


def test_warm_standby_over_a_real_lease(tmp_path):
    """The loop over the file lock: reign 1's renewals start failing after
    its first cycle, the lost lease stops the loop and the process demotes
    in place, re-contends, wins again and recovers through
    ``failover_recover`` before reign 2's cycle."""
    from kube_batch_tpu_torch.cmd.server import run_warm_standby

    cache, sched = _stub_scheduler()
    e = LeaderElector(str(tmp_path), identity="a", lease_duration=0.4,
                      renew_deadline=0.05, retry_period=0.02)
    failing = threading.Event()
    acquire, reset = e._try_acquire_or_renew, e.reset
    e._try_acquire_or_renew = lambda: False if failing.is_set() else acquire()

    def rearm():
        failing.clear()
        reset()

    e.reset = rearm
    reports = []
    recover = cache.failover_recover
    cache.failover_recover = lambda: reports.append(recover()) or reports[-1]
    # reign 1: its renewals fail from its first cycle on; reign 2 (after
    # the recovery): one cycle, then a clean stop
    sched.on_cycle_end = lambda: sched.stop() if reports else failing.set()
    try:
        run_warm_standby(e, sched, cache, max_takeovers=3)
    finally:
        sched.close()
        cache.stop()
    assert len(reports) == 1 and reports[0]["errors"] == []
    assert not e.is_leader()


def test_scheduler_rearms_after_stop():
    """``run_forever`` is re-enterable after ``stop()``: the standby's
    second reign reuses the same Scheduler."""
    cache, sched = _stub_scheduler()
    try:
        sched.run_forever()
        sched.run_forever()
        assert sched._stop
    finally:
        sched.close()
        cache.stop()
