"""The port's lock checker beside the JAX package's, on the CPU.

Every xdist worker of the tier-1 run has the JAX package's checker
installed for the whole session (``tests/conftest.py``), and every port
test module adds the port's (``port_lockdep``).  These tests hold the two
apart: each tracks its own package's locks and nothing else, a violation
among port locks reaches only the port's checker, and uninstalling the
port's checker leaves the primitives as they were.  Then the same cluster
goes through both packages' pipelined ``run_forever``, a what-if through
the batcher's thread and a publish/follow, each under its own checker, and
the two acquisition graphs — each lock site named by (module, class,
attribute) — must be equal over the modules both checkers track."""

from __future__ import annotations

import concurrent.futures
import threading
import time
from pathlib import Path

import pytest

from kube_batch_tpu.analysis import lockdep as jax_lockdep
from kube_batch_tpu_torch.analysis import lockdep, pytest_plugin
from kube_batch_tpu_torch.analysis.lockdep import LockdepState, TrackedLock
from fixtures import GiB, build_node, build_pod
from test_torch_cycle import mirror
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

TESTS = Path(__file__).resolve().parent


def test_every_port_test_module_runs_under_the_port_checker():
    missing = [p.name for p in sorted(TESTS.glob("test_torch_*.py"))
               if "port_lockdep" not in p.read_text()]
    assert missing == []


def _primitives():
    return (threading.Lock, threading.RLock, time.sleep,
            concurrent.futures.Future.result, threading.Event.wait)


@pytest.fixture()
def both_checkers():
    """The JAX checker as the session has it (installed here when the
    session runs without it) and the port's on a private state, in place
    of the module fixture's for the length of one test."""
    own_jax = jax_lockdep.current_state() is None
    jstate = jax_lockdep.install()
    fixture_state = lockdep.uninstall()
    before = _primitives()
    pstate = lockdep.install(state=LockdepState())
    try:
        yield jstate, pstate, before
    finally:
        lockdep.uninstall()
        after = _primitives()
        if fixture_state is not None:
            lockdep.install(state=fixture_state)
        if own_jax:
            jax_lockdep.uninstall()
    assert after == before


def test_each_checker_tracks_its_own_package(both_checkers):
    from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
    from kube_batch_tpu.scheduler import CycleTrigger as JaxTrigger
    from kube_batch_tpu_torch.cache.cache import SchedulerCache
    from kube_batch_tpu_torch.scheduler import CycleTrigger

    jstate, pstate, before = both_checkers
    # the port's checker never touches the globals the JAX checker patched
    assert (threading.Lock, threading.RLock) == before[:2]
    jcache, pcache = JaxCache(), SchedulerCache()
    try:
        for lock in (jcache._lock, jcache._ingest_lock, jcache._dispatch_mu,
                     JaxTrigger()._cond._lock):
            assert isinstance(lock, jax_lockdep.TrackedLock)
            assert lock._state is jstate
            assert lock.site.startswith("kube_batch_tpu.")
        for lock in (pcache._lock, pcache._ingest_lock, pcache._dispatch_mu,
                     CycleTrigger()._cond._lock):
            assert isinstance(lock, TrackedLock)
            assert lock._state is pstate
            assert lock.site.startswith("kube_batch_tpu_torch.")
        # a lock created outside both packages is a real primitive for both
        assert not isinstance(threading.Lock(), (TrackedLock, jax_lockdep.TrackedLock))
    finally:
        jcache.stop()
        pcache.stop()


def test_a_port_inversion_reaches_only_the_port_checker(both_checkers):
    from kube_batch_tpu_torch.cache.cache import SchedulerCache

    jstate, pstate, _ = both_checkers
    n_jax = len(jstate.violations)
    cache = SchedulerCache()
    a, b = cache._ingest_lock, cache._dispatch_mu
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    with a:
        time.sleep(0)  # chained: the port's check, then the JAX checker's
    assert [v.kind for v in pstate.violations] == ["order-inversion", "blocking-under-lock"]
    assert len(jstate.violations) == n_jax
    cache.stop()


def test_uninstall_gives_the_modules_back_their_locks(both_checkers):
    import kube_batch_tpu_torch.cache.cache as port_cache_mod
    import kube_batch_tpu_torch.obs.trace as trace_mod

    _, pstate, before = both_checkers
    assert isinstance(trace_mod._ATTACH_LOCK, TrackedLock)
    assert port_cache_mod.threading is not threading
    lockdep.uninstall()
    try:
        assert _primitives() == before
        assert port_cache_mod.threading is threading
        assert not isinstance(trace_mod._ATTACH_LOCK, TrackedLock)
    finally:
        lockdep.install(state=pstate)


# --------------------------------------------------------------------------
# graph parity: one drive through both packages, each under its own checker
# --------------------------------------------------------------------------

#: the modules both checkers instrument: the JAX package's list (the port
#: adds serve, replicate and k8s.transport, whose locks the JAX graph has
#: no counterpart for)
SHARED = ("cache", "cmd.server", "k8s.watch", "metrics", "scheduler", "obs", "guard")
BODY = {"queue": "default", "count": 2,
        "requests": {"cpu": 1500, "memory": 2 * GiB}}


def _objects(i0, n):
    from kube_batch_tpu.api.pod import PodGroup
    from kube_batch_tpu.api.types import PodPhase

    out = []
    for i in range(i0, i0 + n):
        out.append(("pg", PodGroup(name=f"g{i}", namespace="c1", min_member=1,
                                   queue="default")))
        out.append(("pod", build_pod("c1", f"g{i}-0", None, PodPhase.PENDING,
                                     {"cpu": 500, "memory": GiB}, group_name=f"g{i}")))
    return out


def _drive(pkg: str) -> None:
    """Cluster, pipelined run_forever with staged arrivals, a what-if on
    the batcher's thread, a publisher and a follower that applies its
    records and answers the same what-if."""
    from kube_batch_tpu.api.pod import Queue

    if pkg == "jax":
        from kube_batch_tpu.cache.cache import SchedulerCache
        from kube_batch_tpu.framework.conf import load_scheduler_conf, shipped_conf_path
        from kube_batch_tpu.replicate.follower import FollowerCache, ReplicationFollower
        from kube_batch_tpu.replicate.publisher import ReplicationPublisher
        from kube_batch_tpu.scheduler import Scheduler
        from kube_batch_tpu.serve.plane import QueryPlane

        conv, kw = (lambda o: o), {}
    else:
        from kube_batch_tpu_torch.cache.cache import SchedulerCache
        from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
        from kube_batch_tpu_torch.replicate.follower import FollowerCache, ReplicationFollower
        from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher
        from kube_batch_tpu_torch.scheduler import Scheduler
        from kube_batch_tpu_torch.serve.plane import QueryPlane

        conv, kw = mirror, {"device": "cpu"}
    from kube_batch_tpu_torch.testing.cycle_drive import Loopback

    cache = SchedulerCache()
    cache.add_queue(conv(Queue(name="default", weight=1)))
    for i in range(4):
        cache.add_node(conv(build_node(f"n{i}", cpu=8000, mem=16 * GiB, pods=32)))
    qp = QueryPlane(cache, start_thread=True)
    cache.replication = pub = ReplicationPublisher()
    sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()),
                      schedule_period=0.05, **kw)
    loop = threading.Thread(target=sched.run_forever, daemon=True)
    fcache = FollowerCache()
    fqp = QueryPlane(fcache, start_thread=False)
    follower = ReplicationFollower("http://in-process", cache=fcache, query_plane=fqp,
                                   transport=Loopback(pub), poll_s=0.001, **kw)
    loop.start()
    try:
        for burst in range(3):
            objs = _objects(4 * burst, 4)
            cache.ingest_batch([(cache.add_pod_group if k == "pg" else cache.add_pod,
                                 conv(o)) for k, o in objs])
            deadline = time.monotonic() + 60
            while (len(cache.binder.binds) < 4 * (burst + 1)
                   and time.monotonic() < deadline):
                cache.binder.event.wait(0.05)
            assert len(cache.binder.binds) >= 4 * (burst + 1), pkg
            assert isinstance(qp.submit(dict(BODY)).result(timeout=60), dict)
        pub.barrier()
        while follower.run_once() == "applied":
            pass
        fut = fqp.submit(dict(BODY))
        fqp.batcher.tick(now=fqp.batcher.clock.monotonic() + 1e6)
        fut.result(timeout=60)
    finally:
        sched.stop()
        loop.join(timeout=30)
        sched.close()
        pub.close()
        fqp.close()
        qp.close()
        cache.stop()
    assert not loop.is_alive()


def _recording(monkeypatch, cls, sink, sites):
    """Record every (held site, acquired site) pair a state of ``cls``
    sees, the edges a first sighting would add and the repeats alike, and
    every site acquired."""
    orig = cls.on_acquired

    def on_acquired(self, site, lock_id, *a, **k):
        held = self._held()
        sites.add(site)
        if not any(e[1] == lock_id for e in held):
            sink.update((e[0], site) for e in held if e[0] != site)
        return orig(self, site, lock_id, *a, **k)

    monkeypatch.setattr(cls, "on_acquired", on_acquired)


def _shared(name) -> bool:
    return any(name[0] == m or name[0].startswith(m + ".") for m in SHARED)


def _named(edges):
    """``edges`` by (module, class, attribute), both ends in ``SHARED``."""
    named = {(lockdep.lock_name(a), lockdep.lock_name(b)) for a, b in edges}
    return {(a, b) for a, b in named if _shared(a) and _shared(b)}


def _named_sites(sites):
    return {n for n in map(lockdep.lock_name, sites) if _shared(n)}


def test_acquisition_graphs_match_over_the_shared_modules(monkeypatch):
    own_jax = jax_lockdep.current_state() is None
    jax_lockdep.install()
    if lockdep.current_state() is None:
        pytest.skip("the port's checker is off (KBT_LOCKDEP=0)")
    jax_edges, port_edges, jax_sites, port_sites = set(), set(), set(), set()
    _recording(monkeypatch, jax_lockdep.LockdepState, jax_edges, jax_sites)
    _recording(monkeypatch, LockdepState, port_edges, port_sites)
    try:
        _drive("jax")
        _drive("port")
    finally:
        if own_jax:
            jax_lockdep.uninstall()
    jax_named = _named(jax_edges)
    port_named = _named(port_edges)
    assert port_named, "the port's drive recorded no edge among its tracked locks"
    # the same lock classes taken, then the same orders among them
    assert _named_sites(jax_sites) == _named_sites(port_sites), (
        f"only JAX: {sorted(_named_sites(jax_sites) - _named_sites(port_sites), key=str)}\n"
        f"only port: {sorted(_named_sites(port_sites) - _named_sites(jax_sites), key=str)}")
    assert jax_named == port_named, (
        f"only JAX: {sorted(jax_named - port_named, key=str)}\n"
        f"only port: {sorted(port_named - jax_named, key=str)}")
    assert pytest_plugin.HOT_STRUCTURES  # the corroborator rode the drive
