"""The port's query plane (``serve/`` + ``ops/probe.py``), against its own
committed cycle and against the JAX package's ``QueryPlane``.

Each oracle and admission case runs on two legs.  On the ``contract`` leg
the port's probe is held against the port's committed cycle: a gang the
probe reports feasible at nodes X on a frozen cache binds to exactly X
when it is submitted, an infeasible verdict carries the committed fit-error
histogram, an eviction verdict's victims are what preempt evicts.  On the
``jax`` leg the same events also feed a JAX cache with its own plane, and
every port response must equal the JAX package's, dict for dict (the
responses carry no timing field), while the contract is checked too.

Then the lease broker (the port's lease retires at every swap, the CPU
included: its swaps rewrite the resident tensors in place), the lease
under live cycles and its re-arm after reclaim's, preempt's and
backfill's swaps, the micro-batcher under a stubbed clock, the flush's
partition and the prewarm (the kernel library's load), the per-response
``unmodeled`` entries, and a guard trip that retires the lease.  The
sharded probe, the HTTP surface and the CLI are not ported."""

from __future__ import annotations

import itertools
import textwrap
import threading
import time

import pytest
import torch

from kube_batch_tpu.api.pod import PodGroup, Queue
from kube_batch_tpu.api.types import PodGroupPhase, PodPhase
from kube_batch_tpu_torch import actions as _port_actions  # noqa: F401 — registers
from kube_batch_tpu_torch import plugins as _port_plugins  # noqa: F401 — registers
from kube_batch_tpu_torch.api.resources import DEFAULT_SPEC
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, parse_scheduler_conf
from kube_batch_tpu_torch.framework.interface import get_action
from kube_batch_tpu_torch.framework.session import close_session, open_session
from kube_batch_tpu_torch.serve.batcher import MicroBatcher, QueueFull
from kube_batch_tpu_torch.serve.lease import LeaseBroker, SnapshotLease
from kube_batch_tpu_torch.serve.plane import QueryPlane, WhatifError
from fixtures import GiB, build_node, build_pod
from test_torch_cycle import mirror
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

CONF = load_scheduler_conf(None)
LEGS = ("contract", "jax")


def _port_run(cache, names=("allocate",), tiers=None):
    ssn = open_session(cache, tiers if tiers is not None else CONF.tiers, "cpu")
    try:
        for name in names:
            get_action(name).execute(ssn)
    finally:
        close_session(ssn)
    cache.flush_binds()


def _tick(qp):
    qp.batcher.tick(now=qp.batcher.clock.monotonic() + 1e6)


def _probe(qp: QueryPlane, body: dict) -> dict:
    """Submit one request and drive the flush on this thread (the test
    planes run with start_thread=False)."""
    fut = qp.submit(body)
    _tick(qp)
    return fut.result(timeout=60)


class World:
    """A port cache with a plane (start_thread=False) and, on the ``jax``
    leg, a JAX cache with its own plane, fed the same events: every probe
    answer of the port is compared with the JAX package's."""

    def __init__(self, leg, queues=(), pod_groups=(), nodes=(), pods=()):
        self.port = SchedulerCache(spec=DEFAULT_SPEC)
        self.jax = None
        if leg == "jax":
            from kube_batch_tpu import actions as _a  # noqa: F401 — registers
            from kube_batch_tpu import plugins as _p  # noqa: F401 — registers
            from fixtures import build_cache

            self.jax = build_cache()
        for q in queues:
            self.add("add_queue", q if isinstance(q, Queue) else Queue(name=q))
        for kind, objs in (("add_pod_group", pod_groups), ("add_node", nodes),
                           ("add_pod", pods)):
            for obj in objs:
                self.add(kind, obj)
        self.qp = QueryPlane(self.port, start_thread=False)
        self.jqp = None
        if self.jax is not None:
            from kube_batch_tpu.serve.plane import QueryPlane as JaxPlane

            self.jqp = JaxPlane(self.jax, start_thread=False)

    def add(self, kind, obj):
        getattr(self.port, kind)(mirror(obj))
        if self.jax is not None:
            getattr(self.jax, kind)(obj)

    def run(self, names=("allocate",), conf_text=None):
        tiers = None if conf_text is None else parse_scheduler_conf(conf_text).tiers
        _port_run(self.port, names, tiers)
        if self.jax is not None:
            from kube_batch_tpu.framework.conf import load_scheduler_conf as jconf
            from kube_batch_tpu.framework.conf import parse_scheduler_conf as jparse
            from kube_batch_tpu.framework.interface import get_action as jget
            from kube_batch_tpu.framework.session import close_session as jclose
            from kube_batch_tpu.framework.session import open_session as jopen

            jt = (jconf(None) if conf_text is None else jparse(conf_text)).tiers
            ssn = jopen(self.jax, jt)
            try:
                for name in names:
                    jget(name).execute(ssn)
            finally:
                jclose(ssn)
            self.jax.flush_binds()
            assert dict(self.port.binder.binds) == dict(self.jax.binder.binds)
            assert sorted(self.port.evictor.evicts) == sorted(self.jax.evictor.evicts)

    def probe(self, body: dict) -> dict:
        got = _probe(self.qp, body)
        if self.jqp is not None:
            want = _probe(self.jqp, body)
            assert got == want, (body, got, want)
        return got

    def close(self):
        self.qp.close()
        if self.jqp is not None:
            self.jqp.close()
            self.jax.stop()
        self.port.stop()


@pytest.fixture
def worlds():
    made = []

    def make(leg, **kw):
        w = World(leg, **kw)
        made.append(w)
        return w

    yield make
    for w in made:
        w.close()


@pytest.fixture
def plane_factory():
    planes = []

    def make(cache, **kw):
        kw.setdefault("start_thread", False)
        qp = QueryPlane(cache, **kw)
        planes.append(qp)
        return qp

    yield make
    for qp in planes:
        qp.close()


def port_cache(queues=(), pod_groups=(), nodes=(), pods=()) -> SchedulerCache:
    """The port's cache fed the JAX objects (mirrored), in build_cache's
    order."""
    cache = SchedulerCache(spec=DEFAULT_SPEC)
    for q in queues:
        cache.add_queue(mirror(q if isinstance(q, Queue) else Queue(name=q)))
    for pg in pod_groups:
        cache.add_pod_group(mirror(pg))
    for n in nodes:
        cache.add_node(mirror(n))
    for p in pods:
        cache.add_pod(mirror(p))
    return cache


# ==========================================================================
# oracle exactness: the probe against the committed solve
# ==========================================================================


def _heterogeneous(leg, worlds):
    """Nodes of varied size with varied running load: placement is a real
    decision, not a tie."""
    return worlds(
        leg,
        queues=[Queue(name="default", weight=1)],
        pod_groups=[PodGroup(name="run0", namespace="c1", min_member=1, queue="default"),
                    PodGroup(name="run1", namespace="c1", min_member=1, queue="default")],
        nodes=[build_node("n0", cpu=8000, mem=16 * GiB),
               build_node("n1", cpu=4000, mem=8 * GiB),
               build_node("n2", cpu=16000, mem=32 * GiB),
               build_node("n3", cpu=8000, mem=16 * GiB),
               build_node("n4", cpu=2000, mem=4 * GiB)],
        pods=[build_pod("c1", "r0", "n0", PodPhase.RUNNING,
                        {"cpu": 6000, "memory": 4 * GiB}, group_name="run0"),
              build_pod("c1", "r1", "n2", PodPhase.RUNNING,
                        {"cpu": 2000, "memory": 2 * GiB}, group_name="run0"),
              build_pod("c1", "r2", "n3", PodPhase.RUNNING,
                        {"cpu": 7000, "memory": GiB}, group_name="run1")],
    )


def _submit_gang(w, count, requests, *, priority=0, selector=None, min_member=None):
    w.add("add_pod_group", PodGroup(
        name="probe-pg", namespace="c1",
        min_member=min_member if min_member is not None else count, queue="default"))
    for i in range(count):
        w.add("add_pod", build_pod("c1", f"probe-{i}", None, PodPhase.PENDING,
                                   dict(requests), group_name="probe-pg",
                                   priority=priority, node_selector=selector or {}))


def _committed_hist(cache):
    job = next(j for j in cache.jobs.values() if j.name == "probe-pg")
    (fe,) = job.nodes_fit_errors.values()
    return dict(fe._hist)


def _evict_world(leg, worlds, min_member):
    return worlds(
        leg, queues=["default"],
        pod_groups=[PodGroup(name="low", namespace="c1", min_member=min_member,
                             queue="default")],
        nodes=[build_node("n1", cpu=2000, mem=4 * GiB, pods=10)],
        pods=[build_pod("c1", "low-1", "n1", PodPhase.RUNNING,
                        {"cpu": 1000, "memory": GiB}, group_name="low"),
              build_pod("c1", "low-2", "n1", PodPhase.RUNNING,
                        {"cpu": 1000, "memory": GiB}, group_name="low")],
    )


@pytest.mark.parametrize("leg", LEGS)
class TestWhatifOracle:
    def test_feasible_gang_binds_exactly_at_probed_nodes(self, leg, worlds):
        w = _heterogeneous(leg, worlds)
        w.run()  # publishes the lease of the frozen state
        resp = w.probe({"queue": "default", "count": 3,
                        "requests": {"cpu": 1500, "memory": 2 * GiB}})
        assert resp["feasible"] and resp["committed"]
        assert all(n is not None for n in resp["nodes"])
        _submit_gang(w, 3, {"cpu": 1500, "memory": 2 * GiB})
        w.run()
        binds = dict(w.port.binder.binds)
        assert [binds[f"c1/probe-{i}"] for i in range(3)] == resp["nodes"]

    def test_min_available_above_count_cannot_commit(self, leg, worlds):
        w = _heterogeneous(leg, worlds)
        w.run()
        resp = w.probe({"queue": "default", "count": 2, "min_available": 5,
                        "requests": {"cpu": 500, "memory": GiB}})
        assert not resp["committed"]
        _submit_gang(w, 2, {"cpu": 500, "memory": GiB}, min_member=5)
        w.run()
        assert not any(k.startswith("c1/probe-") for k in dict(w.port.binder.binds))

    def test_pure_tie_break_case_matches(self, leg, worlds):
        """Identical nodes: the per-(row, node) tie hash alone decides, so the
        probe's rows (peek_task_rows) are what makes it land right."""
        w = worlds(leg, queues=[Queue(name="default", weight=1)],
                   nodes=[build_node(f"t{i}", cpu=8000, mem=16 * GiB) for i in range(6)])
        w.run()
        resp = w.probe({"queue": "default", "count": 4,
                        "requests": {"cpu": 1000, "memory": GiB}})
        assert resp["feasible"]
        _submit_gang(w, 4, {"cpu": 1000, "memory": GiB})
        w.run()
        binds = dict(w.port.binder.binds)
        assert [binds[f"c1/probe-{i}"] for i in range(4)] == resp["nodes"]

    def test_infeasible_reason_matches_committed_fit_errors(self, leg, worlds):
        w = _heterogeneous(leg, worlds)
        w.run()
        resp = w.probe({"queue": "default", "count": 1,
                        "requests": {"cpu": 1000, "memory": GiB},
                        "node_selector": {"zone": "nowhere"}})
        assert not resp["feasible"] and resp["unplaced"] == 1
        _submit_gang(w, 1, {"cpu": 1000, "memory": GiB}, selector={"zone": "nowhere"})
        w.run()
        assert "c1/probe-0" not in dict(w.port.binder.binds)
        assert resp["fit_errors"] == _committed_hist(w.port)

    def test_resource_infeasible_reason_matches(self, leg, worlds):
        w = _heterogeneous(leg, worlds)
        w.run()
        resp = w.probe({"queue": "default", "count": 1,
                        "requests": {"cpu": 64000, "memory": GiB}})
        assert not resp["feasible"]
        _submit_gang(w, 1, {"cpu": 64000, "memory": GiB})
        w.run()
        assert resp["fit_errors"] == _committed_hist(w.port)

    def test_eviction_probe_matches_committed_preempt(self, leg, worlds):
        """A starved high-priority gang on a full node: the probe's
        hypothetical eviction set is what preempt then evicts."""
        w = _evict_world(leg, worlds, min_member=1)
        w.run()
        resp = w.probe({"queue": "default", "count": 1, "priority": 100,
                        "requests": {"cpu": 1000, "memory": GiB}, "evictions": True})
        assert not resp["feasible"]
        ev = resp["evictions"]
        assert ev["covered"] and ev["claim_nodes"] == ["n1"]
        assert len(ev["victims"]) == 1 and ev["victims"][0].startswith("c1/low-")
        _submit_gang(w, 1, {"cpu": 1000, "memory": GiB}, priority=100)
        w.run(names=("allocate", "preempt"))
        assert sorted(w.port.evictor.evicts) == ev["victims"]

    def test_no_eviction_when_gang_would_break(self, leg, worlds):
        w = _evict_world(leg, worlds, min_member=2)
        w.run()
        resp = w.probe({"queue": "default", "count": 1, "priority": 100,
                        "requests": {"cpu": 1000, "memory": GiB}, "evictions": True})
        assert resp["evictions"]["victims"] == [] and not resp["evictions"]["covered"]
        _submit_gang(w, 1, {"cpu": 1000, "memory": GiB}, priority=100)
        w.run(names=("allocate", "preempt"))
        assert w.port.evictor.evicts == []

    def test_admission_verdict_mirrors_enqueue_capability(self, leg, worlds):
        w = _heterogeneous(leg, worlds)
        w.run()
        ok = w.probe({"queue": "default", "count": 1,
                      "requests": {"cpu": 100, "memory": GiB},
                      "min_resources": {"cpu": 2000, "memory": 2 * GiB}})
        assert ok["enqueue_admitted"]
        # cluster total cpu 38000, × 1.2 = 45600; used 15000 → idle 30600
        too_big = w.probe({"queue": "default", "count": 1,
                           "requests": {"cpu": 100, "memory": GiB},
                           "min_resources": {"cpu": 99000}})
        assert not too_big["enqueue_admitted"]

    def test_idle_and_empty_cluster_still_serve(self, leg, worlds):
        """An idle cluster publishes a lease too, and republishes only when
        ingest moved the version."""
        w = worlds(leg, queues=[Queue(name="default", weight=1)],
                   nodes=[build_node("i0", cpu=4000, mem=8 * GiB)])
        w.run()  # no jobs at all
        body = {"queue": "default", "count": 1, "requests": {"cpu": 1000, "memory": GiB}}
        resp = w.probe(body)
        assert resp["feasible"] and resp["nodes"] == ["i0"]
        published = w.qp.broker.published
        w.run()
        assert w.qp.broker.published == published
        again = w.probe(body)
        assert again["nodes"] == ["i0"]
        assert again["snapshot_version"] == resp["snapshot_version"]


def test_request_validation(plane_factory):
    cache = port_cache(queues=["default"], nodes=[build_node("v0")])
    qp = plane_factory(cache)
    for body in ({"count": 0}, {"count": 10_000}, {"count": 1, "requests": "not-a-map"},
                 {"count": 1, "requests": {"cpu": "abc"}}, {"count": 1, "priority": "high"},
                 {"count": 1, "tolerations": "not-a-list"},
                 {"count": 1, "tolerations": [{"bogus": 1}]},
                 {"count": 1, "min_resources": {"cpu": "abc"}},
                 {"count": 1, "min_available": 2**40}, {"count": 1, "priority": 2**40}):
        with pytest.raises(WhatifError) as err:
            qp.submit(body)
        assert err.value.status == 400, body
    with pytest.raises(WhatifError):
        qp.submit_sweep({"count": 1, "evictions": True})
    with pytest.raises(WhatifError):
        qp.submit_sweep({"count": 1, "max_count": 65})


# ==========================================================================
# the queue-state half of the admission verdict
# ==========================================================================


def _capped(leg, worlds):
    # queue "capped" holds 6000 cpu of running load against a 10000-cpu
    # capability; the cluster has far more idle, so only the queue veto
    # separates the verdicts
    return worlds(
        leg,
        queues=[Queue(name="capped", weight=1,
                      capability={"cpu": 10000.0, "memory": 64 * GiB, "pods": 16.0})],
        pod_groups=[PodGroup(name="run0", namespace="c1", min_member=1, queue="capped")],
        nodes=[build_node(f"n{i}", cpu=16000, mem=64 * GiB, pods=64) for i in range(2)],
        pods=[build_pod("c1", "r0", "n0", PodPhase.RUNNING,
                        {"cpu": 6000, "memory": 4 * GiB}, group_name="run0")],
    )


@pytest.mark.parametrize("leg", LEGS)
class TestQueueAdmissionVeto:
    BASE = {"queue": "capped", "count": 1, "requests": {"cpu": 100, "memory": GiB}}

    def test_queue_capability_vetoes_over_cap_min_resources(self, leg, worlds):
        w = _capped(leg, worlds)
        w.run()
        assert w.probe(dict(self.BASE, min_resources={"cpu": 3000}))["enqueue_admitted"]
        over = w.probe(dict(self.BASE, min_resources={"cpu": 8000}))
        assert not over["enqueue_admitted"]
        assert over["feasible"], "the veto is advisory, not a placement gate"

    def test_veto_honors_quanta_tolerance(self, leg, worlds):
        w = _capped(leg, worlds)
        w.run()
        # need 10005: over by 5 < the 10-milli quantum; need 10020: over by 20
        assert w.probe(dict(self.BASE, min_resources={"cpu": 4005}))["enqueue_admitted"]
        assert not w.probe(dict(self.BASE, min_resources={"cpu": 4020}))["enqueue_admitted"]

    def test_unknown_queue_skips_the_veto(self, leg, worlds):
        w = _capped(leg, worlds)
        w.run()
        resp = w.probe(dict(self.BASE, queue="ghost", min_resources={"cpu": 8000}))
        assert resp["enqueue_admitted"]

    def test_verdict_mirrors_committed_enqueue_action(self, leg, worlds):
        w = _capped(leg, worlds)
        w.run()
        verdicts = {}
        for name, cpu in (("over", 8000.0), ("under", 3000.0)):
            verdicts[name] = w.probe(dict(self.BASE, min_resources={"cpu": cpu}))[
                "enqueue_admitted"]
            w.add("add_pod_group", PodGroup(
                name=name, namespace="c1", min_member=1, queue="capped",
                min_resources={"cpu": cpu}, phase=PodGroupPhase.PENDING))
            w.add("add_pod", build_pod("c1", f"{name}-0", None, PodPhase.PENDING,
                                       {"cpu": 100, "memory": GiB}, group_name=name))
        assert verdicts == {"over": False, "under": True}
        w.run(names=("enqueue",))
        phases = {name: w.port.jobs[f"c1/{name}"].pod_group.phase.value
                  for name in ("over", "under")}
        assert phases == {"over": PodGroupPhase.PENDING.value,
                          "under": PodGroupPhase.INQUEUE.value}


# ==========================================================================
# the probe's rows: peek predicts the allocator
# ==========================================================================


class TestPeekTaskRows:
    def test_peek_matches_alloc_order_across_free_and_growth(self):
        """peek(k) predicts alloc() exactly: the free list LIFO first, then
        the grown rows ascending."""
        from kube_batch_tpu_torch.api.columns import _Axis

        ax = _Axis(floor=4)
        for _ in range(2):
            ax.alloc()
        ax.free(0)
        want = ax.peek(8)  # crosses the growth boundary (cap 4)
        got = []
        for _ in range(8):
            row = ax.alloc()
            if row is None:  # the column store's growth path
                ax.on_grown(ax.grown_cap())
                row = ax.alloc()
            got.append(row)
        assert want == got

    def test_peek_task_rows_are_the_rows_new_pods_get(self):
        """Through the cache's handlers: after deletes (rows back on the
        free list) and across the task axis's growth, the next pods land on
        exactly the peeked rows, which are not contiguous."""
        cache = port_cache(queues=["default"], nodes=[build_node("p0", cpu=64000, pods=200)],
                           pod_groups=[PodGroup(name="g", namespace="c1", min_member=1,
                                                queue="default")])
        for i in range(7):
            cache.add_pod(mirror(build_pod("c1", f"a{i}", None, PodPhase.PENDING,
                                           {"cpu": 100}, group_name="g")))
        for i in (1, 4):
            cache.delete_pod(cache.pods[f"c1/a{i}"])
        cols = cache.columns
        want = cols.peek_task_rows(12)
        assert want != sorted(want) or len(set(want)) != len(range(min(want), max(want) + 1))
        for i in range(12):
            cache.add_pod(mirror(build_pod("c1", f"b{i}", None, PodPhase.PENDING,
                                           {"cpu": 100}, group_name="g")))
        job = cache.jobs["c1/g"]
        got = [job.tasks[f"c1/b{i}"]._row for i in range(12)]
        assert got == want


# ==========================================================================
# the lease broker
# ==========================================================================


def _mk_lease(version, snap="snap"):
    return SnapshotLease(snap=snap, meta=None, version=version, config=None,
                         evict_config=None, mesh=None, probe_rows=(), queue_rows={})


class TestLeaseBroker:
    def test_stale_publish_ignored(self):
        broker = LeaseBroker()
        broker.publish(_mk_lease(5))
        broker.publish(_mk_lease(3))
        assert broker.current().version == 5
        broker.publish(_mk_lease(6))
        assert broker.current().version == 6

    def test_current_times_out_without_publisher(self):
        broker = LeaseBroker()
        t0 = time.monotonic()
        assert broker.current(timeout=0.05) is None
        assert time.monotonic() - t0 < 5

    def test_swap_guard_excludes_dispatch(self):
        broker = LeaseBroker()
        broker.publish(_mk_lease(1))
        order = []
        in_swap, release = threading.Event(), threading.Event()

        def swapper():
            with broker.swap_guard():
                order.append("swap_start")
                in_swap.set()
                release.wait(timeout=5)
                order.append("swap_end")

        t = threading.Thread(target=swapper)
        t.start()
        assert in_swap.wait(timeout=5)
        threading.Timer(0.05, release.set).start()
        with broker.dispatch(timeout=5):
            order.append("dispatch")
        t.join(timeout=5)
        assert order == ["swap_start", "swap_end", "dispatch"]

    def test_swap_guard_retires_lease(self):
        broker = LeaseBroker()
        broker.publish(_mk_lease(1))
        with broker.swap_guard():
            assert broker.current() is None  # the tensors are being rewritten
        assert broker.retired == 1
        broker.publish(_mk_lease(2))
        assert broker.current().version == 2

    def test_swap_guard_retires_on_every_in_place_swap_cpu_included(self, plane_factory):
        """The port's swaps rewrite the resident tensors in place on every
        device, so a swap on the CPU retires the lease too (the JAX package
        keeps it there: its CPU swaps do not donate).  A memoized repeat
        writes nothing and retires nothing."""
        from kube_batch_tpu_torch.actions.allocate import build_session_snapshot
        from kube_batch_tpu_torch.api.columns import resident_snap

        cache = port_cache(queues=["default"], nodes=[build_node("c0")],
                           pod_groups=[PodGroup(name="g", namespace="c1", min_member=1,
                                                queue="default")],
                           pods=[build_pod("c1", "p0", None, PodPhase.PENDING,
                                           {"cpu": 100}, group_name="g")])
        qp = plane_factory(cache)
        _port_run(cache)
        assert qp.broker.current() is not None
        retired = qp.broker.retired
        ssn = open_session(cache, CONF.tiers, "cpu")
        try:
            snap, _meta = build_session_snapshot(ssn)
            resident_snap(ssn.columns, snap, "cpu")
            assert qp.broker.current() is None and qp.broker.retired == retired + 1
            qp.broker.publish(_mk_lease(10**9))
            resident_snap(ssn.columns, snap, "cpu")  # the memoized repeat
            assert qp.broker.current() is not None and qp.broker.retired == retired + 1
        finally:
            close_session(ssn)

    def test_swap_waits_for_inflight_dispatch(self):
        """A dispatch's device round-trip is an in-flight reader: a swap
        waits it out before rewriting the tensors."""
        broker = LeaseBroker()
        broker.publish(_mk_lease(1))
        order = []
        reading, release = threading.Event(), threading.Event()

        def reader():
            with broker.dispatch(timeout=5) as lease:
                assert lease is not None
                order.append("read_start")
                reading.set()
                release.wait(timeout=5)
                order.append("read_end")

        t = threading.Thread(target=reader)
        t.start()
        assert reading.wait(timeout=5)
        threading.Timer(0.05, release.set).start()
        with broker.swap_guard():
            order.append("swap")
        t.join(timeout=5)
        assert order == ["read_start", "read_end", "swap"]

    def test_swap_records_its_wait_for_readers(self):
        broker = LeaseBroker()
        broker.publish(_mk_lease(1))
        with broker.swap_guard():
            pass
        assert broker.swap_wait_s < 0.05  # no reader: nothing to wait out
        reading, release = threading.Event(), threading.Event()

        def reader():
            with broker.dispatch(timeout=5):
                reading.set()
                release.wait(timeout=5)

        broker.publish(_mk_lease(2))
        t = threading.Thread(target=reader)
        t.start()
        assert reading.wait(timeout=5)
        threading.Timer(0.1, release.set).start()
        with broker.swap_guard():
            pass
        t.join(timeout=5)
        assert broker.swap_wait_s >= 0.09

    def test_dark_time_runs_from_retirement_to_publish(self):
        broker = LeaseBroker()
        broker.publish(_mk_lease(1))  # the first lease ends no dark spell
        assert broker.dark_s == 0.0
        with broker.swap_guard():
            pass
        time.sleep(0.05)
        assert broker.current() is None and broker.dark_s == 0.0
        broker.publish(_mk_lease(2))
        first = broker.dark_s
        assert first >= 0.05 and broker.dark_longest_s == first
        broker.retire()  # the guard's heal darkens it too
        broker.publish(_mk_lease(3))
        assert first < broker.dark_s < 2 * first + 1.0
        assert broker.dark_longest_s == max(first, broker.dark_s - first)
        dark = broker.dark_s
        broker.publish(_mk_lease(4))  # no retirement before it
        assert broker.dark_s == dark

    def test_publish_never_blocks_behind_dispatch(self):
        broker = LeaseBroker()
        broker.publish(_mk_lease(1))
        in_read, release = threading.Event(), threading.Event()

        def reader():
            with broker.dispatch(timeout=5):
                in_read.set()
                release.wait(timeout=5)

        t = threading.Thread(target=reader)
        t.start()
        assert in_read.wait(timeout=5)
        broker.publish(_mk_lease(2))
        assert broker.current().version == 2
        release.set()
        t.join(timeout=5)


# ==========================================================================
# the lease under live cycles
# ==========================================================================


class TestLeaseUnderChurn:
    def test_versions_monotonic_and_answers_valid_under_live_cycles(self):
        """What-ifs served while cycles mutate the cache: every answer
        decodes, and each client's version tokens never decrease."""
        from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Pod
        from kube_batch_tpu_torch.api.pod import PodGroup as PortPodGroup
        from kube_batch_tpu_torch.api.types import PodPhase as PortPhase

        cache = port_cache(queues=[Queue(name="default", weight=1)],
                           nodes=[build_node(f"c{i}", cpu=8000, mem=16 * GiB)
                                  for i in range(8)])
        qp = QueryPlane(cache, max_batch=4, window_s=0.001, start_thread=True)
        try:
            _port_run(cache)
            stop = threading.Event()
            seen: dict = {}
            errors: list = []

            def client(k):
                mine = seen.setdefault(k, [])
                while not stop.is_set():
                    try:
                        resp = qp.submit({"queue": "default", "count": 2,
                                          "requests": {"cpu": 500, "memory": GiB}}
                                         ).result(timeout=30)
                        assert isinstance(resp["feasible"], bool)
                        assert len(resp["nodes"]) == 2
                        mine.append(resp["snapshot_version"])
                    except Exception as e:  # noqa: BLE001
                        errors.append(repr(e))
                        return

            threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
            for t in threads:
                t.start()
            serial = itertools.count()
            for _ in range(6):
                j = next(serial)
                cache.add_pod_group(PortPodGroup(name=f"churn{j}", namespace="w",
                                                 min_member=1, queue="default"))
                cache.add_pod(Pod(name=f"churn{j}-0", namespace="w",
                                  requests={"cpu": 250.0, "memory": float(GiB)},
                                  annotations={GROUP_NAME_ANNOTATION: f"churn{j}"},
                                  phase=PortPhase.PENDING, creation_index=50_000 + j))
                _port_run(cache)
            stop.set()
            for t in threads:
                t.join(timeout=60)
            assert not errors, errors
            versions = [v for vs in seen.values() for v in vs]
            assert versions, "clients never got an answer"
            assert max(versions) <= qp.broker.current().version
            for vs in seen.values():
                assert vs == sorted(vs)
            assert qp.broker.retired >= 1, "no swap retired a lease"
        finally:
            qp.close()
            cache.stop()

    def test_publish_failure_degrades_serving_not_cycle(self, monkeypatch):
        """A broken query plane never takes the cycle down."""
        cache = port_cache(queues=[Queue(name="default", weight=1)],
                           nodes=[build_node("d0", cpu=4000, mem=8 * GiB)])
        qp = QueryPlane(cache, start_thread=False)
        try:
            monkeypatch.setattr(qp, "publish_session",
                                lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
            cache.add_pod_group(mirror(PodGroup(name="pg", namespace="c1", min_member=1,
                                                queue="default")))
            cache.add_pod(mirror(build_pod("c1", "p0", None, PodPhase.PENDING,
                                           {"cpu": 1000, "memory": GiB}, group_name="pg")))
            _port_run(cache)
            assert dict(cache.binder.binds)["c1/p0"] == "d0"
        finally:
            qp.close()

    @pytest.mark.parametrize("names", [("enqueue", "reclaim", "allocate", "preempt"),
                                       ("enqueue", "reclaim", "allocate", "backfill")])
    def test_swapping_actions_republish_retired_lease(self, plane_factory, names):
        """Every swap retires the lease, and reclaim, preempt and backfill
        swap after allocate publishes: each re-arms right after its
        dispatch, so the cycle ends with a live lease that serves."""
        cache = port_cache(
            queues=["default", "other"],
            pod_groups=[PodGroup(name="low", namespace="c1", min_member=1, queue="default"),
                        PodGroup(name="hi", namespace="c1", min_member=1, queue="default"),
                        PodGroup(name="cross", namespace="c1", min_member=1, queue="other")],
            nodes=[build_node("n1", cpu=2000, mem=4 * GiB, pods=10)],
            pods=[build_pod("c1", "low-1", "n1", PodPhase.RUNNING,
                            {"cpu": 1000, "memory": GiB}, group_name="low"),
                  build_pod("c1", "low-2", "n1", PodPhase.RUNNING,
                            {"cpu": 1000, "memory": GiB}, group_name="low"),
                  build_pod("c1", "hi-0", None, PodPhase.PENDING,
                            {"cpu": 1000, "memory": GiB}, group_name="hi", priority=100),
                  build_pod("c1", "cross-0", None, PodPhase.PENDING,
                            {"cpu": 1000, "memory": GiB}, group_name="cross")])
        qp = plane_factory(cache)
        swaps = []
        cache.columns.on_swap = lambda snap, out: swaps.append(qp.broker.published)
        if "backfill" in names:
            # the stranded-capacity pass runs when the replay discarded
            # placements; make it owed so backfill dispatches its solve
            from kube_batch_tpu_torch.actions import backfill

            real = backfill.BackfillAction._real_requests

            def owed(self, ssn):
                ssn.host_discards = max(getattr(ssn, "host_discards", 0), 1)
                return real(self, ssn)

            backfill.BackfillAction._real_requests = owed
        try:
            tiers = load_scheduler_conf(None).tiers
            ssn = open_session(cache, tiers, "cpu")
            ssn.action_names = list(names)
            try:
                for name in names:
                    get_action(name).execute(ssn)
            finally:
                close_session(ssn)
            cache.flush_binds()
        finally:
            if "backfill" in names:
                backfill.BackfillAction._real_requests = real
        assert len(swaps) >= 2, f"the scenario swapped {len(swaps)} times"
        assert qp.broker.retired >= len(swaps) - 1
        lease = qp.broker.current()
        assert lease is not None, "the plane was left leaseless after the last swap"
        resp = _probe(qp, {"queue": "default", "count": 1,
                           "requests": {"cpu": 100, "memory": GiB}})
        assert resp["snapshot_version"] == lease.version


# ==========================================================================
# the micro-batcher, under a stubbed clock
# ==========================================================================


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t


class TestMicroBatcher:
    def _mk(self, flushed, **kw):
        clock = FakeClock()
        kw.setdefault("max_batch", 4)
        kw.setdefault("window_s", 0.010)
        kw.setdefault("max_queue", 8)
        b = MicroBatcher(lambda batch: flushed.append(batch), clock=clock,
                         start_thread=False, **kw)
        return b, clock

    def test_deadline_flush(self):
        flushed = []
        b, clock = self._mk(flushed)
        b.submit("r1")
        assert b.tick() == 0
        clock.t = 0.009
        assert b.tick() == 0
        clock.t = 0.010  # the deadline runs from the first enqueue
        assert b.tick() == 1
        assert [r for r, _f in flushed[0]] == ["r1"]

    def test_bucket_fill_flushes_immediately(self):
        flushed = []
        b, _clock = self._mk(flushed)
        for i in range(4):
            b.submit(f"r{i}")
        assert b.tick() == 4
        assert b.depth() == 0

    def test_oversize_burst_drains_in_buckets(self):
        flushed = []
        b, clock = self._mk(flushed)
        for i in range(7):
            b.submit(f"r{i}")
        assert b.tick() == 4
        clock.t = 1.0
        assert b.tick() == 3
        assert [len(x) for x in flushed] == [4, 3]

    def test_overflow_rejects_immediately(self):
        flushed = []
        b, clock = self._mk(flushed, max_queue=2)
        f1, f2 = b.submit("a"), b.submit("b")
        f3 = b.submit("c")
        assert isinstance(f3.exception(timeout=1), QueueFull)
        assert b.rejected == 1
        assert not f1.done() and not f2.done()
        clock.t = 1.0
        assert b.tick() == 2

    def test_flush_failure_fails_that_batch_only(self):
        calls = []

        def flaky(batch):
            calls.append(batch)
            if len(calls) == 1:
                raise RuntimeError("dispatch exploded")

        clock = FakeClock()
        b = MicroBatcher(flaky, max_batch=2, window_s=0.01, max_queue=8, clock=clock,
                         start_thread=False)
        f1 = b.submit("a")
        clock.t = 1.0
        b.tick()
        assert isinstance(f1.exception(timeout=1), RuntimeError)
        b.submit("b")
        clock.t = 2.0
        b.tick()
        assert len(calls) == 2

    def test_stop_drains_pending_futures(self):
        clock = FakeClock()
        b = MicroBatcher(lambda batch: None, max_batch=4, window_s=10.0, max_queue=8,
                         clock=clock, start_thread=True)
        fut = b.submit("late")
        b.stop()
        assert isinstance(fut.exception(timeout=5), QueueFull)
        assert b.submit("after-stop").exception(timeout=1) is not None

    def test_knobs_read_from_the_environment(self, monkeypatch):
        monkeypatch.setenv("KB_WHATIF_BATCH", "7")
        monkeypatch.setenv("KB_WHATIF_WINDOW_MS", "3")
        monkeypatch.setenv("KB_WHATIF_QUEUE", "9")
        b = MicroBatcher(lambda batch: None, start_thread=False)
        assert (b.max_batch, b.window_s, b.max_queue) == (7, 0.003, 9)


# ==========================================================================
# the flush's partition, and the prewarm
# ==========================================================================


def _four_nodes():
    return port_cache(queues=[Queue(name="default", weight=1)],
                      nodes=[build_node(f"p{i}", cpu=8000, mem=16 * GiB) for i in range(4)])


class TestFlushPartitionAndPrewarm:
    BODY = {"queue": "default", "count": 1, "requests": {"cpu": 500, "memory": GiB}}

    def test_mixed_window_splits_by_evictions_flag(self, plane_factory):
        cache = _four_nodes()
        qp = plane_factory(cache, max_batch=8)
        _port_run(cache)
        plain = qp.submit(dict(self.BODY))
        evict = qp.submit(dict(self.BODY, evictions=True))
        d0 = qp.dispatches
        _tick(qp)
        r_plain, r_evict = plain.result(timeout=60), evict.result(timeout=60)
        assert qp.dispatches == d0 + 2
        assert "evictions" not in r_plain and "evictions" in r_evict
        assert r_plain["snapshot_version"] == r_evict["snapshot_version"]

    def test_uniform_window_stays_one_dispatch(self, plane_factory):
        cache = _four_nodes()
        qp = plane_factory(cache, max_batch=8)
        _port_run(cache)
        futs = [qp.submit(dict(self.BODY, requests={"cpu": 250, "memory": GiB}))
                for _ in range(4)]
        d0 = qp.dispatches
        _tick(qp)
        for f in futs:
            assert f.result(timeout=60)["feasible"]
        assert qp.dispatches == d0 + 1

    def test_cancelled_futures_skipped_at_flush(self, plane_factory):
        cache = _four_nodes()
        qp = plane_factory(cache, max_batch=8)
        _port_run(cache)
        f0 = qp.submit(dict(self.BODY))
        assert f0.cancel()
        d0 = qp.dispatches
        _tick(qp)
        assert qp.dispatches == d0, "an abandoned window must not dispatch"
        gone, live = qp.submit(dict(self.BODY)), qp.submit(dict(self.BODY))
        assert gone.cancel()
        served0 = qp.requests_served
        _tick(qp)
        assert live.result(timeout=60)["feasible"]
        assert qp.requests_served == served0 + 1

    def test_no_lease_answers_503(self, plane_factory):
        cache = _four_nodes()
        qp = plane_factory(cache, dispatch_timeout=0.05)
        fut = qp.submit(dict(self.BODY))
        _tick(qp)
        err = fut.exception(timeout=5)
        assert isinstance(err, WhatifError) and err.status == 503

    def test_failed_dispatch_fails_its_sub_batch_only(self, plane_factory, monkeypatch):
        """A raising probe fails the requests of its own sub-batch (500);
        the other sub-batch of the window is answered; nothing is retried."""
        cache = _four_nodes()
        qp = plane_factory(cache, max_batch=8)
        _port_run(cache)
        real = qp._probe
        calls = []

        def probe(lease, reqs):
            calls.append(len(reqs))
            if reqs[0]["evictions"]:
                raise RuntimeError("device fault")
            return real(lease, reqs)

        monkeypatch.setattr(qp, "_probe", probe)
        plain = qp.submit(dict(self.BODY))
        evict = qp.submit(dict(self.BODY, evictions=True))
        _tick(qp)
        assert plain.result(timeout=60)["feasible"]
        err = evict.exception(timeout=5)
        assert isinstance(err, WhatifError) and err.status == 500
        assert calls == [1, 1]

    def test_sweep_finds_the_largest_fitting_count(self, plane_factory):
        """Four 8000-cpu nodes hold 16 members of 2000 cpu: the sweep
        answers 16, against one lease, and a plain probe agrees at 16 and
        17."""
        cache = _four_nodes()
        qp = plane_factory(cache, max_batch=8)
        _port_run(cache)
        body = {"queue": "default", "requests": {"cpu": 2000, "memory": GiB}}
        fut = qp.submit_sweep(dict(body, max_count=40))
        _tick(qp)
        resp = fut.result(timeout=60)
        assert resp["max_fit"] == 16 and resp["feasible"] and resp["probes"] > 1
        assert _probe(qp, dict(body, count=16))["feasible"]
        assert not _probe(qp, dict(body, count=17))["feasible"]

    def test_prewarm_loads_the_kernel_library_off_the_request_path(
            self, plane_factory, monkeypatch):
        """The port's cold cost is the kernel library's build and load: the
        first publish on a device starts one background load, which touches
        no lease and counts no dispatch; a republish on the same device
        starts none."""
        from types import SimpleNamespace

        from kube_batch_tpu_torch.ops import _build

        loads = []
        monkeypatch.setattr(_build, "load_library", lambda: loads.append(1))
        cache = _four_nodes()
        qp = plane_factory(cache, prewarm=True)
        _port_run(cache)  # the publish on the CPU: the plain versions need no load
        assert len(qp._warm_threads) == 1
        for t in qp._warm_threads:
            t.join(timeout=30)
        assert loads == [] and qp.dispatches == 0
        lease = qp.broker.current()
        card = lease._replace(snap=SimpleNamespace(
            task_req=SimpleNamespace(device=torch.device("cuda"))))
        qp._maybe_prewarm(card)
        for t in qp._warm_threads:
            t.join(timeout=30)
        assert loads == [1] and qp.dispatches == 0
        qp._maybe_prewarm(card)
        qp._maybe_prewarm(lease)
        assert len(qp._warm_threads) <= 1 and loads == [1]
        assert _probe(qp, dict(self.BODY))["feasible"]


# ==========================================================================
# verdict honesty: per-response `unmodeled`
# ==========================================================================


DRF_TIER1_CONF = textwrap.dedent("""
    actions: "enqueue, reclaim, allocate, backfill, preempt"
    tiers:
    - plugins:
      - name: priority
      - name: gang
      - name: conformance
      - name: drf
    - plugins:
      - name: predicates
      - name: proportion
      - name: nodeorder
    """)


@pytest.mark.parametrize("leg", LEGS)
class TestUnmodeledHonesty:
    def _world(self, leg, worlds):
        return worlds(leg, queues=[Queue(name="default", weight=1)],
                      nodes=[build_node("n0", cpu=8000, mem=16 * GiB)])

    def test_shipped_conf_plain_probe_has_empty_unmodeled(self, leg, worlds):
        w = self._world(leg, worlds)
        w.run()
        assert w.probe({"queue": "default", "count": 1,
                        "requests": {"cpu": 1000, "memory": GiB}})["unmodeled"] == []

    def test_shipped_conf_eviction_probe_has_empty_unmodeled(self, leg, worlds):
        w = self._world(leg, worlds)
        w.run()
        assert w.probe({"queue": "default", "count": 1, "evictions": True,
                        "requests": {"cpu": 1000, "memory": GiB}})["unmodeled"] == []

    def test_drf_victim_gate_reported_on_eviction_probes_only(self, leg, worlds):
        w = self._world(leg, worlds)
        w.run(conf_text=DRF_TIER1_CONF)
        assert w.qp.broker.current().unmodeled_gates == ("drf",)
        with_ev = w.probe({"queue": "default", "count": 1, "evictions": True,
                           "requests": {"cpu": 1000, "memory": GiB}})
        assert any("drf" in gap for gap in with_ev["unmodeled"])
        plain = w.probe({"queue": "default", "count": 1,
                         "requests": {"cpu": 1000, "memory": GiB}})
        assert plain["unmodeled"] == []

    def test_all_best_effort_gang_reports_backfill_gap(self, leg, worlds):
        w = self._world(leg, worlds)
        w.run()
        resp = w.probe({"queue": "default", "count": 2, "requests": {}})
        assert resp["feasible"] is False and resp.get("fit_errors") == {}
        assert any("backfill" in gap.lower() for gap in resp["unmodeled"])


# ==========================================================================
# the guard's heal retires the lease
# ==========================================================================


def test_guard_trip_retires_the_lease_and_serving_resumes(plane_factory):
    """A zeroed resident capacity word trips allocate's sentinel: the heal
    drops the resident state and retires the lease published from the
    condemned snapshot, and the plane serves again after the next clean
    cycle."""
    import numpy as np

    from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Pod
    from kube_batch_tpu_torch.api.pod import PodGroup as PortPodGroup
    from kube_batch_tpu_torch.api.types import PodPhase as PortPhase

    cache = port_cache(queues=["default"],
                       nodes=[build_node(f"g{i}", cpu=8000, mem=64 * GiB) for i in range(2)])
    cache.columns.reserve(n_tasks=1024, n_nodes=64)
    qp = plane_factory(cache)

    def gang(tag):
        cache.add_pod_group(PortPodGroup(name=tag, namespace="t", min_member=2,
                                         queue="default"))
        for k in range(2):
            cache.add_pod(Pod(name=f"{tag}-{k}", namespace="t",
                              requests={"cpu": 1000.0, "memory": float(GiB)},
                              annotations={GROUP_NAME_ANNOTATION: tag},
                              phase=PortPhase.PENDING))

    gang("a")
    _port_run(cache)
    assert qp.broker.current() is not None
    cols = cache.columns
    _ver, tensor = cols._dev_cache[torch.device("cpu")]["node_alloc"]
    tensor[int(np.flatnonzero(cols.n_valid)[0])] = 0.0
    gang("b")
    retired = qp.broker.retired
    _port_run(cache)
    gp = cache.guard_plane
    assert gp.trips_total == 1 and gp.failed_closed == 1
    assert qp.broker.current() is None and qp.broker.retired > retired
    fut = qp.submit({"queue": "default", "count": 1, "requests": {"cpu": 100}})
    qp.dispatch_timeout = 0.05
    _tick(qp)
    assert fut.exception(timeout=5).status == 503
    _port_run(cache)  # the clean cycle: full upload, publish
    assert gp.trips_total == 1
    resp = _probe(qp, {"queue": "default", "count": 1, "requests": {"cpu": 100}})
    assert resp["feasible"] and resp["snapshot_version"] == qp.broker.current().version


def test_isolated_session_publishes_no_lease(plane_factory):
    """An isolated session has nothing resident: it publishes nothing."""
    cache = port_cache(queues=["default"], nodes=[build_node("s0")],
                       pod_groups=[PodGroup(name="g", namespace="c1", min_member=1,
                                            queue="default")],
                       pods=[build_pod("c1", "p0", None, PodPhase.PENDING,
                                       {"cpu": 100}, group_name="g")])
    qp = plane_factory(cache)
    ssn = open_session(cache, CONF.tiers, "cpu", isolated=True)
    try:
        get_action("allocate").execute(ssn)
    finally:
        close_session(ssn)
    cache.flush_binds()
    assert qp.broker.published == 0 and dict(cache.binder.binds) == {"c1/p0": "s0"}


def test_close_detaches_the_plane(plane_factory):
    cache = _four_nodes()
    qp = QueryPlane(cache, start_thread=False)
    assert cache.query_plane is qp and cache.columns.resident_swap_guard is not None
    qp.close()
    assert cache.query_plane is None and cache.columns.resident_swap_guard is None
    _port_run(cache)  # no plane: the cycle publishes nothing and runs
    assert qp.broker.published == 0
