"""The port's metrics and cycle spans against the JAX package's, on the CPU.

Both packages keep module-level metric registries, and the tests run in
several processes that each hold other files' series, so nothing here
reads or resets a series' absolute value: :func:`recording` logs every
write to either registry while a flow runs (the adds to each counter
series, each gauge series' sets, each histogram series' sample count,
each pruned series), and the two logs must be equal.

Per cycle, over ``test_torch_cycle.py``'s fixtures with 3 cycles of its
kubelet churn, under the built-in and the shipped conf, serially and
pipelined: each cycle's span tree (names, nesting, order and every attr
but the times) and the metric writes equal the JAX package's.  Two attrs
never match by design (ROADMAP Queue 3): the JAX package's device spans
carry ``compiles`` / ``retrace`` from its jit, which the port does not
have, and the port's resident counters carry ``bytes_shipped`` (its
staged upload's own bytes), which the JAX package's do not.  The JAX side
runs on its single-device path (``KB_SHARD=0``) beside the port's
single-device cycle, and once at its default, the sharded path on the
8-device CPU mesh, beside the port's ``Scheduler(mesh=...)`` on an 8-shard
CPU mesh (the sharded residency's churn EWMA left out of the span trees:
the JAX package's extra swap at each fit-error histogram decays it once
more, ROADMAP Queue 3).  Then the
what-if series on ``test_torch_whatif.py``'s world, the replication series
on ``test_torch_replicate.py``'s leader under the allocate-only conf, and
the transport's retry and breaker series on ``test_torch_transport.py``'s
scripts.
"""

from __future__ import annotations

import collections
import contextlib
import random

import numpy as np
import pytest

import kube_batch_tpu.k8s.transport as jax_transport
import kube_batch_tpu.metrics.metrics as jax_metrics
import kube_batch_tpu_torch.k8s.transport as port_transport
import kube_batch_tpu_torch.metrics.metrics as port_metrics
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_cycle import CONFS, FIXTURES, _assert_same, apply, kubelet, observed
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

REGISTRIES = {"jax": jax_metrics, "port": port_metrics}

#: span attrs that differ by design (module docstring)
JIT_ATTRS = ("compiles", "retrace")
PORT_ONLY_RESIDENT = ".bytes_shipped"


class SeriesLog:
    """Every write to one registry's series while :func:`recording` runs."""

    def __init__(self):
        self.adds = collections.defaultdict(float)
        self.sets = {}
        self.removes = collections.Counter()
        self.samples = collections.Counter()

    def summary(self) -> dict:
        return {"adds": dict(self.adds), "sets": dict(self.sets),
                "removes": dict(self.removes), "samples": dict(self.samples)}


@contextlib.contextmanager
def recording():
    """{"jax": SeriesLog, "port": SeriesLog} of the writes inside the
    block; the registries' classes are patched for the block only."""
    logs = {key: SeriesLog() for key in REGISTRIES}
    saved = []

    def patch(cls, name, wrap):
        saved.append((cls, name, cls.__dict__[name]))
        setattr(cls, name, wrap(cls.__dict__[name]))

    for key, mod in REGISTRIES.items():
        log = logs[key]

        def add(orig, log=log):
            def f(self, value, *labels):
                log.adds[(self.name, labels)] += value
                return orig(self, value, *labels)
            return f

        def set_(orig, log=log):
            def f(self, value, *labels):
                n, _ = log.sets.get((self.name, labels), (0, None))
                log.sets[(self.name, labels)] = (n + 1, float(value))
                return orig(self, value, *labels)
            return f

        def remove(orig, log=log):
            def f(self, *labels):
                log.removes[(self.name, labels)] += 1
                return orig(self, *labels)
            return f

        def observe_many(orig, log=log):
            def f(self, value, count, *labels):
                if count > 0:
                    log.samples[(self.name, labels)] += count
                return orig(self, value, count, *labels)
            return f

        patch(mod.Counter, "add", add)
        patch(mod.Counter, "set", set_)
        patch(mod.Counter, "remove", remove)
        patch(mod.Histogram, "observe_many", observe_many)
        if "observe_values" in mod.Histogram.__dict__:
            def observe_values(orig, log=log):
                def f(self, values, *labels):
                    log.samples[(self.name, labels)] += int(np.asarray(values).size)
                    return orig(self, values, *labels)
                return f

            patch(mod.Histogram, "observe_values", observe_values)
    try:
        yield logs
    finally:
        for cls, name, orig in reversed(saved):
            setattr(cls, name, orig)


def assert_same_series(logs, where: str = "") -> None:
    want, got = logs["jax"].summary(), logs["port"].summary()
    for kind in want:
        if want[kind] != got[kind]:
            keys = sorted(set(want[kind]) | set(got[kind]), key=repr)
            diff = [(k, want[kind].get(k), got[kind].get(k)) for k in keys
                    if want[kind].get(k) != got[kind].get(k)]
            pytest.fail(f"{where}: {kind} differ at {len(diff)} series, e.g. {diff[:4]}")


# --------------------------------------------------------------------------
# span trees
# --------------------------------------------------------------------------


def span_tree(d: dict):
    """A span's ``to_dict`` without its times and the by-design attrs."""
    attrs = {k: v for k, v in d.get("attrs", {}).items() if k not in JIT_ATTRS}
    res = {k: v for k, v in attrs.pop("resident", {}).items()
           if not k.endswith(PORT_ONLY_RESIDENT)}
    if res:
        attrs["resident"] = res
    return (d["name"], attrs, [span_tree(c) for c in d.get("children", ())])


def record_tree(rec) -> dict:
    """A cycle record's trees, its reason and its annotations (the
    decision latencies as a count: their values are times)."""
    d = rec.to_dict()
    attrs = dict(d.get("attrs", {}))
    lat = attrs.pop("decision_lat_ms", [])
    return {"reason": d["reason"], "spans": [span_tree(s) for s in d["spans"]],
            "attrs": attrs, "decisions": len(lat)}


def assert_same_trees(jcache, pcache, where: str) -> None:
    want = [record_tree(r) for r in jcache.flight_recorder.records()]
    got = [record_tree(r) for r in pcache.flight_recorder.records()]
    assert len(want) == len(got), where
    for i, (w, g) in enumerate(zip(want, got)):
        assert w == g, f"{where}: record {i}\nJAX  {w}\nport {g}"


# --------------------------------------------------------------------------
# per cycle, over the cycle fixtures
# --------------------------------------------------------------------------

#: (fixture, conf, mode): each conf and each mode on the homogeneous
#: cluster, and every other fixture but ``constraints`` once (its spans —
#: the fit-error histogram, the slow replay — come from ``overcommit`` and
#: ``host_ports`` here; its decisions are test_torch_cycle.py's)
CASES = [
    ("homogeneous", "default", "serial"), ("homogeneous", "default", "pipelined"),
    ("homogeneous", "shipped", "serial"), ("homogeneous", "shipped", "pipelined"),
    ("overcommit", "shipped", "pipelined"), ("overcommit", "default", "serial"),
    ("minres", "shipped", "serial"), ("preempt", "shipped", "serial"),
    ("gang_unmet", "default", "serial"), ("best_effort", "shipped", "pipelined"),
    ("host_ports", "default", "serial"),
]


#: one capacity for every case's axes, on both sides, so the JAX package
#: compiles each program once for the whole file
RESERVE = dict(n_tasks=1024, n_nodes=256, n_jobs=256, n_queues=4)


@pytest.mark.parametrize("fixture,conf,mode", CASES)
def test_cycle_spans_and_series_match_jax(fixture, conf, mode, monkeypatch):
    monkeypatch.setenv("KB_SHARD", "0")
    jcache, pcache = FIXTURES[fixture]()
    for cache in (jcache, pcache):
        cache.columns.reserve(**RESERVE)
    jconf, pconf = CONFS[conf]()
    jsched = JaxScheduler(jcache, conf=jconf)
    psched = Scheduler(pcache, conf=pconf, device="cpu")
    rng = np.random.default_rng(7)
    try:
        with recording() as logs:
            for cycle in range(3):
                for sched in (jsched, psched):
                    if mode == "serial":
                        sched.run_once()
                    else:
                        sched.run_once_pipelined()
                        sched.drain_pipeline()
                where = f"{fixture} {conf} {mode} cycle {cycle}"
                _assert_same(observed(jcache), observed(pcache), where)
                apply(jcache, pcache, kubelet(jcache, rng, cycle))
        assert_same_trees(jcache, pcache, f"{fixture} {conf} {mode}")
        assert_same_series(logs, f"{fixture} {conf} {mode}")
        samples = logs["port"].summary()["samples"]
        e2e = ("volcano_e2e_scheduling_latency_milliseconds", ())
        assert samples[e2e] == 3
        if mode == "pipelined":
            assert samples[("volcano_pipeline_writeback_overlap_milliseconds", ())] == 3
        stages = pcache.tracer.stage_attribution()["stages"]
        assert stages["session_open"] == 3 and stages["status_derive"] == 3
        assert pcache.tracer.retraces_attributed == 0
    finally:
        jsched.close()
        psched.close()
        jcache.stop()
        pcache.stop()


@pytest.mark.parametrize("fixture,conf,mode", [("homogeneous", "default", "serial")])
def test_sharded_cycle_spans_and_series_match_jax(fixture, conf, mode, monkeypatch):
    """The sharded cycle (the JAX package's default at these capacities,
    the port's on its mesh): span trees and metric writes equal.  The JAX
    package's sharded programs are dropped after it, so this worker's
    compiled executables do not pile up (``test_torch_sim_parity``'s
    module docstring has why)."""
    import gc

    import jax

    from kube_batch_tpu_torch.parallel.mesh import make_mesh
    from test_torch_shard_cycle import _solve_spans as sharded_spans
    from test_torch_shard_cycle import assert_same_trees as assert_same_sharded_trees

    monkeypatch.delenv("KB_SHARD", raising=False)
    # no residency on either side: the JAX package's sharded cache compiles
    # a scatter per slot bucket and field shape at its first upload, and
    # the residency's spans are test_torch_shard_cycle.py's
    monkeypatch.setenv("KB_DEVICE_CACHE", "0")
    jcache, pcache = FIXTURES[fixture]()
    for cache in (jcache, pcache):
        cache.columns.reserve(**RESERVE)
    jconf, pconf = CONFS[conf]()
    jsched = JaxScheduler(jcache, conf=jconf)
    psched = Scheduler(pcache, conf=pconf, device="cpu", mesh=make_mesh(["cpu"] * 8))
    rng = np.random.default_rng(7)
    try:
        with recording() as logs:
            for cycle in range(3):
                for sched in (jsched, psched):
                    if mode == "serial":
                        sched.run_once()
                    else:
                        sched.run_once_pipelined()
                        sched.drain_pipeline()
                where = f"sharded {fixture} {conf} {mode} cycle {cycle}"
                _assert_same(observed(jcache), observed(pcache), where)
                apply(jcache, pcache, kubelet(jcache, rng, cycle))
        assert_same_sharded_trees(jcache, pcache, f"sharded {fixture}")
        assert_same_series(logs, f"sharded {fixture}")
        assert sharded_spans(pcache) and sharded_spans(jcache) == sharded_spans(pcache)
    finally:
        jsched.close()
        psched.close()
        jcache.stop()
        pcache.stop()
        jax.clear_caches()
        gc.collect()


# --------------------------------------------------------------------------
# the read plane, replication and the transport
# --------------------------------------------------------------------------


def test_whatif_series_match_jax(worlds):
    """Feasible and infeasible probes and a sweep on both planes:
    the same ``volcano_whatif_*`` writes (verdicts, dispatches, batch
    sizes, latencies, sweeps, the lease's version)."""
    from kube_batch_tpu.api.types import PodPhase  # noqa: F401 — the world's objects
    from test_torch_whatif import _heterogeneous, _probe

    with recording() as logs:
        w = _heterogeneous("jax", worlds)
        w.run()
        for body in ({"queue": "default", "count": 3,
                      "requests": {"cpu": 1500, "memory": 2 << 30}},
                     {"queue": "default", "count": 2,
                      "requests": {"cpu": 64000, "memory": 1 << 30}}):
            w.probe(body)
        sweep = {"queue": "default", "max_count": 8,
                 "requests": {"cpu": 1000, "memory": 1 << 30}}
        fut_p, fut_j = w.qp.submit_sweep(sweep), w.jqp.submit_sweep(sweep)
        for qp in (w.qp, w.jqp):
            qp.batcher.tick(now=qp.batcher.clock.monotonic() + 1e6)
        assert fut_p.result(timeout=60) == fut_j.result(timeout=60)
        assert _probe(w.qp, {"queue": "default", "count": 1,
                             "requests": {"cpu": 100}})["feasible"]
        _probe(w.jqp, {"queue": "default", "count": 1, "requests": {"cpu": 100}})
    assert_same_series(logs, "whatif")
    port = logs["port"].summary()
    assert port["adds"][("volcano_whatif_requests_total", ("infeasible",))] == 1
    assert port["adds"][("volcano_whatif_sweeps_total", ())] == 1
    assert port["samples"][("volcano_whatif_request_latency_milliseconds", ())] == 4


@pytest.fixture
def worlds():
    from test_torch_whatif import World

    made = []

    def make(leg, **kw):
        w = World(leg, **kw)
        made.append(w)
        return w

    yield make
    for w in made:
        w.close()


def test_replication_series_match_jax():
    """Six churn cycles under the allocate-only conf, where both leaders
    publish once a cycle, and each package's follower applying every
    frame, a dropped one among them: the same record, byte, applied,
    resync, lag and snapshot-version writes.  Under the shipped conf the
    port publishes at every swap (ROADMAP Queue 3), so its record counts
    are its own there."""
    from kube_batch_tpu.replicate.follower import FollowerApplier as JaxApplier
    from kube_batch_tpu.replicate.follower import FollowerCache as JaxFollowerCache
    from kube_batch_tpu.replicate.publisher import ReplicationPublisher as JaxPublisher
    from kube_batch_tpu.serve.plane import QueryPlane as JaxPlane
    from kube_batch_tpu_torch.replicate.follower import FollowerApplier, FollowerCache
    from kube_batch_tpu_torch.serve.plane import QueryPlane
    from fixtures import build_cache
    from test_replication import _run as jax_run
    from test_torch_cycle import mirror
    from test_torch_replicate import Leader, _churn_objects, _leader_objects, encode_at_capture

    objects = _leader_objects()
    closers = []
    try:
        with recording() as logs:
            jcache = build_cache(**objects)
            jqp = JaxPlane(jcache, start_thread=False)
            jcache.replication = jpub = encode_at_capture(JaxPublisher())
            closers += [jpub.close, jqp.close, jcache.stop]
            ld = Leader(objects=objects)
            closers.append(ld.close)
            jax_run(jcache)
            jpub.barrier()
            fj = JaxApplier(JaxFollowerCache(), JaxPlane(JaxFollowerCache(), start_thread=False))
            fp = FollowerApplier(FollowerCache(), QueryPlane(FollowerCache(), start_thread=False),
                                 device="cpu")
            closers += [fj.qp.close, fp.qp.close]
            for i in range(6):
                pg, pod = _churn_objects(i)
                jcache.add_pod_group(pg)
                jcache.add_pod(pod)
                ld.cache.add_pod_group(mirror(pg))
                ld.cache.add_pod(mirror(pod))
                jax_run(jcache)
                jpub.barrier()
                ld.cycle()
                if i == 3:
                    continue  # the followers sit this cycle out
                for key, pub, f in (("jax", jpub, fj), ("port", ld.pub, fp)):
                    # pull until caught up (a heartbeat); after the sit-out
                    # cycle the first frame pulled is lost, so the next
                    # delta is refused and a full frame asked for
                    lost = int(i == 4)
                    outs = []
                    while not outs or outs[-1] != "heartbeat":
                        since = -1 if outs and outs[-1] == "resync" else f.applied_seq + lost
                        lost = 0
                        outs.append(f.apply(pub.record_for(since)))
                    assert "applied" in outs, (key, i, outs)
        assert_same_series(logs, "replication")
        port = logs["port"].summary()
        assert port["adds"][("volcano_replication_resyncs_total", ())] == 1
        assert port["adds"][("volcano_replication_applied_total", ("full",))] == 2
    finally:
        for close in reversed(closers):
            close()


def test_transport_series_match_jax():
    """The retry loop's scripts and a breaker's open / half-open / closed
    walk, through both modules: the same retry and breaker writes."""
    from test_torch_transport import http_error, make_transport

    def run(m):
        t = make_transport(m, breaker=m.CircuitBreaker(
            threshold=2, cooldown=5.0, clock=lambda: clock[0], name="metrics-t"))
        for errors in ([ConnectionRefusedError()] * 2, [http_error(429)],
                       [http_error(503)], [http_error(404)]):
            calls = []

            def fn(errors=errors, calls=calls):
                calls.append(1)
                if len(calls) <= len(errors):
                    raise errors[len(calls) - 1]
                return "ok"

            try:
                t._call("read", fn)
            except Exception:  # noqa: BLE001 — the fatal script raises
                pass
        clock[0] = 0.0
        b = t.breaker
        b.record_failure()
        b.record_failure()   # open
        clock[0] = 6.0
        b.allow()            # half-open
        b.record_success()   # closed
        return dict(b.transitions)

    with recording() as logs:
        out = []
        for m in (jax_transport, port_transport):
            clock = [0.0]
            random.seed(0)
            out.append(run(m))
    assert out[0] == out[1]
    assert_same_series(logs, "transport")
    port = logs["port"].summary()
    assert port["adds"][("volcano_transport_retries_total", ("read", "transient"))] == 2
    assert port["sets"][("volcano_circuit_breaker_open", ("metrics-t",))] == (3, 0.0)
