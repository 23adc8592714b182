"""The port's sharded scheduling cycle against the JAX package's default
sharded cycle.

Each of ``test_torch_cycle``'s eight fixtures is built in a JAX cache and
a port cache from the same events, both with capacities reserved so the
node axis pads to 256 rows (``SHARD_MIN_NODES``).  The JAX side runs at
its defaults, which on the tests' 8-device CPU mesh is its sharded path;
the port runs ``Scheduler(mesh=...)`` over an 8-shard CPU mesh.  Under the
shipped five-action conf, two cycles with the same kubelet churn
between them (the second compacted and warm where the fixture allows;
each cycle is one more set of the JAX package's sharded compiles): binds, evictions, every task's status, the PodGroups and
the queue statuses after every cycle, and at the end every cycle's span
tree (``mode="sharded"``, ``engaged`` led by ``shard_map``) must be equal,
but for the residency's churn EWMA (:func:`_no_ewma`).
Then a capacity word planted into the sharded residency must trip both
guards alike: the sharded path fails closed, ``shard_map`` is demoted
with the other engaged paths, the next cycles run the ``"pjit"`` oracle,
and after the cooldown the half-open probe re-promotes it."""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu.guard import guard_of as jax_guard_of
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.guard import guard_of as port_guard_of
from kube_batch_tpu_torch.parallel import mesh as pm
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_cycle import CONFS, FIXTURES, _assert_same, apply, kubelet, observed
from test_torch_metrics import record_tree
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

#: one capacity for every fixture, on both sides: the node axis pads to
#: 256 rows, past the JAX package's shard gate
RESERVE = dict(n_tasks=1024, n_nodes=256, n_jobs=256, n_queues=4)
MESH = pm.make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """The JAX package's compile caches cleared before and after the module
    (``test_torch_sim_parity``'s docstring has why), and one torch thread
    for the module: the suite runs in several workers at once, and the
    shard loops' small ops gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()
    torch.set_num_threads(threads)


def _pair(fixture, conf="shipped"):
    jcache, pcache = FIXTURES[fixture]()
    for cache in (jcache, pcache):
        cache.columns.reserve(**RESERVE)
    jconf, pconf = CONFS[conf]() if conf in CONFS else _allocate_only()
    return (jcache, pcache, JaxScheduler(jcache, conf=jconf),
            Scheduler(pcache, conf=pconf, device="cpu", mesh=MESH))


def _allocate_only():
    """The shipped tiers with allocate alone: the what-if lease is then
    allocate's in both packages (the port re-arms it after every later
    swap, the JAX package on the CPU does not: ROADMAP Queue 3)."""
    from kube_batch_tpu.framework.conf import parse_scheduler_conf as jax_parse
    from kube_batch_tpu_torch.framework.conf import parse_scheduler_conf, shipped_conf_path

    with open(shipped_conf_path()) as f:
        text = f.read().replace('"enqueue, reclaim, allocate, backfill, preempt"', '"allocate"')
    return jax_parse(text), parse_scheduler_conf(text)


def _no_ewma(tree):
    """A span tree without the sharded residency's ``churn_ewma``: the JAX
    package's fit-error histogram dispatch re-swaps (ROADMAP Queue 3), and
    on its sharded cache every swap decays the EWMA once more."""
    name, attrs, children = tree
    attrs = dict(attrs)
    if "resident" in attrs:
        attrs["resident"] = {k: v for k, v in attrs["resident"].items()
                             if k != "sharded.churn_ewma"}
    return name, attrs, [_no_ewma(c) for c in children]


def assert_same_trees(jcache, pcache, where: str) -> None:
    want = [record_tree(r) for r in jcache.flight_recorder.records()]
    got = [record_tree(r) for r in pcache.flight_recorder.records()]
    assert len(want) == len(got), where
    for i, (w, g) in enumerate(zip(want, got)):
        for d in (w, g):
            d["spans"] = [_no_ewma(s) for s in d["spans"]]
        assert w == g, f"{where}: record {i}\nJAX  {w}\nport {g}"


def _solve_spans(cache):
    """(mode, engaged) of every allocate solve_dispatch span recorded."""
    out = []
    for rec in cache.flight_recorder.records():
        stack = list(rec.to_dict()["spans"])
        while stack:
            s = stack.pop()
            attrs = s.get("attrs", {})
            if s["name"] == "solve_dispatch" and "mode" in attrs:
                out.append((attrs["mode"], tuple(attrs.get("engaged", ()))))
            stack.extend(s.get("children", ()))
    return out


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_sharded_cycles_match_jax(fixture):
    jcache, pcache, jsched, psched = _pair(fixture)
    alloc = next(a for a in psched.actions if a.name == "allocate")
    rng = np.random.default_rng(7)
    modes = []
    try:
        for cycle in range(2):
            jsched.run_once()
            psched.run_once()
            where = f"{fixture} cycle {cycle}"
            _assert_same(observed(jcache), observed(pcache), where)
            assert pcache.columns.check_consistency(pcache) == [], where
            modes.append(alloc.last_solve_mode)
            apply(jcache, pcache, kubelet(jcache, rng, cycle))
        assert_same_trees(jcache, pcache, fixture)
        spans = _solve_spans(pcache)
        assert spans and all(m == "sharded" and e[0] == "shard_map" for m, e in spans), spans
        assert "sharded" in modes
        assert set(pcache.columns.resident_counters()) == {"sharded"}
    finally:
        jsched.close()
        psched.close()
        jcache.stop()
        pcache.stop()


def _plant_capacity_word(jcache, pcache) -> None:
    """Zero a live node's allocatable in both packages' sharded feature
    residency (the port's shard tensor in place; the JAX package's sharded
    array replaced)."""
    jcols, pcols = jcache.columns, pcache.columns
    jmesh = next(k for k in jcols._dev_cache if k is not None)
    ver, arr = jcols._dev_cache[jmesh]["node_alloc"]
    host = np.array(jax.device_get(arr))
    live = int(np.flatnonzero(np.asarray(jcols.n_valid))[0])
    host[live] = 0.0
    jcols._dev_cache[jmesh]["node_alloc"] = (ver, jax.device_put(host, arr.sharding))
    prow = int(np.flatnonzero(pcols.n_valid)[0])
    assert prow == live
    _ver, _shape, placed = pcols._dev_cache[MESH]["node_alloc"]
    s = RESERVE["n_nodes"] // MESH.node_shards
    placed[(MESH.device(0, prow // s), prow // s)][prow % s] = 0.0


def test_sharded_trip_demotes_shard_map_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("KB_GUARD_COOLDOWN", "1")
    jcache, pcache, jsched, psched = _pair("homogeneous")
    for cache, attach in ((jcache, jax_guard_of), (pcache, port_guard_of)):
        attach(cache).bundle_dir = str(tmp_path / type(cache).__module__)
    jg, pg = jcache.guard_plane, pcache.guard_plane
    rng = np.random.default_rng(3)

    def cycle(c):
        jsched.run_once()
        psched.run_once()
        _assert_same(observed(jcache), observed(pcache), f"cycle {c}")
        assert ({k: v.state for k, v in pg.paths.items()}
                == {k: v.state for k, v in jg.paths.items()}), c
        assert (pg.trips_total, pg.failed_closed) == (jg.trips_total, jg.failed_closed), c
        apply(jcache, pcache, kubelet(jcache, rng, c))

    try:
        cycle(0)
        _plant_capacity_word(jcache, pcache)
        cycle(1)
        assert pg.trips_total >= 1 and pg.paths["shard_map"].state == "demoted"
        assert [t["demoted"] for t in pg.trip_log] == [t["demoted"] for t in jg.trip_log]
        assert any("shard_map" in t["demoted"] for t in pg.trip_log)
        # demoted: the next solves run the pjit oracle, not the shard bodies
        cycle(2)
        spans = _solve_spans(pcache)
        assert spans[-1][0] == "sharded" and "shard_map" not in spans[-1][1]
        for c in range(3, 5):
            cycle(c)
        assert pg.paths["shard_map"].state == jg.paths["shard_map"].state == "healthy"
        assert pg.paths["shard_map"].promotions == jg.paths["shard_map"].promotions >= 1
        assert _solve_spans(pcache)[-1][1][:1] == ("shard_map",)
    finally:
        jsched.close()
        psched.close()
        jcache.stop()
        pcache.stop()


def test_traced_collective_bytes_match_jax(monkeypatch):
    """``KB_TRACE_COLLECTIVES=1``: each sharded allocate dispatch span
    carries the solve's collective bytes per round and per solve, equal to
    the JAX package's (the whole span trees are compared)."""
    monkeypatch.setenv("KB_TRACE_COLLECTIVES", "1")
    jcache, pcache, jsched, psched = _pair("homogeneous")
    rng = np.random.default_rng(11)
    try:
        for cycle in range(2):
            jsched.run_once()
            psched.run_once()
            apply(jcache, pcache, kubelet(jcache, rng, cycle))
        assert_same_trees(jcache, pcache, "traced collectives")
        annotated = []
        for rec in pcache.flight_recorder.records():
            stack = list(rec.to_dict()["spans"])
            while stack:
                s = stack.pop()
                if "collective_bytes" in s.get("attrs", {}):
                    annotated.append(s["attrs"]["collective_bytes"])
                stack.extend(s.get("children", ()))
        # both cycles run the compacted solve: no per-round bytes
        assert len(annotated) == 2
        assert all(a["per_solve_bytes"] > 0 and a["per_round_bytes"] == 0 for a in annotated)
    finally:
        jsched.close()
        psched.close()
        jcache.stop()
        pcache.stop()


def test_sharded_whatif_answers_match_jax():
    """A lease published by a sharded cycle holds the mesh, and its probes
    (K1 per shard at the probe's rows, the eviction bids per shard) answer
    as the JAX package's sharded probe does, response for response."""
    from kube_batch_tpu.serve.plane import QueryPlane as JaxPlane
    from kube_batch_tpu_torch.serve.plane import QueryPlane
    from test_torch_whatif import _probe

    jcache, pcache, jsched, psched = _pair("preempt", conf="allocate")
    jqp, pqp = JaxPlane(jcache, start_thread=False), QueryPlane(pcache, start_thread=False)
    try:
        jsched.run_once()
        psched.run_once()
        assert pqp.broker.current().mesh == MESH
        queue = sorted(jcache.queues)[0]
        for body in ({"queue": queue, "count": 3, "requests": {"cpu": 1500, "memory": 2 << 30}},
                     {"queue": queue, "count": 2, "requests": {"cpu": 64000}},
                     {"queue": queue, "count": 2, "evictions": True,
                      "requests": {"cpu": 4000, "memory": 1 << 30}}):
            assert _probe(pqp, body) == _probe(jqp, body), body
    finally:
        pqp.close()
        jqp.close()
        jsched.close()
        psched.close()
        jcache.stop()
        pcache.stop()
