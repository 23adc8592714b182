"""The port's HTTP server (``kube_batch_tpu_torch/cmd/server.py``) against
the JAX package's, response for response, on the CPU.

One JAX ``AdminServer`` over a JAX cache and ``Scheduler`` and one port
``AdminServer`` over a port cache and ``Scheduler(device="cpu")``, each on
port 0 with a query plane (its batcher thread on) and a replication
publisher, are sent the same HTTP sequence: single and list-body ingest
of every kind, an upsert re-POST, a malformed batch rejected wholesale,
DELETEs, 404s and ``/v1/sync``; cycles driven by ``run_once`` on each
side; what-ifs and a sweep (feasible, infeasible, with evictions, and
validation errors); a planted guard trip.  The responses are then
compared: byte for byte for the JSON and text endpoints and the what-if
answers, by series for ``/metrics`` (deltas over the flow; the values of
series that are times are left out, their sample counts are not), by span
tree for ``/v1/trace``, by keys and counts for ``/v1/guard``, and byte for
byte for every ``/v1/replicate?since=N`` frame under the allocate-only
conf (under the shipped conf the port publishes a record at every swap,
ROADMAP Queue 3).  Then the egress token bucket's rate and sharing, as
``tests/test_server.py`` checks the JAX package's.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
from kube_batch_tpu.api import serialize as jax_serialize
from kube_batch_tpu.api.pod import (
    Affinity,
    PodGroup,
    PriorityClass,
    Queue,
    Taint,
    Toleration,
)
from kube_batch_tpu.api.types import PodPhase
from kube_batch_tpu_torch import actions as _port_actions  # noqa: F401 — registers
from kube_batch_tpu_torch import plugins as _port_plugins  # noqa: F401 — registers
from kube_batch_tpu_torch.api import serialize as port_serialize
from fixtures import GiB, build_node, build_pod
from test_torch_cycle import mirror
from test_torch_metrics import recording, span_tree
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

#: allocate only, over the built-in tiers: both leaders publish one record
#: a cycle, so the frames compare byte for byte
ALLOCATE_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

#: records each leader has published after the two cycles before the
#: planted trip: one a cycle under the allocate-only conf (the trip's heal
#: retires the port's lease, a deliberate difference, so the frames are
#: read before it)
HEAD = 2

#: the planes' lease wait once a lease exists: a handler waits this plus
#: 8 s for its answer, and the JAX package's first eviction probe compiles
#: inside that wait (seconds on a loaded machine)
LEASE_WAIT_S = 120.0

TIME_SERIES = re.compile(r"_(milliseconds|microseconds)(_bucket|_sum)?$")

FEASIBLE = {"queue": "default", "count": 2, "requests": {"cpu": 1000, "memory": GiB}}
INFEASIBLE = {"queue": "default", "count": 2, "requests": {"cpu": 900000}}
EVICTING = {"queue": "default", "count": 1, "priority": 100, "evictions": True,
            "requests": {"cpu": 4000, "memory": GiB}}
SWEEP = {"queue": "default", "max_count": 16, "requests": {"cpu": 1000, "memory": GiB}}
INVALID = [{"queue": "default", "count": 0}, {"queue": "default", "count": "x"},
           {"queue": "default", "count": 1, "requests": {"cpu": "lots"}},
           {"queue": "nowhere", "count": 1, "requests": {"cpu": 100}}, [1, 2]]


# --------------------------------------------------------------------------
# HTTP helpers
# --------------------------------------------------------------------------


def http(port: int, method: str, path: str, body=None, raw: bytes = None):
    """(status, content type, body bytes) of one request; error statuses
    are returned, not raised."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def parse_prometheus(text: str):
    """({series: value}, {metric name: type}) of an exposition."""
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)", text, re.M))
    values = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            values[key] = float(value)
    return values, types


# --------------------------------------------------------------------------
# the two servers
# --------------------------------------------------------------------------


class Side:
    """One package's server: cache, scheduler, plane, publisher, listener."""

    def __init__(self, pkg: str, tmp):
        if pkg == "jax":
            from kube_batch_tpu.cache.cache import SchedulerCache
            from kube_batch_tpu.cache.volume import StandalonePVBinder
            from kube_batch_tpu.cmd.server import AdminServer
            from kube_batch_tpu.framework.conf import parse_scheduler_conf
            from kube_batch_tpu.obs.trace import tracer_of
            from kube_batch_tpu.replicate.publisher import ReplicationPublisher
            from kube_batch_tpu.scheduler import Scheduler
            from kube_batch_tpu.serve.plane import QueryPlane

            kw = {}
        else:
            from kube_batch_tpu_torch.cache.cache import SchedulerCache
            from kube_batch_tpu_torch.cache.volume import StandalonePVBinder
            from kube_batch_tpu_torch.cmd.server import AdminServer
            from kube_batch_tpu_torch.framework.conf import parse_scheduler_conf
            from kube_batch_tpu_torch.obs.trace import tracer_of
            from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher
            from kube_batch_tpu_torch.scheduler import Scheduler
            from kube_batch_tpu_torch.serve.plane import QueryPlane

            kw = {"device": "cpu"}

        from test_torch_replicate import encode_at_capture

        self.pkg = pkg
        # the PV ledger behind /v1/persistentvolumes, as the standalone run
        self.cache = SchedulerCache(volume_binder=StandalonePVBinder())
        self.sched = Scheduler(self.cache, conf=parse_scheduler_conf(ALLOCATE_CONF), **kw)
        # a what-if before the first lease waits out this lease wait; the
        # flow lengthens it once a lease exists (``LEASE_WAIT_S``)
        self.qp = QueryPlane(self.cache, window_s=0.001, dispatch_timeout=1.0)
        # each encode joined as its publish returns, on both sides: the JAX
        # publisher reads live columns on its worker (a tear otherwise,
        # ROADMAP Queue 3), and either's ``replicate_encode`` span then lands
        # in its own cycle's record whatever the machine's load
        self.cache.replication = self.pub = encode_at_capture(
            ReplicationPublisher(tracer=tracer_of(self.cache)))
        # each side's flight dumps in a directory of its own
        self.cache.flight_recorder.directory = str(tmp / pkg)
        self.admin = AdminServer(self.cache, port=0, query_plane=self.qp)
        self.admin.start()

    def call(self, method, path, body=None, raw=None):
        return http(self.admin.port, method, path, body, raw)

    def cycle(self):
        self.sched.run_once()
        self.pub.barrier()

    def close(self):
        self.admin.stop()
        self.qp.close()
        self.pub.close()
        self.sched.close()
        self.cache.stop()


def _cluster():
    """Objects sent as JSON to both servers: three queues (one deleted
    later), six nodes (one tainted and labelled), a low-priority running
    gang with a pod on every node, and pending gangs of two in both
    queues (one member tolerating the taint, one with node affinity)."""
    nodes = [build_node(f"n{i}", cpu=8000, mem=16 * GiB, pods=32) for i in range(6)]
    nodes[5].taints = [Taint(key="dedicated", value="infra", effect="NoSchedule")]
    nodes[5].labels = {"zone": "b"}
    running = [build_pod("c1", f"r{i}", f"n{i}", PodPhase.RUNNING,
                         {"cpu": 5000, "memory": 4 * GiB}, group_name="run0")
               for i in range(6)]
    running[5].tolerations = [Toleration(key="dedicated", operator="Exists")]
    pgs = [PodGroup(name="run0", namespace="c1", min_member=1, queue="default")]
    pending = []
    for g in range(4):
        q = "default" if g % 2 == 0 else "q1"
        pgs.append(PodGroup(name=f"g{g}", namespace="c1", min_member=2, queue=q,
                            creation_index=10 + g))
        for k in range(2):
            pod = build_pod("c1", f"g{g}-{k}", None, PodPhase.PENDING,
                            {"cpu": 1000 + 250 * g, "memory": GiB}, group_name=f"g{g}")
            pod.creation_index = 100 + 10 * g + k
            pending.append(pod)
    pending[0].tolerations = [Toleration(key="dedicated", operator="Exists")]
    pending[1].affinity = Affinity(node_terms=[[("zone", "In", ("b",))]])
    return dict(
        queues=[Queue(name="default", weight=1), Queue(name="q1", weight=2),
                Queue(name="gone", weight=1)],
        priorityclasses=[PriorityClass(name="high", value=1000)],
        nodes=nodes, podgroups=pgs, running=running, pending=pending,
    )


def _dicts(kind, objs):
    to = {"queues": jax_serialize.queue_to_dict, "nodes": jax_serialize.node_to_dict,
          "podgroups": jax_serialize.pod_group_to_dict}.get(kind, jax_serialize.pod_to_dict)
    return [to(o) for o in objs]


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """Drive both servers through the same sequence; every response is
    recorded as {step: (status, content type, bytes)} per side."""
    tmp = tmp_path_factory.mktemp("server")
    mp = pytest.MonkeyPatch()
    mp.setenv("KB_TRACE_POST", "1")
    mp.setenv("KB_ALERT_GUARD_TRIPS", "1")
    sides = {}
    try:
        for pkg in ("jax", "port"):
            sides[pkg] = Side(pkg, tmp)
        out = {pkg: {} for pkg in sides}
        metrics_before = {pkg: s.call("GET", "/metrics")[2].decode()
                          for pkg, s in sides.items()}

        def both(step, method, path, body=None, raw=None):
            for pkg, s in sides.items():
                out[pkg][step] = s.call(method, path, body, raw)

        objs = _cluster()
        with recording() as logs:
            # single and list bodies of every kind
            both("queue_single", "POST", "/v1/queues", _dicts("queues", objs["queues"][:1])[0])
            both("queue_list", "POST", "/v1/queues", _dicts("queues", objs["queues"][1:]))
            both("priorityclass", "POST", "/v1/priorityclasses",
                 {"name": "high", "value": 1000})
            both("nodes", "POST", "/v1/nodes", _dicts("nodes", objs["nodes"]))
            both("podgroups", "POST", "/v1/podgroups", _dicts("podgroups", objs["podgroups"]))
            both("running", "POST", "/v1/pods", _dicts("pods", objs["running"]))
            pend = _dicts("pods", objs["pending"])
            both("pod_single", "POST", "/v1/pods", pend[0])
            both("pods_list", "POST", "/v1/pods", pend[1:])
            # an upsert re-POST: the same pod with another request
            both("upsert", "POST", "/v1/pods", dict(pend[7], requests={"cpu": 1700.0,
                                                                      "memory": float(GiB)}))
            both("pdb", "POST", "/v1/poddisruptionbudgets",
                 {"name": "pdb0", "namespace": "c2", "min_available": 1, "owner": "o1"})
            both("pv", "POST", "/v1/persistentvolumes", [{"name": "pv0", "node": "n1"},
                                                          {"name": "pv1"}])
            # a malformed batch is rejected wholesale; a malformed single 400s
            extra = _dicts("pods", [build_pod("c1", "never", None, PodPhase.PENDING,
                                              {"cpu": 100})])
            both("malformed_batch", "POST", "/v1/pods", extra + [{"bogus_field": 1}])
            both("malformed_single", "POST", "/v1/pods", {"bogus_field": 1})
            both("bad_json", "POST", "/v1/nodes", raw=b"{not json")
            # deletes, single and list; 404s
            both("delete_queue", "DELETE", "/v1/queues", {"name": "gone"})
            both("delete_pdb", "DELETE", "/v1/poddisruptionbudgets",
                 {"name": "pdb0", "namespace": "c2", "min_available": 1, "owner": "o1"})
            both("delete_pv", "DELETE", "/v1/persistentvolumes", [{"name": "pv0"}])
            both("unknown_kind", "POST", "/v1/widgets", {})
            both("unknown_delete", "DELETE", "/v1/widgets", {})
            both("unknown_get", "GET", "/v1/nothing")
            both("sync", "POST", "/v1/sync", {})
            for s in sides.values():
                assert s.cache.wait_for_cache_sync(0)
            both("whatif_before_lease", "POST", "/v1/whatif", FEASIBLE)
            for s in sides.values():
                s.cycle()
                s.qp.dispatch_timeout = LEASE_WAIT_S
            for step in ("queues", "jobs", "bindings", "healthz", "version", "alerts"):
                both(f"{step}_1", "GET", f"/v1/{step}" if step not in ("healthz", "version")
                     else f"/{step}")
            both("whatif_feasible", "POST", "/v1/whatif", FEASIBLE)
            both("whatif_infeasible", "POST", "/v1/whatif", INFEASIBLE)
            both("whatif_evicting", "POST", "/v1/whatif", EVICTING)
            both("whatif_sweep", "POST", "/v1/whatif/sweep", SWEEP)
            for i, body in enumerate(INVALID):
                both(f"whatif_invalid_{i}", "POST", "/v1/whatif", body)
            both("whatif_bad_json", "POST", "/v1/whatif", raw=b"[")
            both("sweep_invalid", "POST", "/v1/whatif/sweep", {"queue": "default",
                                                               "max_count": 0})
            # a delete of a pending pod (a list body) and a second cycle
            both("delete_pods", "DELETE", "/v1/pods", pend[6:7])
            for s in sides.values():
                s.cycle()
            for step in ("queues", "jobs", "bindings"):
                both(f"{step}_2", "GET", f"/v1/{step}")
            both("trace", "GET", "/v1/trace")
            head = {pkg: s.pub.counters()["head_seq"] for pkg, s in sides.items()}
            assert head["jax"] == head["port"] == HEAD
            for since in range(-1, HEAD + 2):
                both(f"replicate_{since}", "GET", f"/v1/replicate?since={since}")
            both("replicate_bad", "GET", "/v1/replicate?since=x")
            both("dumps_empty", "GET", "/v1/trace/dumps")
        metrics_after = {pkg: s.call("GET", "/metrics")[2].decode()
                         for pkg, s in sides.items()}
        # a planted guard trip: the next cycle fires the alert and the
        # flight recorder writes its dump (KB_TRACE_POST=1)
        for s in sides.values():
            s.cache.guard_plane.trip("allocate", ["topk"], reason="invariant",
                                     detail="planted")
            s.cycle()
        both("alerts_tripped", "GET", "/v1/alerts")
        both("guard", "GET", "/v1/guard")
        both("dumps", "GET", "/v1/trace/dumps")
        for pkg, s in sides.items():
            names = json.loads(out[pkg]["dumps"][2])["dumps"]
            for f in ("meta.json", "trace.json"):
                out[pkg][f"dump_{f}"] = s.call("GET", f"/v1/trace/dumps/{names[0]}/{f}")
            out[pkg]["dump_escape"] = s.call("GET", f"/v1/trace/dumps/{names[0]}/../x")
            out[pkg]["dump_unknown"] = s.call("GET", "/v1/trace/dumps/nope/meta.json")
        yield dict(out=out, logs=logs, before=metrics_before, after=metrics_after,
                   sides=sides)
    finally:
        for s in sides.values():
            s.close()
        mp.undo()


def _same(flow, *steps):
    for step in steps:
        want, got = flow["out"]["jax"][step], flow["out"]["port"][step]
        assert got == want, f"{step}:\nJAX  {want}\nport {got}"


# --------------------------------------------------------------------------
# byte for byte
# --------------------------------------------------------------------------


def test_ingest_responses_match_jax(flow):
    steps = ["queue_single", "queue_list", "priorityclass", "nodes", "podgroups",
             "running", "pod_single", "pods_list", "upsert", "pdb", "pv"]
    _same(flow, *steps)
    out = flow["out"]["port"]
    assert all(out[step][0] == 200 for step in steps), {k: out[k] for k in steps}
    assert json.loads(out["pods_list"][2]) == {"ok": True, "applied": 7}
    assert json.loads(out["pod_single"][2]) == {"ok": True}


def test_rejections_and_404s_match_jax(flow):
    _same(flow, "malformed_batch", "malformed_single", "bad_json", "unknown_kind",
          "unknown_delete", "unknown_get")
    out = flow["out"]["port"]
    assert out["malformed_batch"][0] == 400 and out["unknown_kind"][0] == 404
    assert out["unknown_get"][0] == 404
    cache = flow["sides"]["port"].cache
    assert "c1/never" not in cache.pods  # the whole batch parsed before any applied


def test_deletes_and_sync_match_jax(flow):
    steps = ("delete_queue", "delete_pdb", "delete_pv", "delete_pods", "sync")
    _same(flow, *steps)
    assert all(flow["out"]["port"][step][0] == 200 for step in steps)
    for side in flow["sides"].values():
        assert "gone" not in side.cache.queues
        assert "c1/g3-0" not in side.cache.pods


@pytest.mark.parametrize("step", ["queues_1", "jobs_1", "bindings_1", "healthz_1",
                                  "version_1", "queues_2", "jobs_2", "bindings_2"])
def test_read_endpoints_match_jax(flow, step):
    _same(flow, step)
    assert flow["out"]["port"][step][0] == 200


def test_bindings_hold_the_first_cycles_decisions(flow):
    rows = json.loads(flow["out"]["port"]["bindings_1"][2])
    placed = {r["pod"] for r in rows if r["status"] == "BINDING"}
    assert len(placed) >= 4, rows
    assert flow["out"]["port"]["version_1"][2] == b"kube-batch-tpu 0.1.0 (dev)"


@pytest.mark.parametrize("step", ["whatif_before_lease", "whatif_feasible",
                                  "whatif_infeasible", "whatif_evicting", "whatif_sweep",
                                  "whatif_bad_json", "sweep_invalid"]
                         + [f"whatif_invalid_{i}" for i in range(len(INVALID))])
def test_whatif_answers_match_jax(flow, step):
    _same(flow, step)


def test_whatif_verdicts_cover_every_kind(flow):
    out = {k: (v[0], json.loads(v[2])) for k, v in flow["out"]["port"].items()
           if k.startswith(("whatif", "sweep"))}
    assert out["whatif_before_lease"][0] == 503
    assert out["whatif_feasible"][1]["feasible"] is True
    assert out["whatif_infeasible"][1]["feasible"] is False
    ev = out["whatif_evicting"][1]
    assert ev["evictions"] and ev["evictions"]["victims"], ev
    assert out["whatif_sweep"][1]["max_fit"] > 0
    # malformed bodies are 400s; an unknown queue is answered (as the JAX
    # package answers it), not rejected
    assert [out[f"whatif_invalid_{i}"][0] for i in range(len(INVALID))] == [
        400, 400, 400, 200, 400]
    assert out["whatif_bad_json"][0] == 400 and out["sweep_invalid"][0] == 400


@pytest.mark.parametrize("step", ["alerts_1", "alerts_tripped"])
def test_alerts_match_jax(flow, step):
    _same(flow, step)


def test_tripped_alert_fires(flow):
    st = json.loads(flow["out"]["port"]["alerts_tripped"][2])
    assert st["alerts"]["guard_trips"]["firing"] is True


@pytest.mark.parametrize("since", list(range(-1, HEAD + 2)) + ["bad"])
def test_replicate_frames_match_jax(flow, since):
    _same(flow, f"replicate_{since}")
    status = flow["out"]["port"][f"replicate_{since}"][0]
    assert status == (400 if since == "bad" else 200)


# --------------------------------------------------------------------------
# by structure
# --------------------------------------------------------------------------


def test_metrics_series_match_jax(flow):
    """The same series names; equal deltas over the flow for every counter
    and non-time histogram series, equal sample counts for the time
    histograms, and equal final values for every gauge written."""
    parsed = {}
    for pkg in ("jax", "port"):
        before, _ = parse_prometheus(flow["before"][pkg])
        after, types = parse_prometheus(flow["after"][pkg])
        parsed[pkg] = (before, after, types)
    assert parsed["jax"][2] == parsed["port"][2]
    types = parsed["port"][2]
    logs = flow["logs"]
    set_names = {name for pkg in logs for (name, _l) in logs[pkg].sets}
    deltas = {}
    for pkg, (before, after, _t) in parsed.items():
        d = {}
        for key, value in after.items():
            name = key.split("{", 1)[0]
            base = re.sub(r"_(bucket|sum|count)$", "", name)
            if base in set_names or TIME_SERIES.search(name):
                continue
            delta = value - before.get(key, 0.0)
            if delta:
                d[key] = delta
        deltas[pkg] = d
    assert deltas["port"] == deltas["jax"]
    assert any(k.startswith("volcano_whatif_requests_total") for k in deltas["port"])
    assert any(k.startswith("volcano_replication_records_total") for k in deltas["port"])
    gauges = {pkg: {k: v for k, v in logs[pkg].sets.items() if not TIME_SERIES.search(k[0])}
              for pkg in logs}
    assert gauges["port"] == gauges["jax"]
    assert {t for n, t in types.items()} >= {"counter", "histogram", "gauge"}


def test_trace_span_tree_matches_jax(flow):
    trees = {}
    for pkg in ("jax", "port"):
        st = json.loads(flow["out"][pkg]["trace"][2])
        last = st["last_cycle"]
        trees[pkg] = dict(
            spans=[span_tree(s) for s in last["spans"]], reason=last["reason"],
            cycles=st["cycles_traced"], counts=st["span_counts"], enabled=st["enabled"],
            ring={k: v for k, v in st["ring"].items() if k in ("capacity", "records")})
    assert trees["port"] == trees["jax"]
    assert trees["port"]["cycles"] == 2


def test_guard_state_matches_jax_by_keys_and_counts(flow):
    """The same keys and counts; the port's state carries one more key,
    ``verdicts_consumed`` (its sentinel verdicts read, ROADMAP Queue 3)."""
    st = {pkg: json.loads(flow["out"][pkg]["guard"][2]) for pkg in ("jax", "port")}
    assert set(st["port"]) == set(st["jax"]) | {"verdicts_consumed"}
    assert st["port"]["verdicts_consumed"] > 0
    assert set(st["port"]["paths"]) <= set(st["jax"]["paths"])
    for name, path in st["port"]["paths"].items():
        assert path == st["jax"]["paths"][name], name
    for key in ("enabled", "cycle", "trips_total", "failed_closed", "audits_run",
                "audits_mismatched", "cooldown", "audit_every"):
        assert st["port"][key] == st["jax"][key], key
    assert st["port"]["trips_total"] == 1


def test_trace_dumps_after_a_guard_trip_match_jax(flow):
    _same(flow, "dump_escape", "dump_unknown")
    for step, want in (("dumps_empty", []), ("dumps", ["flight-guard_trip-0000"])):
        idx = {pkg: json.loads(flow["out"][pkg][step][2]) for pkg in ("jax", "port")}
        assert idx["port"]["dumps"] == idx["jax"]["dumps"] == want
        # each side dumps into its own directory, named after the package
        assert idx["port"]["directory"].endswith("port")
        assert idx["jax"]["directory"].endswith("jax")
    metas = {}
    for pkg in ("jax", "port"):
        status, ctype, body = flow["out"][pkg]["dump_meta.json"]
        assert status == 200 and ctype == "application/json"
        meta = json.loads(body)
        metas[pkg] = dict(
            reason=meta["reason"], detail=meta["detail"],
            tree=[{"cycle": r["cycle"], "reason": r["reason"],
                   "spans": [span_tree(s) for s in r["spans"]]} for r in meta["tree"]])
        assert flow["out"][pkg]["dump_trace.json"][0] == 200
    # the heal dropped the resident tensors, so the port's next swap is a
    # new state and publishes (a record at every swap, ROADMAP Queue 3);
    # the JAX leader's open version did not move, so it does not
    port_tree = metas["port"]["tree"][-1]["spans"]
    extra = [sp for sp in port_tree if sp[0] == "replicate_encode"]
    assert len(extra) == 1
    port_tree.remove(extra[0])
    assert metas["port"] == metas["jax"]
    from kube_batch_tpu_torch.obs.trace import validate_chrome_trace

    doc = json.loads(flow["out"]["port"]["dump_trace.json"][2])
    assert validate_chrome_trace(doc) == []


def test_ingest_landed_identically(flow):
    """The two caches hold the same objects: serialized back through each
    package's own ``*_to_dict``, every pod, node and PodGroup is equal."""
    dump = {}
    for pkg, side in flow["sides"].items():
        ser = jax_serialize if pkg == "jax" else port_serialize
        with side.cache._lock:
            dump[pkg] = dict(
                pods=sorted((ser.pod_to_dict(p) for p in side.cache.pods.values()),
                            key=lambda d: d["name"]),
                nodes=[ser.node_to_dict(n.node) for n in side.cache.nodes.values()],
                pvs=sorted(side.cache.volume_binder.pvs))
    assert dump["port"] == dump["jax"]
    assert dump["port"]["pvs"] == ["pv1"]


# --------------------------------------------------------------------------
# serialization across packages
# --------------------------------------------------------------------------


def _serialized_objects():
    objs = _cluster()
    return ([("pod", p) for p in objs["running"] + objs["pending"]]
            + [("node", n) for n in objs["nodes"]]
            + [("pod_group", g) for g in objs["podgroups"]]
            + [("queue", q) for q in objs["queues"]])


@pytest.mark.parametrize("kind,obj", _serialized_objects(),
                         ids=lambda v: v if isinstance(v, str) else getattr(v, "name", ""))
def test_serialize_round_trips_across_packages(kind, obj):
    """A dict made by either package loads into the other's objects and
    serializes back to the same dict."""
    to_j, from_j = getattr(jax_serialize, f"{kind}_to_dict"), getattr(jax_serialize,
                                                                      f"{kind}_from_dict")
    to_p, from_p = getattr(port_serialize, f"{kind}_to_dict"), getattr(port_serialize,
                                                                       f"{kind}_from_dict")
    d = to_j(obj)
    assert to_p(mirror(obj)) == d
    assert to_p(from_p(json.loads(json.dumps(d)))) == d
    assert to_j(from_j(json.loads(json.dumps(to_p(from_p(d)))))) == d


def test_priority_class_and_affinity_round_trip():
    from kube_batch_tpu.api.pod import Pod, PodAffinityTerm

    pod = Pod(name="p2", affinity=Affinity(
        pod_affinity=[PodAffinityTerm(match_labels={"app": "db"})],
        pod_anti_affinity=[PodAffinityTerm(match_labels={"app": "w"}, topology_key="zone")],
        preferred_node_terms=[(3, [("zone", "In", ("a",))])]),
        host_ports=(8080,), volume_claims=("c0",))
    d = jax_serialize.pod_to_dict(pod)
    back = port_serialize.pod_from_dict(json.loads(json.dumps(d)))
    assert back.affinity.pod_anti_affinity[0].topology_key == "zone"
    assert back.host_ports == (8080,) and back.volume_claims == ("c0",)
    assert port_serialize.pod_to_dict(back) == d
    pc = port_serialize.priority_class_from_dict({"name": "high", "value": 7})
    assert (pc.name, pc.value) == ("high", 7)


# --------------------------------------------------------------------------
# the egress token bucket
# --------------------------------------------------------------------------


def _pods(n):
    from kube_batch_tpu_torch.api.pod import Pod

    return [Pod(name=f"p{i}") for i in range(n)]


def test_bind_throttled_to_qps():
    from kube_batch_tpu_torch.cache.fake import FakeBinder
    from kube_batch_tpu_torch.cmd.server import RateLimitedBackend

    rl = RateLimitedBackend(FakeBinder(), qps=100.0, burst=5)
    t0 = time.perf_counter()
    for p in _pods(15):
        rl.bind(p, "n1")
    # 15 binds, burst 5 → ≥ 10 token waits at 100/s ≈ ≥ 0.1 s
    assert time.perf_counter() - t0 >= 0.08
    assert len(rl._backend.binds) == 15
    with pytest.raises(ValueError):
        RateLimitedBackend(FakeBinder())


def test_single_bucket_shared_across_seams():
    """Binder, evictor and status updater drain ONE budget: combined
    egress must not reach 3× qps."""
    from kube_batch_tpu_torch.cache.fake import FakeBinder, FakeEvictor, FakeStatusUpdater
    from kube_batch_tpu_torch.cmd.server import (
        RateLimitedBackend,
        RateLimitedStatusUpdater,
        TokenBucket,
    )

    bucket = TokenBucket(qps=100.0, burst=5)
    binder = RateLimitedBackend(FakeBinder(), bucket=bucket)
    evictor = RateLimitedBackend(FakeEvictor(), bucket=bucket)
    status = RateLimitedStatusUpdater(FakeStatusUpdater(), bucket=bucket)
    t0 = time.perf_counter()
    for i, p in enumerate(_pods(18)):
        if i % 3 == 0:
            binder.bind(p, "n1")
        elif i % 3 == 1:
            evictor.evict(p)
        else:
            status.update_queue_status(f"q{i}", {})
    # 18 writes against a SHARED burst of 5 → ≥ 13 waits at 100/s
    assert time.perf_counter() - t0 >= 0.1
    assert len(binder._backend.binds) == 6 and len(evictor._backend.evicts) == 6
    assert status.degraded() is False and status.parallel_safe is False


def test_take_sleeps_outside_the_lock():
    from kube_batch_tpu_torch.cmd.server import TokenBucket

    bucket = TokenBucket(qps=4.0, burst=1)
    bucket.take()  # the burst token; the next take waits ~0.25 s
    waiter = threading.Thread(target=bucket.take)
    waiter.start()
    try:
        time.sleep(0.05)
        acquired = bucket._lock.acquire(timeout=0.05)
        if acquired:
            bucket._lock.release()
        assert acquired, "take() held the lock through its sleep"
    finally:
        waiter.join(5)


def test_parallel_waiters_keep_aggregate_rate():
    from kube_batch_tpu_torch.cmd.server import TokenBucket

    bucket = TokenBucket(qps=100.0, burst=1)
    threads = [threading.Thread(target=bucket.take) for _ in range(9)]
    t0 = time.perf_counter()
    bucket.take()
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    elapsed = time.perf_counter() - t0
    assert 0.07 <= elapsed < 1.0


# --------------------------------------------------------------------------
# the debug endpoints and the plane switches
# --------------------------------------------------------------------------


def test_debug_endpoints():
    from kube_batch_tpu_torch.cache.cache import SchedulerCache
    from kube_batch_tpu_torch.cmd.server import AdminServer

    cache = SchedulerCache()
    srv = AdminServer(cache, port=0)
    srv.start()
    stop = threading.Event()

    def busy():
        x = 0
        while not stop.is_set():
            x += 1

    t = threading.Thread(target=busy, daemon=True)
    t.start()
    try:
        status, _, body = http(srv.port, "GET", "/debug/stacks")
        assert status == 200 and b"thread" in body
        status, _, body = http(srv.port, "GET", "/debug/pprof?seconds=0.3")
        assert status == 200 and b"samples:" in body and b"busy" in body
        for bad in ("x", "-1", "nan"):
            assert http(srv.port, "GET", f"/debug/pprof?seconds={bad}")[0] == 400
        # no plane, no publisher: 503s
        assert http(srv.port, "POST", "/v1/whatif", FEASIBLE)[0] == 503
        assert http(srv.port, "GET", "/v1/replicate?since=0")[0] == 503
    finally:
        stop.set()
        t.join(5)
        srv.stop()
        cache.stop()


@pytest.mark.parametrize("value,on", [("", True), ("1", True), ("yes", True),
                                      ("0", False), ("false", False), ("OFF", False),
                                      ("no", False), (" No ", False)])
def test_plane_switch_reads_the_jax_way(value, on, monkeypatch):
    """KB_WHATIF / KB_REPLICATE: on unless 0, false, off or no."""
    from kube_batch_tpu_torch.cmd.server import _on

    monkeypatch.setenv("KB_WHATIF", value)
    assert _on("KB_WHATIF") is on


def test_standalone_server_runs_and_stops(tmp_path):
    """``StandaloneServer`` as ``run`` builds it on the CPU: ingest over
    HTTP, ``/v1/sync`` lifts the cache-sync wait, the pipelined loop binds
    the pod, the state file is written each cycle, a what-if answers, the
    follower stream serves, and close() shuts everything down."""
    from kube_batch_tpu_torch.cmd import options
    from kube_batch_tpu_torch.cmd.server import StandaloneServer

    state = tmp_path / "state.json"
    opt = options.parse(["--listen-address", "127.0.0.1:0", "--schedule-period", "0.05",
                         "--cache-sync-timeout", "30", "--state-file", str(state)])
    srv = StandaloneServer(opt, device="cpu")
    loop = threading.Thread(target=srv.serve, daemon=True)
    loop.start()
    try:
        port = srv.admin.port
        assert http(port, "POST", "/v1/queues", {"name": "default", "weight": 1})[0] == 200
        assert http(port, "POST", "/v1/nodes",
                    [jax_serialize.node_to_dict(build_node("n0"))])[0] == 200
        assert http(port, "POST", "/v1/pods", [jax_serialize.pod_to_dict(build_pod(
            "c1", "p0", None, PodPhase.PENDING, {"cpu": 500}))])[0] == 200
        assert http(port, "POST", "/v1/sync", {})[0] == 200
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rows = json.loads(http(port, "GET", "/v1/bindings")[2])
            if rows and state.exists():
                break
            time.sleep(0.02)
        assert rows == [{"pod": "c1/p0", "node": "n0", "status": "BINDING"}] or \
            rows == [{"pod": "c1/p0", "node": "n0", "status": "BOUND"}]
        assert state.exists()
        status, _, body = http(port, "POST", "/v1/whatif", {"count": 1,
                                                            "requests": {"cpu": 100}})
        assert status == 200 and json.loads(body)["feasible"]
        assert http(port, "GET", "/v1/replicate?since=0")[0] == 200
        assert srv.sched.device.type == "cpu"
    finally:
        srv.sched.stop()
        loop.join(30)
        srv.close()
    assert not loop.is_alive()
    saved = json.loads(state.read_text())
    assert [p["node_name"] for p in saved["pods"]] == ["n0"]


def test_standalone_server_planes_off(monkeypatch):
    from kube_batch_tpu_torch.cmd import options
    from kube_batch_tpu_torch.cmd.server import StandaloneServer

    monkeypatch.setenv("KB_REPLICATE", "off")
    srv = StandaloneServer(options.parse(["--listen-address", "127.0.0.1:0"]), device="cpu")
    try:
        assert srv.query_plane is not None and getattr(srv.cache, "replication", None) is None
        assert http(srv.admin.port, "GET", "/v1/replicate")[0] == 503
    finally:
        srv.close()
    monkeypatch.setenv("KB_WHATIF", "0")
    srv = StandaloneServer(options.parse(["--listen-address", "127.0.0.1:0"]), device="cpu")
    try:
        assert srv.query_plane is None
        assert http(srv.admin.port, "POST", "/v1/whatif", FEASIBLE)[0] == 503
    finally:
        srv.close()
