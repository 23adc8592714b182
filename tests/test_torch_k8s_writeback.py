"""The port's apiserver writes against the JAX package's, recorded request
by request: ``K8sBackend`` (the Binding POST, the evict DELETE, a 409 bind
and a 404 evict taken as done, the PodGroup / pod-condition / Queue status
PATCHes, a shadow PodGroup never written) directly and behind
``RateLimitedStatusUpdater``; ``K8sPVLedger``'s claimRef PATCH and
selected-node annotation, its bounded retry queue (overflow releases the
dropped bindings) and idle retry timer, and its close — each sends the
same (method, path, content type, body) as the JAX ledger and leaves the
same ledger.  The ledger's feasibility answers over the JAX tests'
topology and fail-closed cases, and the k8s-mode volume flows of
``tests/test_k8s_shim.py`` (local PV, dynamic claim, unknown claim, bound
PVC) in a real cycle of each package: the same binds."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
from kube_batch_tpu_torch import actions as _port_actions  # noqa: F401 — registers
from kube_batch_tpu_torch import plugins as _port_plugins  # noqa: F401 — registers

import test_k8s_shim as shim
from test_torch_k8s_translate import canon
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

FIXTURES = shim.FIXTURES


def _pkg(name: str) -> dict:
    if name == "jax":
        from kube_batch_tpu.api import pod as api
        from kube_batch_tpu.api.types import PodGroupPhase
        from kube_batch_tpu.cache import volume
        from kube_batch_tpu.cmd.server import RateLimitedStatusUpdater, TokenBucket
        from kube_batch_tpu.k8s import translate
        from kube_batch_tpu.k8s.bind import K8sBackend
    else:
        from kube_batch_tpu_torch.api import pod as api
        from kube_batch_tpu_torch.api.types import PodGroupPhase
        from kube_batch_tpu_torch.cache import volume
        from kube_batch_tpu_torch.cmd.server import RateLimitedStatusUpdater, TokenBucket
        from kube_batch_tpu_torch.k8s import translate
        from kube_batch_tpu_torch.k8s.bind import K8sBackend
    return dict(api=api, Phase=PodGroupPhase, volume=volume, Status=RateLimitedStatusUpdater,
                Bucket=TokenBucket, translate=translate, Backend=K8sBackend)


PKGS = {n: _pkg(n) for n in ("jax", "port")}


class Recorder:
    """A loopback apiserver recording (method, path, content type, body);
    ``codes`` maps a path to the status it answers (default 200/201)."""

    def __init__(self, codes=None):
        self.calls = []
        codes = codes or {}
        rec = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _handle(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else None
                rec.calls.append((self.command, self.path,
                                  self.headers.get("Content-Type"), body))
                code = codes.get(self.path, 201 if self.command == "POST" else 200)
                data = b"{}"
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_POST = do_DELETE = do_PATCH = do_PUT = do_GET = _handle

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.srv.serve_forever, args=(0.05,), daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


CODES = {"/api/v1/namespaces/ns/pods/taken/binding": 409,
         "/api/v1/namespaces/ns/pods/bad/binding": 400,
         "/api/v1/namespaces/ns/pods/gone": 404,
         "/api/v1/namespaces/ns/pods/locked": 403}


def _backend_calls(name: str, wrap: bool) -> list:
    p = PKGS[name]
    api = p["api"]
    rec = Recorder(CODES)
    try:
        backend = p["Backend"](rec.url)
        status = p["Status"](backend, bucket=p["Bucket"](1000.0, 1000)) if wrap else backend
        outcomes = []
        for pod_name in ("w", "taken", "bad"):
            try:
                backend.bind(api.Pod(name=pod_name, namespace="ns", uid=f"u-{pod_name}"), "node-a")
                outcomes.append("ok")
            except urllib.error.HTTPError as e:
                outcomes.append(e.code)
        for pod_name in ("w", "gone", "locked"):
            try:
                backend.evict(api.Pod(name=pod_name, namespace="ns", uid="u"))
                outcomes.append("ok")
            except urllib.error.HTTPError as e:
                outcomes.append(e.code)
        pg = api.PodGroup(name="pg", namespace="ns", uid="pg-u", min_member=2,
                          queue="q", phase=p["Phase"].RUNNING, running=2, succeeded=1,
                          conditions=[api.PodGroupCondition(
                              type="Unschedulable", status="True", transition_id="s1",
                              reason="NotEnoughResources", message="2/3 tasks")])
        status.update_pod_group(pg)
        status.update_pod_group(api.PodGroup(name="p", namespace="ns", uid="s", shadow=True))
        status.update_pod_group(api.PodGroup(name="nophase", namespace="ns", uid="n"))
        status.update_pod_condition(api.Pod(name="w", namespace="ns", uid="u"),
                                    {"type": "PodScheduled", "status": "False",
                                     "reason": "Unschedulable", "message": "0/3 nodes"})
        status.update_queue_status("q", {"pending": 1, "running": 2, "unknown": 0})
        outcomes += [status.parallel_safe, status.degraded(), backend.degraded()]
        return outcomes + rec.calls
    finally:
        rec.close()


@pytest.mark.parametrize("wrap", [False, True], ids=["backend", "rate_limited"])
def test_backend_requests_equal(wrap):
    jax_calls = _backend_calls("jax", wrap)
    port_calls = _backend_calls("port", wrap)
    assert port_calls == jax_calls
    assert port_calls[:9] == ["ok", "ok", 400, "ok", "ok", 403, True, False, False]
    methods = [c[0] for c in port_calls[9:]]
    assert methods == ["POST"] * 3 + ["DELETE"] * 3 + ["PATCH"] * 4


# ---------------------------------------------------------------------------
# K8sPVLedger
# ---------------------------------------------------------------------------


class Transport:
    def __init__(self, fail_next=0):
        self.requests = []
        self.fail_next = fail_next

    def request(self, method, path, body=None, **kw):
        if self.fail_next:
            self.fail_next -= 1
            raise OSError("apiserver away")
        self.requests.append((method, path, body, kw.get("content_type")))


def _task(name, claims, ns="ml"):
    class T:
        pass

    t = T()
    t.uid = f"{ns}/{name}"
    t.pod = type("P", (), {"namespace": ns, "volume_claims": tuple(claims)})()
    return t


def _ledger_state(led):
    with led._lock:
        return dict(bound=dict(led.bound), reservations=canon(led.reservations),
                    pending=canon(led._pending_writes), claims=canon(led.claims),
                    classes=dict(led.storage_classes), pvs=canon(led.pvs))


def _cluster_side_flow(name):
    p = PKGS[name]
    tr = Transport()
    led = p["volume"].K8sPVLedger(transport=tr, bucket=p["Bucket"](1000.0, 1000))
    t = p["translate"]
    led.add_storage_class("local-ssd", "kubernetes.io/no-provisioner")
    led.add_storage_class("standard", "pd.csi.storage.gke.io")
    led.add_pv(t.pv_from_k8s(FIXTURES["pv_local"]))
    led.add_pvc(t.pvc_from_k8s(FIXTURES["pvc_unbound"]))
    led.add_pvc(t.pvc_from_k8s(FIXTURES["pvc_dynamic"]))
    states = []
    static = _task("s", ("train-data",))
    led.allocate_volumes(static, "node-b")
    states.append(_ledger_state(led))
    led.bind_volumes(static)
    led.drain_writes()
    led.add_pvc(t.pvc_from_k8s(FIXTURES["pvc_unbound"]))  # must not clear the binding
    states.append(_ledger_state(led))
    dyn = _task("d", ("scratch",))
    led.allocate_volumes(dyn, "node-a")
    tr.fail_next = 1
    led.bind_volumes(dyn)  # PATCH fails → queued
    led.drain_writes()
    states.append(_ledger_state(led))
    led.bound.pop("ml/train-data")
    led.add_pvc(t.pvc_from_k8s(FIXTURES["pvc_unbound"]))
    led.allocate_volumes(static, "node-b")
    led.bind_volumes(static)  # retries first, then the new write
    led.drain_writes()
    states.append(_ledger_state(led))
    led.close()
    closed = led._writer is None and led._retry_timer is None
    return tr.requests, states, closed


def test_ledger_cluster_writes_equal():
    jax_out, port_out = _cluster_side_flow("jax"), _cluster_side_flow("port")
    assert port_out == jax_out
    requests, states, closed = port_out
    assert closed and not states[-1]["pending"]
    assert requests[0][:2] == ("PATCH", "/api/v1/persistentvolumes/pv-ssd-b")
    assert requests[0][2]["spec"]["claimRef"]["name"] == "train-data"
    assert requests[0][3] == "application/merge-patch+json"
    ann = [r for r in requests if "persistentvolumeclaims/scratch" in r[1]]
    assert ann[0][2]["metadata"]["annotations"][
        PKGS["port"]["volume"].SELECTED_NODE_ANNOTATION] == "node-a"


def _retry_ledger(name, transport):
    p = PKGS[name]
    api = p["api"]
    led = p["volume"].K8sPVLedger(transport=transport)
    led.add_storage_class("local-ssd", "kubernetes.io/no-provisioner")
    for pv in ("pv-1", "pv-2"):
        led.add_pv(api.PersistentVolume(name=pv, node="node-a", storage_class="local-ssd"))
    for claim in ("c1", "c2"):
        led.add_pvc(api.PersistentVolumeClaim(name=claim, namespace="ml",
                                              storage_class="local-ssd"))
    return led


def _overflow_flow(name):
    tr = Transport(fail_next=100)
    led = _retry_ledger(name, tr)
    led.MAX_PENDING_WRITES = 1
    led.RETRY_FLUSH_INTERVAL = 3600.0
    states = []
    try:
        t1 = _task("a", ["c1"])
        led.allocate_volumes(t1, "node-a")
        led.bind_volumes(t1)
        led.drain_writes()
        states.append(_ledger_state(led))
        t2 = _task("b", ["c2"])
        led.allocate_volumes(t2, "node-a")
        led.bind_volumes(t2)  # c1's retry fails again, c2 fails → overflow
        led.drain_writes()
        states.append(_ledger_state(led))
        t3 = _task("c", ["c1"])
        led.allocate_volumes(t3, "node-a")  # the released PV is claimable again
        states.append(_ledger_state(led))
    finally:
        led.close()
    return states, led._retry_timer is None


def test_ledger_retry_overflow_equal():
    jax_out, port_out = _overflow_flow("jax"), _overflow_flow("port")
    assert port_out == jax_out
    states, timer_gone = port_out
    assert timer_gone
    assert len(states[1]["pending"]) == 1 and "ml/c1" not in states[1]["bound"]
    assert states[2]["reservations"]["ml/c"]["ml/c1"] == states[0]["bound"]["ml/c1"]


def _idle_flow(name):
    tr = Transport(fail_next=1)
    led = _retry_ledger(name, tr)
    led.RETRY_FLUSH_INTERVAL = 0.05
    try:
        t1 = _task("a", ["c1"])
        led.allocate_volumes(t1, "node-a")
        led.bind_volumes(t1)  # the PATCH fails → queued, timer armed
        led.drain_writes()
        queued = len(led._pending_writes)
        deadline = time.time() + 5.0
        while led._pending_writes and time.time() < deadline:
            time.sleep(0.01)  # no further bind: the timer alone drains it
        led.drain_writes()
        return queued, tr.requests, _ledger_state(led)
    finally:
        led.close()


def test_ledger_idle_timer_flush_equal():
    jax_out, port_out = _idle_flow("jax"), _idle_flow("port")
    assert port_out == jax_out
    queued, requests, state = port_out
    assert queued == 1 and not state["pending"]
    assert [r[1] for r in requests] == ["/api/v1/persistentvolumes/pv-1"]


def test_close_cancels_a_timer_armed_during_the_drain():
    """A write failing while ``close`` drains the writer arms a fresh retry
    timer; ``close`` cancels it too, so no timer thread outlives it."""
    tr = Transport(fail_next=1)
    led = _retry_ledger("port", tr)
    led.RETRY_FLUSH_INTERVAL = 3600.0
    t1 = _task("a", ["c1"])
    led.allocate_volumes(t1, "node-a")
    led.bind_volumes(t1)
    timers = [t for t in threading.enumerate() if isinstance(t, threading.Timer)]
    led.close()
    assert led._retry_timer is None and led._writer is None
    late = [t for t in threading.enumerate()
            if isinstance(t, threading.Timer) and t not in timers]
    assert len(late) == 1 and late[0].finished.is_set()  # armed in the drain, cancelled
    late[0].join(2.0)
    assert not late[0].is_alive()


# ---------------------------------------------------------------------------
# feasibility, and the k8s-mode volume flows in a cycle
# ---------------------------------------------------------------------------


def _zonal(name):
    p = PKGS[name]
    t = p["translate"]
    led = p["volume"].K8sPVLedger()
    led.add_storage_class("local-ssd", "kubernetes.io/no-provisioner")
    led.add_pv(t.pv_from_k8s(shim.TestPvTopologyAffinity._pv(
        shim.TestPvTopologyAffinity.ZONAL_AFF)))
    two = {"required": {"nodeSelectorTerms": [{"matchExpressions": [
        {"key": "kubernetes.io/hostname", "operator": "In", "values": ["node-a", "node-b"]}]}]}}
    led.add_pv(t.pv_from_k8s(shim.TestPvTopologyAffinity._pv(two, name="pv-two-hosts")))
    cond = {"required": {"nodeSelectorTerms": [{"matchExpressions": [
        {"key": "kubernetes.io/hostname", "operator": "In", "values": ["n1"]},
        {"key": "topology.kubernetes.io/zone", "operator": "In", "values": ["z1"]}]}]}}
    pv = t.pv_from_k8s(shim.TestPvTopologyAffinity._pv(cond, name="pv-cond"))
    pv.storage_class = "cond-ssd"
    led.add_storage_class("cond-ssd", "kubernetes.io/no-provisioner")
    led.add_pv(pv)
    led.add_pv(p["api"].PersistentVolume(
        name="pv-neg", storage_class="neg-ssd", node=t.PV_NODE_RESTRICTED_UNKNOWN,
        node_terms=((("topology.kubernetes.io/zone", "NotIn", ("z1",)),),)))
    led.add_storage_class("neg-ssd", "kubernetes.io/no-provisioner")
    for claim, sc in (("zonal-data", "local-ssd"), ("dual", "local-ssd"),
                      ("cond", "cond-ssd"), ("neg", "neg-ssd")):
        led.add_pvc(t.pvc_from_k8s({"metadata": {"name": claim, "namespace": "ml"},
                                    "spec": {"storageClassName": sc},
                                    "status": {"phase": "Pending"}}))
    return led


LABEL_STEPS = [
    ("node-a", {"topology.kubernetes.io/zone": "us-central1-a"}),
    ("node-b", {"topology.kubernetes.io/zone": "us-central1-b"}),
    ("n1", {"topology.kubernetes.io/zone": "z2"}), ("n-out", {"topology.kubernetes.io/zone": "z2"}),
    ("n1", {"topology.kubernetes.io/zone": "z1"}), ("n-in", {"topology.kubernetes.io/zone": "z1"}),
    ("forget", "node-a"),
]
HOSTS = ["node-a", "node-b", "node-c", "node-unknown", "n1", "n-out", "n-in", "mystery-node",
         "us-central1-a"]


def _feasibility(name):
    led = _zonal(name)
    out = []
    tasks = [_task(f"t-{c}", [c]) for c in ("zonal-data", "dual", "cond", "neg", "no-such")]
    for step in [None] + LABEL_STEPS:
        if step is not None:
            node, labels = step
            if node == "forget":
                led.forget_node_labels(labels)
            else:
                led.set_node_labels(node, labels)
        out.append([[led.volume_feasible(t, h) for h in HOSTS] for t in tasks])
    t = _task("binder", ["zonal-data"])
    led.set_node_labels("node-a", {"topology.kubernetes.io/zone": "us-central1-a"})
    led.allocate_volumes(t, "node-a")
    led.bind_volumes(t)
    out.append(dict(led.bound))
    return out


def test_ledger_feasibility_equal():
    port = _feasibility("port")
    assert port == _feasibility("jax")
    assert port[-1] == {"ml/zonal-data": "pv-two-hosts"}  # first by name


def _volume_flow(name, flow):
    if name == "jax":
        from kube_batch_tpu.api.resources import GPU, ResourceSpec
        from kube_batch_tpu.cache.cache import SchedulerCache
        from kube_batch_tpu.k8s import WatchAdapter
        from kube_batch_tpu.scheduler import Scheduler
        kw = {}
    else:
        from kube_batch_tpu_torch.api.resources import GPU, ResourceSpec
        from kube_batch_tpu_torch.cache.cache import SchedulerCache
        from kube_batch_tpu_torch.k8s import WatchAdapter
        from kube_batch_tpu_torch.scheduler import Scheduler
        kw = {"device": "cpu"}
    cache = SchedulerCache(spec=ResourceSpec(scalar_names=(GPU,)),
                           volume_binder=PKGS[name]["volume"].K8sPVLedger())
    node = shim.TestVolumeK8sMode._node
    q = ("queues", "ADDED", shim.TestVolumeK8sMode.DEFAULT_QUEUE)
    bound_pvc = json.loads(json.dumps(FIXTURES["pvc_unbound"]))
    bound_pvc["spec"]["volumeName"] = "pv-ssd-b"
    bound_pvc["status"]["phase"] = "Bound"
    events = {
        "local_pv": [q, ("storageclasses", "ADDED", FIXTURES["storageclass_local"]),
                     ("persistentvolumes", "ADDED", FIXTURES["pv_local"]),
                     ("persistentvolumeclaims", "ADDED", FIXTURES["pvc_unbound"]),
                     ("nodes", "ADDED", node(None, "node-a")),
                     ("nodes", "ADDED", node(None, "node-b")),
                     ("pods", "ADDED", shim._pvc_pod("stateful-1", "train-data"))],
        "dynamic": [q, ("storageclasses", "ADDED", FIXTURES["storageclass_dynamic"]),
                    ("persistentvolumeclaims", "ADDED", FIXTURES["pvc_dynamic"]),
                    ("nodes", "ADDED", node(None, "node-a")),
                    ("pods", "ADDED", shim._pvc_pod("worker-1", "scratch"))],
        "unknown_claim": [q, ("nodes", "ADDED", node(None, "node-a")),
                          ("pods", "ADDED", shim._pvc_pod("orphan-1", "no-such-claim"))],
        "bound_pvc": [q, ("persistentvolumes", "ADDED", FIXTURES["pv_local"]),
                      ("persistentvolumeclaims", "ADDED", bound_pvc),
                      ("nodes", "ADDED", node(None, "node-a")),
                      ("nodes", "ADDED", node(None, "node-b")),
                      ("pods", "ADDED", shim._pvc_pod("stateful-2", "train-data"))],
    }[flow]
    WatchAdapter(cache, api_server="http://unused").replay(events)
    cache.mark_synced()
    sched = Scheduler(cache, **kw)
    try:
        sched.run_once()
        cache.flush_binds()
        return dict(cache.binder.binds), dict(cache.volume_binder.bound)
    finally:
        sched.close()
        cache.stop()


@pytest.mark.parametrize("flow,want", [
    ("local_pv", {"ml/stateful-1": "node-b"}), ("dynamic", {"ml/worker-1": "node-a"}),
    ("unknown_claim", {}), ("bound_pvc", {"ml/stateful-2": "node-b"})])
def test_k8s_volume_flows_bind_equal(flow, want):
    port = _volume_flow("port", flow)
    assert port == _volume_flow("jax", flow)
    assert port[0] == want
