"""Live-apiserver e2e driver — the rebuild's test/e2e (job.go, queue.go),
mirroring ``kube_batch_tpu/testing/e2e.py`` for the port's scheduler.

One command runs the reference's core behavioural scenarios against a
Kubernetes API server with the port's scheduler in --master mode, end to
end through the CRDs, the list+watch front end, the binder/evictor and the
status writeback:

    python -m kube_batch_tpu_torch.testing.e2e --stub [--device cpu]
    python -m kube_batch_tpu_torch.testing.e2e --master https://127.0.0.1:6443
    python -m kube_batch_tpu_torch.testing.e2e --stub --density [--density-pods N]

The scheduler runs as ``python -m kube_batch_tpu_torch.cmd.main --master
…`` on the card (``--device cuda``, the default) or on the CPU
(``--device cpu``, through ``server_drive.CPU_ENTRY``).

Scenarios (test/e2e/job.go:82,118,189; queue.go:26; job.go:458;
predicates.go:35,84,161):
  gang              — minMember gang schedules atomically
  gang_full         — a gang that cannot fully fit binds NOTHING
  preemption        — a high-priority job evicts same-queue victims, then
                      places once the kubelet terminates them
  reclaim           — a starved weighted queue reclaims cross-queue
  proportion        — two weighted queues split capacity by weight
  node_selector     — selector pods land only on matching nodes
  taints            — only tolerating pods land on a tainted node
  hostport          — same hostPort forces distinct nodes
  volume            — a local-PV claim pins its pod; the PV pre-binds
  job_priority      — a PriorityClass-backed job wins contended capacity

With --stub, an in-process fake apiserver (real HTTP, real watch streams)
plays the cluster, including the kubelet's part: a Binding POST transitions
the pod to Running on the node, a DELETE terminates it — the state machine
the scenarios need.  The same scenario code runs unmodified against a real
cluster; there the kubelet/PV controller do that work.

Where the port's stub differs from the JAX package's (both are test
harnesses; ROADMAP Queue 3): a watch from a resourceVersion replays the
kind's events after it (410 Gone once they fell out of the history)
instead of the whole store, so a client at 50 000 pods is not sent every
pod again; creating an existing object answers 409 and a PUT carrying a
stale resourceVersion answers 409, as an apiserver does; namespaced lists
are filtered by namespace; a stopped stub ends its watch streams; it
counts what it served (``GET /stub/stats``, and ``GET /stub/bound``:
each Binding's time); ``load`` preloads objects without events; and
tests can drop and hold watch streams (``drop_watches``,
``hold_watches``).  The CRDs are read from ``crds.json`` (the
port reads no YAML; a test holds it equal to ``deployment/crds/``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import logging
import math
import os
import queue as _queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("kube_batch_tpu_torch")

SCHED = "volcano"  # default scheduler-name the front end filters on

# collection resource segment → canonical list path (mirrors k8s/watch.py)
_COLLECTIONS = {
    "namespaces": "/api/v1/namespaces",
    "pods": "/api/v1/pods",
    "nodes": "/api/v1/nodes",
    "persistentvolumes": "/api/v1/persistentvolumes",
    "persistentvolumeclaims": "/api/v1/persistentvolumeclaims",
    "podgroups": "/apis/scheduling.incubator.k8s.io/v1alpha1/podgroups",
    "queues": "/apis/scheduling.incubator.k8s.io/v1alpha1/queues",
    "poddisruptionbudgets": "/apis/policy/v1/poddisruptionbudgets",
    "priorityclasses": "/apis/scheduling.k8s.io/v1/priorityclasses",
    "storageclasses": "/apis/storage.k8s.io/v1/storageclasses",
    "customresourcedefinitions":
        "/apis/apiextensions.k8s.io/v1/customresourcedefinitions",
    "leases": "/apis/coordination.k8s.io/v1/leases",
}

#: watch events kept per kind for a resumed watch; an older
#: resourceVersion is answered with 410 Gone (the client re-lists)
HISTORY = 400_000

CRDS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "crds.json")


def _merge(dst: dict, patch: dict) -> dict:
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        elif v is None:
            dst.pop(k, None)
        else:
            dst[k] = v
    return dst


def nearest_rank(values: List[float], p: float) -> float:
    """Nearest-rank percentile, ``ceil(p * n) - 1`` (the JAX package's
    ``sim/metrics.nearest_rank``)."""
    xs = sorted(values)
    return xs[min(len(xs) - 1, max(0, math.ceil(p * len(xs)) - 1))]


class StubApiServer:
    """A watchable fake apiserver with a built-in kubelet simulation."""

    def __init__(self, history: int = HISTORY):
        self._store: Dict[str, Dict[str, dict]] = {k: {} for k in _COLLECTIONS}
        self._watchers: Dict[str, List[_queue.Queue]] = {k: [] for k in _COLLECTIONS}
        # kind → (resourceVersion, event line) of its last ``history``
        # events, and the newest resourceVersion that fell out of them
        self._history: Dict[str, collections.deque] = {
            k: collections.deque(maxlen=history) for k in _COLLECTIONS}
        self._evicted_rv: Dict[str, int] = {k: 0 for k in _COLLECTIONS}
        self._rv = 0
        self._lock = threading.RLock()
        self._closing = threading.Event()
        # set: watch requests are answered; cleared by hold_watches()
        self._watch_open = threading.Event()
        self._watch_open.set()
        self._dropped: set = set()  # ids of watch queues told to end
        self.httpd: Optional[ThreadingHTTPServer] = None
        # what the stub served: requests by "METHOD kind[/subresource]",
        # LIST bytes by kind, and each Binding's wall-clock time by pod key
        self.requests: Dict[str, int] = collections.Counter()
        self.list_bytes: Dict[str, int] = collections.Counter()
        self.bound_at: Dict[str, float] = {}

    # ---- store ---------------------------------------------------------
    @staticmethod
    def _key(obj: dict) -> str:
        meta = obj.get("metadata") or {}
        ns = meta.get("namespace")
        return f"{ns}/{meta['name']}" if ns else meta["name"]

    def _emit(self, kind: str, etype: str, obj: dict) -> None:
        self._rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
        line = (json.dumps({"type": etype, "object": obj}) + "\n").encode()
        hist = self._history[kind]
        if len(hist) == hist.maxlen:
            self._evicted_rv[kind] = hist[0][0]
        hist.append((self._rv, line))
        for q in self._watchers[kind]:
            q.put(line)

    def load(self, kind: str, objs) -> None:
        """Preload objects as the cluster's state, with no watch events."""
        with self._lock:
            store = self._store[kind]
            for obj in objs:
                self._rv += 1
                obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
                store[self._key(obj)] = obj

    def create(self, kind: str, obj: dict) -> bool:
        """An apiserver create: False (409) when the object exists."""
        with self._lock:
            key = self._key(obj)
            if key in self._store[kind]:
                return False
            self._store[kind][key] = obj
            self._emit(kind, "ADDED", obj)
            return True

    def replace(self, kind: str, key: str, obj: dict) -> int:
        """A PUT: 404 for a missing object, 409 when the body's
        resourceVersion is not the stored one (the compare-and-swap), 200
        when it replaced it."""
        with self._lock:
            cur = self._store[kind].get(key)
            if cur is None:
                return 404
            rv = (obj.get("metadata") or {}).get("resourceVersion")
            if rv is not None and rv != cur["metadata"]["resourceVersion"]:
                return 409
            self._store[kind][key] = obj
            self._emit(kind, "MODIFIED", obj)
            return 200

    def delete(self, kind: str, key: str) -> bool:
        with self._lock:
            obj = self._store[kind].pop(key, None)
            if obj is None:
                return False
            self._emit(kind, "DELETED", obj)
            return True

    def patch(self, kind: str, key: str, patch: dict) -> bool:
        with self._lock:
            obj = self._store[kind].get(key)
            if obj is None:
                return False
            _merge(obj, patch)
            self._emit(kind, "MODIFIED", obj)
            return True

    # ---- kubelet simulation -------------------------------------------
    def bind_pod(self, ns: str, name: str, node: str) -> bool:
        """Binding subresource → the kubelet runs the pod."""
        with self._lock:
            pod = self._store["pods"].get(f"{ns}/{name}")
            if pod is None:
                return False
            pod.setdefault("spec", {})["nodeName"] = node
            pod.setdefault("status", {})["phase"] = "Running"
            self.bound_at[f"{ns}/{name}"] = time.time()
            self._emit("pods", "MODIFIED", pod)
            return True

    # ---- connection faults (tests) -------------------------------------
    def drop_watches(self) -> None:
        """End every open watch stream at once, undelivered events
        discarded (a connection lost mid-stream)."""
        with self._lock:
            for qs in self._watchers.values():
                self._dropped.update(id(q) for q in qs)

    def hold_watches(self) -> None:
        """Keep new watch requests waiting (their clients blocked in the
        connect) until :meth:`release_watches`."""
        self._watch_open.clear()

    def release_watches(self) -> None:
        self._watch_open.set()

    def stats(self) -> dict:
        """What the stub served, and its pods with ``spec.nodeName``."""
        with self._lock:
            return {
                "requests": dict(self.requests),
                "list_bytes": dict(self.list_bytes),
                "objects": {k: len(v) for k, v in self._store.items() if v},
                "pods_on_nodes": sum(1 for p in self._store["pods"].values()
                                     if (p.get("spec") or {}).get("nodeName")),
                "resource_version": self._rv,
                "cpu_s": time.process_time(),  # the stub process's CPU seconds
            }

    # ---- HTTP ----------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"  # close-delimited watch streams

            def log_message(self, *a):
                pass

            def _send(self, code: int, obj=None, data: Optional[bytes] = None) -> None:
                if data is None:
                    data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _route(self) -> Tuple[Optional[str], List[str], str]:
                """path → (collection kind, trailing segments, query). The
                LAST matching segment is the resource — namespaced paths
                (/api/v1/namespaces/<ns>/pods/...) contain 'namespaces'
                first but address the inner collection."""
                path, _, query = self.path.partition("?")
                parts = [p for p in path.split("/") if p]
                for i in range(len(parts) - 1, -1, -1):
                    if parts[i] in _COLLECTIONS:
                        return parts[i], parts[i + 1:], query
                return None, [], query

            def _namespace(self) -> Optional[str]:
                path = self.path.split("?")[0]
                if "/namespaces/" in path:
                    return path.split("/namespaces/")[1].split("/")[0]
                return None

            def _obj_key(self, kind: str, rest: List[str]) -> str:
                # .../namespaces/<ns>/<kind>/<name> carries the namespace
                # two segments before the kind; cluster-scoped is just name
                ns = self._namespace()
                if ns is not None and kind != "namespaces":
                    return f"{ns}/{rest[0]}"
                if kind == "pods" and rest:
                    return rest[0] if "/" in rest[0] else f"default/{rest[0]}"
                return rest[0]

            def _count(self, kind: str, rest: List[str]) -> None:
                sub = f"/{rest[-1]}" if len(rest) > 1 else ""
                with stub._lock:
                    stub.requests[f"{self.command} {kind}{sub}"] += 1

            def _watch(self, kind: str, query: str) -> None:
                q: _queue.Queue = _queue.Queue()
                params = dict(p.partition("=")[::2] for p in query.split("&") if p)
                rv = params.get("resourceVersion")
                while not stub._watch_open.wait(0.5):
                    if stub._closing.is_set():
                        return
                with stub._lock:
                    if rv is None:
                        # no resourceVersion: whatever the store holds NOW
                        # replays as MODIFIED (the front end's handlers are
                        # upserts, so re-delivery is harmless)
                        for obj in stub._store[kind].values():
                            q.put((json.dumps({"type": "MODIFIED", "object": obj})
                                   + "\n").encode())
                    elif int(rv) < stub._evicted_rv[kind]:
                        gone = {"type": "ERROR", "object": {
                            "kind": "Status", "code": 410, "reason": "Expired"}}
                        q.put((json.dumps(gone) + "\n").encode())
                    else:
                        for ev_rv, line in stub._history[kind]:
                            if ev_rv > int(rv):
                                q.put(line)
                    stub._watchers[kind].append(q)
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    while not stub._closing.is_set() and id(q) not in stub._dropped:
                        try:
                            line = q.get(timeout=0.5)
                        except _queue.Empty:
                            continue
                        if id(q) in stub._dropped:
                            break
                        self.wfile.write(line)
                        self.wfile.flush()
                except OSError:  # the client went away
                    return
                finally:
                    with stub._lock:
                        stub._dropped.discard(id(q))
                        try:
                            stub._watchers[kind].remove(q)
                        except ValueError:
                            pass

            def do_GET(self):
                if self.path == "/stub/stats":
                    self._send(200, stub.stats())
                    return
                if self.path == "/stub/bound":
                    with stub._lock:
                        data = json.dumps(stub.bound_at).encode()
                    self._send(200, data=data)
                    return
                kind, rest, query = self._route()
                if kind is None:
                    self._send(404, {"error": "not found"})
                    return
                self._count(kind, rest)
                if "watch=true" in query:
                    self._watch(kind, query)
                    return
                with stub._lock:
                    if rest:  # single object GET (lease elector, PV check)
                        obj = stub._store[kind].get(self._obj_key(kind, rest))
                        data = None if obj is None else json.dumps(obj).encode()
                    else:
                        ns = self._namespace()
                        items = [o for o in stub._store[kind].values()
                                 if ns is None
                                 or (o.get("metadata") or {}).get("namespace") == ns]
                        data = json.dumps({
                            "items": items,
                            "metadata": {"resourceVersion": str(stub._rv)},
                        }).encode()
                        stub.list_bytes[kind] += len(data)
                if data is None:
                    self._send(404, {"error": "not found"})
                else:
                    self._send(200, data=data)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_POST(self):
                kind, rest, _ = self._route()
                if kind is None:
                    self._send(404, {"error": "not found"})
                    return
                self._count(kind, rest)
                body = self._body()
                if kind == "pods" and rest and rest[-1] == "binding":
                    ns = self._namespace() or "default"
                    ok = stub.bind_pod(ns, rest[-2],
                                       (body.get("target") or {}).get("name", ""))
                    self._send(201 if ok else 404, {})
                    return
                # creation: stamp the namespace from the URL when present
                ns = self._namespace()
                if ns is not None and kind != "namespaces":
                    body.setdefault("metadata", {}).setdefault("namespace", ns)
                if not stub.create(kind, body):
                    self._send(409, {"kind": "Status", "reason": "AlreadyExists"})
                    return
                # the stored object is the stub's now (a later bind mutates
                # it): answer with an empty body, which every client ignores
                self._send(201, {})

            def do_PUT(self):
                kind, rest, _ = self._route()
                if kind is None or not rest:
                    self._send(404, {"error": "not found"})
                    return
                self._count(kind, rest)
                body = self._body()
                self._send(stub.replace(kind, self._obj_key(kind, rest), body), {})

            def do_PATCH(self):
                kind, rest, _ = self._route()
                if kind is None or not rest:
                    self._send(404, {"error": "not found"})
                    return
                self._count(kind, rest)
                ok = stub.patch(kind, self._obj_key(kind, rest), self._body())
                self._send(200 if ok else 404, {})

            def do_DELETE(self):
                kind, rest, _ = self._route()
                if kind is None or not rest:
                    self._send(404, {"error": "not found"})
                    return
                self._count(kind, rest)
                ok = stub.delete(kind, self._obj_key(kind, rest))
                self._send(200 if ok else 404, {})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, args=(0.05,), daemon=True,
                         name="stub-apiserver").start()
        return f"http://{host}:{self.httpd.server_address[1]}"

    def stop(self) -> None:
        """Stop serving and end every open watch stream (within ~0.5 s)."""
        self._closing.set()
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()


# ---------------------------------------------------------------------------
# client helpers (work against the stub AND a real apiserver)
# ---------------------------------------------------------------------------


class Cluster:
    """Minimal apiserver client for the scenarios. Creates are tracked so
    teardown() can delete them in reverse order — scenario isolation on a
    real cluster, where objects would otherwise leak across runs."""

    def __init__(self, master: str, **auth):
        from kube_batch_tpu_torch.k8s.transport import ApiTransport

        self.t = ApiTransport(master, **auth)
        self._created: List[str] = []  # object paths, creation order

    def _obj_path(self, collection_path: str, obj: dict) -> str:
        meta = obj.get("metadata") or {}
        ns, name = meta.get("namespace"), meta.get("name", "")
        if ns and not collection_path.rstrip("/").endswith(f"namespaces/{ns}"):
            prefix, _, resource = collection_path.rpartition("/")
            return f"{prefix}/namespaces/{ns}/{resource}/{name}"
        return f"{collection_path}/{name}"

    def create(self, collection_path: str, obj: dict, tolerate_conflict=False) -> None:
        import urllib.error

        try:
            self.t.request("POST", collection_path, obj)
        except urllib.error.HTTPError as e:
            if not (tolerate_conflict and e.code == 409):
                raise
            return
        self._created.append(self._obj_path(collection_path, obj))

    def ensure_namespace(self, ns: str) -> None:
        self.create("/api/v1/namespaces",
                    {"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": ns}},
                    tolerate_conflict=True)

    def teardown(self) -> None:
        """Best-effort reverse-order cleanup of everything this client made."""
        import urllib.error

        for path in reversed(self._created):
            try:
                self.t.request("DELETE", path)
            except (urllib.error.HTTPError, OSError):
                pass
        self._created.clear()

    def pods(self, ns: str) -> Dict[str, dict]:
        # namespaced list (a real cluster must not pay a cluster-wide pod
        # list per wait poll)
        listing = self.t.get_json(f"/api/v1/namespaces/{ns}/pods")
        return {
            StubApiServer._key(p): p for p in listing.get("items", [])
            if (p.get("metadata") or {}).get("namespace") == ns
        }

    def apply_crds(self) -> None:
        """Apply the chart's CRDs (``deployment/crds/``, read from their
        JSON rendering ``crds.json``)."""
        import urllib.error

        with open(CRDS_PATH) as f:
            crds = json.load(f)
        for crd in crds:
            try:
                self.create(_COLLECTIONS["customresourcedefinitions"], crd)
            except urllib.error.HTTPError as e:
                if e.code != 409:  # already exists
                    raise

    # -- object builders (test/e2e/util.go analogs) ----------------------
    def queue(self, name: str, weight: int) -> None:
        self.create(_COLLECTIONS["queues"], {
            "apiVersion": "scheduling.incubator.k8s.io/v1alpha1",
            "kind": "Queue", "metadata": {"name": name},
            "spec": {"weight": weight},
        })

    def node_obj(self, name: str, cpu_m: int = 4000, mem_gi: int = 16) -> dict:
        return {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name,
                         "labels": {"kubernetes.io/hostname": name}},
            "spec": {},
            "status": {
                "allocatable": {"cpu": f"{cpu_m}m", "memory": f"{mem_gi}Gi",
                                "pods": "110"},
                "capacity": {"cpu": f"{cpu_m}m", "memory": f"{mem_gi}Gi",
                             "pods": "110"},
                "conditions": [{"type": "Ready", "status": "True"}],
            },
        }

    def podgroup(self, ns: str, name: str, min_member: int, queue: str) -> None:
        self.create(_COLLECTIONS["podgroups"], {
            "apiVersion": "scheduling.incubator.k8s.io/v1alpha1",
            "kind": "PodGroup",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"minMember": min_member, "queue": queue},
        })

    def pod(self, ns: str, name: str, group: str, cpu_m: int = 1000,
            priority: int = 0, node: Optional[str] = None,
            node_selector: Optional[dict] = None,
            tolerations: Optional[list] = None,
            host_port: Optional[int] = None) -> None:
        container = {
            "name": "c", "image": "busybox",
            "resources": {"requests": {"cpu": f"{cpu_m}m", "memory": "1Gi"}},
        }
        if host_port is not None:
            container["ports"] = [{"containerPort": host_port,
                                   "hostPort": host_port}]
        obj = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {
                "name": name, "namespace": ns,
                "uid": f"{ns}-{name}-uid",
                "annotations": {"scheduling.k8s.io/group-name": group},
            },
            "spec": {
                "schedulerName": SCHED,
                "priority": priority,
                "containers": [container],
            },
            "status": {"phase": "Pending"},
        }
        if node_selector:
            obj["spec"]["nodeSelector"] = node_selector
        if tolerations:
            obj["spec"]["tolerations"] = tolerations
        if node is not None:
            obj["spec"]["nodeName"] = node
            obj["status"]["phase"] = "Running"
        self.create(f"/api/v1/namespaces/{ns}/pods", obj)

    def wait(self, predicate, timeout: float = 60.0, what: str = "",
             interval: float = 0.25) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if predicate():
                return
            time.sleep(interval)
        raise TimeoutError(f"e2e wait timed out: {what}")

    def n_on_nodes(self, ns: str, prefix: str = "") -> int:
        return sum(
            1 for k, p in self.pods(ns).items()
            if k.split("/", 1)[1].startswith(prefix)
            and (p.get("spec") or {}).get("nodeName")
        )


# ---------------------------------------------------------------------------
# scenarios (the JAX package's, unchanged)
# ---------------------------------------------------------------------------


def scenario_gang(c: Cluster, ns: str) -> None:
    """Gang scheduling (job.go:82): all minMember tasks bind together."""
    c.queue(f"{ns}-q", 1)
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-n1"))
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-n2"))
    c.podgroup(ns, "gang", 6, f"{ns}-q")
    for i in range(6):
        c.pod(ns, f"g{i}", "gang")
    c.wait(lambda: c.n_on_nodes(ns, "g") == 6, what="gang fully scheduled")


def scenario_gang_full(c: Cluster, ns: str) -> None:
    """Gang: Full Occupied (job.go:118): an unsatisfiable gang binds NOTHING
    (no partial placement) while a fitting gang proceeds."""
    c.queue(f"{ns}-q", 1)
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-n1", cpu_m=4000))
    c.podgroup(ns, "big", 8, f"{ns}-q")   # 8 x 1000m > 4000m — can't fit
    for i in range(8):
        c.pod(ns, f"big{i}", "big")
    c.podgroup(ns, "ok", 3, f"{ns}-q")
    for i in range(3):
        c.pod(ns, f"ok{i}", "ok")
    c.wait(lambda: c.n_on_nodes(ns, "ok") == 3, what="fitting gang scheduled")
    time.sleep(2.0)  # give the scheduler cycles to (wrongly) place the big gang
    assert c.n_on_nodes(ns, "big") == 0, "partial gang placement happened"


def scenario_preemption(c: Cluster, ns: str) -> None:
    """Preemption (job.go:189): a high-priority same-queue job evicts
    running victims and places once they terminate."""
    c.queue(f"{ns}-q", 1)
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-n1", cpu_m=4000))
    # minMember 2 with 4 running replicas: gang slack 2 — the victims the
    # gang plugin permits (gang.go:71-94 refuses to break a min==replicas gang)
    c.podgroup(ns, "low", 2, f"{ns}-q")
    for i in range(4):  # fills the node
        c.pod(ns, f"low{i}", "low", node=f"{ns}-n1")
    c.podgroup(ns, "high", 2, f"{ns}-q")
    for i in range(2):
        c.pod(ns, f"high{i}", "high", priority=1000)
    c.wait(lambda: c.n_on_nodes(ns, "high") == 2, timeout=90,
           what="high-priority job placed after preemption")


def scenario_reclaim(c: Cluster, ns: str) -> None:
    """Reclaim across queues (queue.go:26): a starved weighted queue evicts
    another queue's overuse."""
    c.queue(f"{ns}-q1", 1)
    c.queue(f"{ns}-q2", 1)
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-n1", cpu_m=4000))
    # gang slack 2 (see scenario_preemption): reclaimable without breaking
    # the hog's own gang
    c.podgroup(ns, "hog", 2, f"{ns}-q1")
    for i in range(4):
        c.pod(ns, f"hog{i}", "hog", node=f"{ns}-n1")
    c.podgroup(ns, "starved", 2, f"{ns}-q2")
    for i in range(2):
        c.pod(ns, f"starved{i}", "starved")
    c.wait(lambda: c.n_on_nodes(ns, "starved") == 2, timeout=90,
           what="starved queue reclaimed")


def scenario_proportion(c: Cluster, ns: str) -> None:
    """Proportion (job.go:458): weighted queues split contended capacity
    ~by weight; nothing is overcommitted."""
    c.queue(f"{ns}-gold", 2)
    c.queue(f"{ns}-bronze", 1)
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-n1", cpu_m=6000))
    c.podgroup(ns, "gj", 1, f"{ns}-gold")
    c.podgroup(ns, "bj", 1, f"{ns}-bronze")
    for i in range(6):
        c.pod(ns, f"gp{i}", "gj")
        c.pod(ns, f"bp{i}", "bj")
    c.wait(lambda: c.n_on_nodes(ns) >= 6, what="capacity filled")
    time.sleep(2.0)
    gold, bronze = c.n_on_nodes(ns, "gp"), c.n_on_nodes(ns, "bp")
    assert gold + bronze <= 6, f"overcommit: {gold}+{bronze}"
    assert gold >= bronze, f"weights inverted: gold={gold} bronze={bronze}"
    assert gold >= 3, f"gold under-served: {gold}"


def scenario_node_selector(c: Cluster, ns: str) -> None:
    """NodeAffinity/selector (predicates.go:35): a selector pod lands only
    on the matching node."""
    c.queue(f"{ns}-q", 1)
    red, blue = c.node_obj(f"{ns}-red"), c.node_obj(f"{ns}-blue")
    red["metadata"]["labels"]["color"] = "red"
    blue["metadata"]["labels"]["color"] = "blue"
    c.create(_COLLECTIONS["nodes"], red)
    c.create(_COLLECTIONS["nodes"], blue)
    c.podgroup(ns, "sel", 2, f"{ns}-q")
    for i in range(2):
        c.pod(ns, f"sel{i}", "sel", node_selector={"color": "blue"})
    c.wait(lambda: c.n_on_nodes(ns, "sel") == 2, what="selector pods placed")
    for k, p in c.pods(ns).items():
        assert p["spec"].get("nodeName") in (None, f"{ns}-blue"), (k, p["spec"])


def scenario_taints(c: Cluster, ns: str) -> None:
    """Taints/Tolerations (predicates.go:161): only tolerating pods land on
    the tainted node; the others go to the clean node."""
    c.queue(f"{ns}-q", 1)
    tainted = c.node_obj(f"{ns}-tainted", cpu_m=4000)
    tainted["spec"]["taints"] = [
        {"key": "dedicated", "value": "ml", "effect": "NoSchedule"}]
    c.create(_COLLECTIONS["nodes"], tainted)
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-clean", cpu_m=2000))
    c.podgroup(ns, "tol", 3, f"{ns}-q")
    tol = [{"key": "dedicated", "operator": "Equal", "value": "ml",
            "effect": "NoSchedule"}]
    for i in range(3):
        # selector pins tol pods to the tainted node: they can land there
        # ONLY via the toleration (the predicate under test), and the clean
        # node's exact capacity stays reserved for the plain gang
        c.pod(ns, f"tol{i}", "tol", tolerations=tol,
              node_selector={"kubernetes.io/hostname": f"{ns}-tainted"})
    c.podgroup(ns, "plain", 2, f"{ns}-q")
    for i in range(2):
        c.pod(ns, f"plain{i}", "plain")
    c.wait(lambda: c.n_on_nodes(ns) == 5, what="all pods placed")
    pods = c.pods(ns)
    for k, p in pods.items():
        name = k.split("/", 1)[1]
        on = p["spec"].get("nodeName")
        if name.startswith("plain"):
            assert on == f"{ns}-clean", (k, on)


def scenario_hostport(c: Cluster, ns: str) -> None:
    """Hostport (predicates.go:84): two pods claiming the same hostPort
    land on different nodes."""
    c.queue(f"{ns}-q", 1)
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-n1"))
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-n2"))
    c.podgroup(ns, "hp", 2, f"{ns}-q")
    for i in range(2):
        c.pod(ns, f"hp{i}", "hp", host_port=8080)
    c.wait(lambda: c.n_on_nodes(ns, "hp") == 2, what="hostport pods placed")
    nodes = {p["spec"]["nodeName"] for p in c.pods(ns).values()}
    assert len(nodes) == 2, f"hostPort conflict ignored: {nodes}"


def scenario_volume(c: Cluster, ns: str) -> None:
    """Local-PV reachability (the volumebinder feed, cache.go:189-209): a
    pod claiming an unbound no-provisioner PVC lands ONLY on the node its
    static PV is reachable from, and the scheduler pre-binds the PV
    (claimRef) cluster-side."""
    c.queue(f"{ns}-q", 1)
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-a"))
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-b"))
    c.create(_COLLECTIONS["storageclasses"], {
        "apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
        "metadata": {"name": f"{ns}-local"},
        "provisioner": "kubernetes.io/no-provisioner",
        "volumeBindingMode": "WaitForFirstConsumer",
    })
    c.create(_COLLECTIONS["persistentvolumes"], {
        "apiVersion": "v1", "kind": "PersistentVolume",
        "metadata": {"name": f"{ns}-pv"},
        "spec": {
            "capacity": {"storage": "10Gi"},
            "accessModes": ["ReadWriteOnce"],
            "storageClassName": f"{ns}-local",
            "local": {"path": "/mnt/ssd0"},
            "nodeAffinity": {"required": {"nodeSelectorTerms": [
                {"matchExpressions": [{"key": "kubernetes.io/hostname",
                                       "operator": "In",
                                       "values": [f"{ns}-b"]}]}
            ]}},
        },
        "status": {"phase": "Available"},
    })
    c.create(f"/api/v1/namespaces/{ns}/persistentvolumeclaims", {
        "apiVersion": "v1", "kind": "PersistentVolumeClaim",
        "metadata": {"name": "data", "namespace": ns},
        "spec": {"accessModes": ["ReadWriteOnce"],
                 "resources": {"requests": {"storage": "5Gi"}},
                 "storageClassName": f"{ns}-local"},
        "status": {"phase": "Pending"},
    })
    c.podgroup(ns, "stateful", 1, f"{ns}-q")
    pod = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "stateful-0", "namespace": ns,
                     "uid": f"{ns}-stateful-0-uid",
                     "annotations": {"scheduling.k8s.io/group-name": "stateful"}},
        "spec": {
            "schedulerName": SCHED,
            "containers": [{"name": "c", "image": "busybox",
                            "resources": {"requests": {"cpu": "500m",
                                                       "memory": "1Gi"}}}],
            "volumes": [{"name": "v",
                         "persistentVolumeClaim": {"claimName": "data"}}],
        },
        "status": {"phase": "Pending"},
    }
    c.create(f"/api/v1/namespaces/{ns}/pods", pod)
    c.wait(lambda: (c.pods(ns).get(f"{ns}/stateful-0") or {}).get(
        "spec", {}).get("nodeName") == f"{ns}-b",
        what="stateful pod on the PV's node")

    def claim_ref_landed():
        pv = c.t.get_json(f"/api/v1/persistentvolumes/{ns}-pv")
        ref = (pv.get("spec") or {}).get("claimRef") or {}
        return ref.get("name") == "data"
    c.wait(claim_ref_landed, timeout=30, what="PV claimRef pre-bound")


def scenario_job_priority(c: Cluster, ns: str) -> None:
    """Job priority (job.go:410): when both jobs are pending and capacity
    fits only one, the PriorityClass-backed job wins it atomically."""
    c.queue(f"{ns}-q", 1)
    c.create(_COLLECTIONS["priorityclasses"], {
        "apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
        "metadata": {"name": f"{ns}-high"}, "value": 1000,
    })
    c.create(_COLLECTIONS["nodes"], c.node_obj(f"{ns}-n1", cpu_m=4000))
    # low submitted FIRST (earlier creation would win a priority tie)
    c.podgroup(ns, "low", 4, f"{ns}-q")
    for i in range(4):
        c.pod(ns, f"low{i}", "low")
    c.podgroup(ns, "high", 4, f"{ns}-q")
    for i in range(4):
        c.pod(ns, f"high{i}", "high", priority=1000)
    c.wait(lambda: c.n_on_nodes(ns, "high") == 4, timeout=60,
           what="high-priority job placed first")
    assert c.n_on_nodes(ns, "low") == 0, "low job took the contended capacity"


SCENARIOS = {
    "gang": scenario_gang,
    "gang_full": scenario_gang_full,
    "preemption": scenario_preemption,
    "reclaim": scenario_reclaim,
    "proportion": scenario_proportion,
    "node_selector": scenario_node_selector,
    "taints": scenario_taints,
    "hostport": scenario_hostport,
    "volume": scenario_volume,
    "job_priority": scenario_job_priority,
}


def namespace_of(name: str) -> str:
    return f"e2e-{name.replace('_', '-')}"


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _master_argv(master: str, extra_args=()) -> List[str]:
    """The scheduler's flags against ``master`` (the shipped five-action
    conf, a quick schedule period, a free listen port)."""
    from kube_batch_tpu_torch.framework.conf import shipped_conf_path

    return ["--master", master, "--listen-address", "127.0.0.1:0",
            "--schedule-period", "0.25", "--scheduler-conf", shipped_conf_path(),
            *extra_args]


@contextlib.contextmanager
def scheduler_process(master: str, extra_args=(), device: str = "cuda", **auth):
    """The REAL CLI scheduler (``python -m kube_batch_tpu_torch.cmd.main
    --master ...``, the shipped 5-action conf) as a subprocess — exactly
    the deployment shape; ``device="cpu"`` runs ``main(..., device="cpu")``
    (``server_drive.CPU_ENTRY``).  Yields the Popen; logs drain to a temp
    file (an undrained PIPE would block the scheduler mid-run), surfaced
    on error."""
    import subprocess
    import tempfile

    from kube_batch_tpu_torch.testing.server_drive import CPU_ENTRY, ROOT

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    # hand the scheduler subprocess the same credentials the scenario
    # client carries (in_cluster_auth reads these overrides)
    token_tmp = None
    if auth.get("token"):
        token_tmp = tempfile.NamedTemporaryFile("w", delete=False, suffix=".token")
        token_tmp.write(auth["token"])
        token_tmp.close()
        env["KB_KUBE_TOKEN_FILE"] = token_tmp.name
    if auth.get("insecure"):
        env["KB_KUBE_INSECURE"] = "1"
    entry = ["-c", CPU_ENTRY] if device == "cpu" else ["-m", "kube_batch_tpu_torch.cmd.main"]
    cmd = [sys.executable, *entry, *_master_argv(master, extra_args)]
    logf = tempfile.NamedTemporaryFile("w+", delete=False, suffix=".sched.log")
    proc = subprocess.Popen(cmd, env=env, stdout=logf, stderr=subprocess.STDOUT,
                            text=True, cwd=str(ROOT))
    try:
        yield proc
    except Exception:
        logf.flush()
        try:
            with open(logf.name) as f:
                logger.error("scheduler process output:\n%s", f.read()[-4000:])
        except OSError:
            pass
        raise
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)
        logf.close()
        os.unlink(logf.name)
        if token_tmp is not None:
            os.unlink(token_tmp.name)


@contextlib.contextmanager
def scheduler_thread(master: str, extra_args=(), device=None):
    """The same scheduler built in this process (``StandaloneServer`` with
    ``--master``: the build seeds from the apiserver and returns synced)
    with its loop on a thread; yields the server.  On exit the loop stops,
    the server closes and the watch threads are joined (their streams end
    when the apiserver closes them, so the caller stops the stub first
    or the join waits its timeout).  ``device=None`` means CUDA."""
    from kube_batch_tpu_torch.cmd import options
    from kube_batch_tpu_torch.cmd.server import StandaloneServer

    server = StandaloneServer(options.parse(_master_argv(master, extra_args)), device=device)
    loop = threading.Thread(target=server.serve, daemon=True, name="e2e-scheduler")
    loop.start()
    try:
        yield server
    finally:
        server.sched.stop()
        loop.join(60)
        server.close()
        if loop.is_alive():
            raise RuntimeError("the scheduler loop did not stop")


def run_scenario(name: str, master: str, device: str = "cuda", **auth) -> None:
    """One scenario: scheduler up, scenario body, scheduler DOWN, then
    teardown — deleting the scenario's objects under a live scheduler would
    bury failure-time log diagnostics in teardown-reaction noise."""
    c = Cluster(master, **auth)
    try:
        with scheduler_process(master, device=device, **auth) as proc:
            c.ensure_namespace(namespace_of(name))
            SCENARIOS[name](c, ns=namespace_of(name))
            if proc.poll() is not None:
                raise RuntimeError(
                    f"scheduler exited early rc={proc.returncode}")
    finally:
        c.teardown()


def run_density(master: str, n_pods: int = 3000, n_nodes: int = 100,
                gang: int = 100, device: str = "cuda", **auth) -> dict:
    """The kubemark density benchmark at the LIVE protocol level
    (test/kubemark + test/e2e/benchmark.go:53-285): N hollow nodes, a
    minMember=`gang` gang, then `n_pods` 1m-cpu latency pods — all through
    the real apiserver protocol (watch in, Binding POSTs out), measuring
    per-pod create→bind PodStartupLatency percentiles."""
    ns = "e2e-density"
    c = Cluster(master, **auth)
    c.apply_crds()
    c.ensure_namespace(ns)
    # density is a THROUGHPUT measurement: lift the client egress throttle
    # (kube-api-qps 50 would serialize the per-cycle status writeback into
    # the latency signal; the reference's kubemark rig tunes QPS up too);
    # teardown runs AFTER the scheduler process exits (see run_scenario)
    with contextlib.ExitStack() as stack:
        stack.callback(c.teardown)
        stack.enter_context(scheduler_process(master, extra_args=(
            "--kube-api-qps", "5000", "--kube-api-burst", "10000"),
            device=device, **auth))
        c.queue(f"{ns}-q", 1)
        for i in range(n_nodes):
            c.create(_COLLECTIONS["nodes"],
                     c.node_obj(f"{ns}-n{i}", cpu_m=32000, mem_gi=64))
        # phase 1: the density gang (benchmark.go:50,61-71)
        c.podgroup(ns, "gang", gang, f"{ns}-q")
        for i in range(gang):
            c.pod(ns, f"gang-{i}", "gang", cpu_m=10)
        c.wait(lambda: c.n_on_nodes(ns, "gang-") == gang, timeout=120,
               what="density gang scheduled")
        # phase 2: latency pods in node-count batches (benchmark.go:74-110)
        created_at: Dict[str, float] = {}
        for i in range(n_pods):
            name = f"lat-{i}"
            c.podgroup(ns, name, 1, f"{ns}-q")
            created_at[name] = time.perf_counter()
            c.pod(ns, name, name, cpu_m=1)
        bound_at: Dict[str, float] = {}

        def all_bound():
            now = time.perf_counter()
            for key, p in c.pods(ns).items():
                name = key.split("/", 1)[1]
                if (name.startswith("lat-") and name not in bound_at
                        and (p.get("spec") or {}).get("nodeName")):
                    bound_at[name] = now
            return len(bound_at) >= n_pods
        # 1s poll: each poll LISTs every pod; tighter polling would load
        # the single-core stub more than it refines the percentiles
        c.wait(all_bound, timeout=600, what="latency pods scheduled",
               interval=1.0)
        lat = sorted(
            (bound_at[k] - created_at[k]) * 1e3 for k in bound_at
        )
        if not lat:
            return {"pods": 0, "nodes": n_nodes, "gang": gang}

        def pct(p):
            return round(nearest_rank(lat, p), 1)
        return {
            "pods": n_pods, "nodes": n_nodes, "gang": gang, "device": device,
            "startup_p50_ms": pct(0.50), "startup_p90_ms": pct(0.90),
            "startup_p99_ms": pct(0.99),
            "note": "create->bind wall clock through the live watch/bind "
                    "protocol; resolution = the poll interval. Against the "
                    "--stub apiserver the protocol endpoint (pure-Python "
                    "HTTP on this host) bounds throughput, not the "
                    "scheduler.",
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--master", help="apiserver URL (kind / real cluster)")
    ap.add_argument("--stub", action="store_true",
                    help="run against the in-process stub apiserver")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the scheduler process runs (default: cuda)")
    ap.add_argument("--token", default=None)
    ap.add_argument("--insecure", action="store_true")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS),
                    help="comma-separated subset")
    ap.add_argument("--density", action="store_true",
                    help="run the kubemark density benchmark instead of the "
                         "behavioral scenarios")
    ap.add_argument("--density-pods", type=int, default=3000)
    ap.add_argument("--density-nodes", type=int, default=100)
    args = ap.parse_args(argv)
    if not args.stub and not args.master:
        ap.error("need --master URL or --stub")
    auth = {k: v for k, v in {"token": args.token, "insecure": args.insecure}.items() if v}

    if args.density:
        stub = None
        try:
            if args.stub:
                stub = StubApiServer()
                master = stub.start()
            else:
                master = args.master
            result = run_density(
                master, n_pods=args.density_pods, n_nodes=args.density_nodes,
                gang=min(100, args.density_pods), device=args.device, **auth)
            print(json.dumps(result), flush=True)
            return 0
        finally:
            if stub is not None:
                stub.stop()

    names = [s for s in args.scenarios.split(",") if s]
    failures = []
    t_all = time.time()
    for name in names:
        stub = None
        try:
            if args.stub:
                stub = StubApiServer()
                master = stub.start()
            else:
                master = args.master
            Cluster(master, **auth).apply_crds()
            t0 = time.time()
            run_scenario(name, master, device=args.device, **auth)
            print(f"PASS {name} ({time.time() - t0:.1f}s)", flush=True)
        except Exception as e:  # noqa: BLE001
            failures.append(name)
            print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
        finally:
            if stub is not None:
                stub.stop()
    print(f"{len(names) - len(failures)}/{len(names)} scenarios passed "
          f"({time.time() - t_all:.1f}s, device {args.device})", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
