"""The Kubernetes front end's drive for ``chip_smoke.py``: the headline
cluster listed from an apiserver and bound over the wire.

``drive_k8s(n_tasks, n_nodes, arrivals, device=)`` starts the port's
``testing/e2e.StubApiServer`` in a child process of its own (a fresh
interpreter with no card, so neither the listing nor the Binding POSTs
share the scheduler's interpreter), preloaded there with
``synthetic_cluster(n_tasks, n_nodes, gang_size=4, n_queues=3, seed=0)``
written as Kubernetes JSON by this module's ``*_to_k8s`` writers (queues
and PodGroups as CRDs, nodes, pods with ``schedulerName`` and the group
annotation).  The scheduler is ``StandaloneServer`` built in this process
with ``--master <stub>``, the shipped conf and the egress bucket opened as
the density run opens it (``--kube-api-qps 5000 --kube-api-burst 10000``):
its build lists every resource through the watch adapter and returns
synced; ``serve`` then runs on a thread.  The drive reads:

- each resource's LIST ms, apply ms and bytes, and the seed's ms up to
  ``mark_synced``;
- cycle 1's wall and stages, and the kernel launches at its end;
- the Binding POSTs: every pod of the cluster must land on the stub (its
  count of pods with ``spec.nodeName``), their rate, and the ms from
  cycle 1's end to the last one; the binds digest read off the cache's
  acked binds (``server_drive.bindings_digest``, held by ``chip_smoke.py``
  against the headline drive's cycle 1);
- the watch's MODIFIED echo: the ms from the last Binding to every pod
  Running in the cache;
- the status writes (PodGroup, pod-condition and Queue PATCHes): count
  and the time spent in them;
- the headline drive's arrivals (``cycle_drive.add_arrivals``) created on
  the stub one POST at a time, PodGroups first, by a client process of
  their own (as ``e2e.run_density``'s test process creates its pods): each
  arrival's create → bind ms (its Binding's time at the stub less the
  client's clock just before its create POST), p50 and p99, and the
  launches of the cycles after cycle 1;
- at the end, with the loop stopped: the column store consistent, every
  bound pod in the cache bound on the stub, the watch threads joined once
  the stub stopped, the PV ledger's writer and retry timer closed.

    python -m kube_batch_tpu_torch.testing.k8s_drive --device cpu --tasks 2048 --nodes 256

rehearses it on the CPU (``device=None`` means CUDA); ``--serve-stub``
and ``--create-from`` are the child processes' entries.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import resource
import select
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

from kube_batch_tpu_torch.api.pod import Node, Pod, PodGroup, Queue
from kube_batch_tpu_torch.k8s.translate import parse_quantity
from kube_batch_tpu_torch.testing.server_drive import (
    ROOT, SEED, bindings_digest, call, fail, pct, wait_for)

#: the egress bucket as the density run opens it (testing/e2e.run_density)
DENSITY_BUCKET = ["--kube-api-qps", "5000", "--kube-api-burst", "10000"]
#: cycles with no new arrival bound after which the arrivals count as settled
QUIET_CYCLES = 3

_CRD_GROUP = "scheduling.incubator.k8s.io/v1alpha1"
#: where the arrivals' client POSTs each kind
PATHS = {"podgroups": f"/apis/{_CRD_GROUP}/namespaces/{{ns}}/podgroups",
         "pods": "/api/v1/namespaces/{ns}/pods"}


# --------------------------------------------------------------------------
# framework objects → Kubernetes JSON (k8s/translate.py reads them back)
# --------------------------------------------------------------------------


def _timestamp(creation_index: int) -> str:
    """``creation_index`` as the creationTimestamp ``creation_index_of``
    reads back (epoch seconds)."""
    return datetime.datetime.fromtimestamp(
        creation_index, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _quantity(name: str, value: float) -> str:
    """One framework value (cpu millicores, memory bytes, pods, scalars in
    milli units) as the quantity string that parses back to it exactly."""
    scale = 1.0 if name in ("memory", "pods") else 1000.0
    forms = ([f"{int(value)}m"] if scale == 1000.0 and value == int(value) else []) \
        + ([str(int(value))] if scale == 1.0 and value == int(value) else []) \
        + [repr(value / scale)]
    for text in forms:
        if parse_quantity(text) * scale == value:
            return text
    raise ValueError(f"{name}={value!r} has no quantity that reads back exactly")


def _quantities(values) -> dict:
    return {k: _quantity(k, float(v)) for k, v in (values or {}).items()}


def _metadata(name: str, namespace, uid: str, creation_index: int) -> dict:
    meta = {"name": name, "uid": uid}
    if namespace is not None:
        meta["namespace"] = namespace
    if creation_index:
        meta["creationTimestamp"] = _timestamp(creation_index)
    return meta


def pod_to_k8s(pod: Pod) -> dict:
    """A v1.Pod whose ``pod_from_k8s`` equals ``pod`` (affinity and init
    containers are not written: the synthetic clusters carry none)."""
    if pod.affinity is not None or pod.init_requests:
        raise ValueError(f"pod {pod.key()}: affinity and init requests are not written")
    meta = _metadata(pod.name, pod.namespace, pod.uid, pod.creation_index)
    if pod.labels:
        meta["labels"] = dict(pod.labels)
    if pod.annotations:
        meta["annotations"] = dict(pod.annotations)
    if pod.deleting:
        meta["deletionTimestamp"] = _timestamp(pod.creation_index)
    if pod.owner is not None:
        meta["ownerReferences"] = [{"kind": "ReplicaSet", "name": pod.owner,
                                    "uid": pod.owner, "controller": True}]
    container = {"name": "main", "resources": {"requests": _quantities(pod.requests)}}
    if pod.host_ports:
        container["ports"] = [{"containerPort": p, "hostPort": p} for p in pod.host_ports]
    spec = {"schedulerName": pod.scheduler_name, "containers": [container]}
    if pod.priority:
        spec["priority"] = pod.priority
    if pod.priority_class:
        spec["priorityClassName"] = pod.priority_class
    if pod.node_name:
        spec["nodeName"] = pod.node_name
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if pod.tolerations:
        spec["tolerations"] = [{"key": t.key, "operator": t.operator, "value": t.value,
                                "effect": t.effect} for t in pod.tolerations]
    if pod.volume_claims:
        spec["volumes"] = [{"name": f"v{i}", "persistentVolumeClaim": {"claimName": c}}
                           for i, c in enumerate(pod.volume_claims)]
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": spec,
            "status": {"phase": pod.phase.value}}


def node_to_k8s(node: Node) -> dict:
    """A v1.Node whose ``node_from_k8s`` equals ``node``."""
    spec: dict = {}
    if node.taints:
        spec["taints"] = [{"key": t.key, "value": t.value, "effect": t.effect}
                          for t in node.taints]
    if node.unschedulable:
        spec["unschedulable"] = True
    conditions = [{"type": "Ready", "status": "True" if node.ready else "False"}]
    conditions += [{"type": k, "status": "True" if v else "False"}
                   for k, v in node.conditions.items()]
    meta = {"name": node.name}
    if node.labels:
        meta["labels"] = dict(node.labels)
    return {"apiVersion": "v1", "kind": "Node", "metadata": meta, "spec": spec,
            "status": {"allocatable": _quantities(node.allocatable),
                       "capacity": _quantities(node.capacity),
                       "conditions": conditions}}


def pod_group_to_k8s(pg: PodGroup) -> dict:
    """A PodGroup CRD whose ``pod_group_from_k8s`` equals ``pg`` (its
    conditions are status the scheduler writes, not read back)."""
    spec = {"minMember": pg.min_member, "queue": pg.queue}
    if pg.priority_class:
        spec["priorityClassName"] = pg.priority_class
    if pg.min_resources:
        spec["minResources"] = _quantities(pg.min_resources)
    status = {k: v for k, v in (("running", pg.running), ("succeeded", pg.succeeded),
                                ("failed", pg.failed)) if v}
    if pg.phase is not None:
        status["phase"] = pg.phase.value
    return {"apiVersion": _CRD_GROUP, "kind": "PodGroup",
            "metadata": _metadata(pg.name, pg.namespace, pg.uid, pg.creation_index),
            "spec": spec, "status": status}


def queue_to_k8s(q: Queue) -> dict:
    """A Queue CRD whose ``queue_from_k8s`` equals ``q``."""
    spec: dict = {"weight": q.weight}
    if q.capability:
        spec["capability"] = _quantities(q.capability)
    return {"apiVersion": _CRD_GROUP, "kind": "Queue",
            "metadata": _metadata(q.name, None, q.uid, 0), "spec": spec}


def cluster_objects(n_tasks: int, n_nodes: int) -> Dict[str, list]:
    """``synthetic_cluster``'s objects as Kubernetes JSON, kind by kind in
    its handler order (queues, nodes, PodGroups, pods)."""
    from kube_batch_tpu_torch.testing.cycle_drive import GANG, N_QUEUES
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    src = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES, seed=SEED)
    try:
        return {
            "queues": [queue_to_k8s(q.queue) for q in src.queues.values()],
            "nodes": [node_to_k8s(n.node) for n in src.nodes.values()],
            "podgroups": [pod_group_to_k8s(j.pod_group) for j in src.jobs.values()
                          if j.pod_group is not None],
            "pods": [pod_to_k8s(p) for p in src.pods.values()],
        }
    finally:
        src.stop()


def arrival_objects(queues, n_pods: int) -> Dict[str, list]:
    """``cycle_drive.add_arrivals``' PodGroups and pods (the headline
    drive's arrivals) as Kubernetes JSON."""
    from kube_batch_tpu_torch.testing.cycle_drive import add_arrivals
    from kube_batch_tpu_torch.testing.server_drive import _Recorder

    rec = _Recorder(queues)
    add_arrivals(rec, n_pods, SEED + 1, "arrive")
    return {"podgroups": [pod_group_to_k8s(pg) for pg in rec.pod_groups],
            "pods": [pod_to_k8s(p) for p in rec.pods]}


# --------------------------------------------------------------------------
# the apiserver in a child process
# --------------------------------------------------------------------------


def serve_stub(n_tasks: int, n_nodes: int) -> None:
    """The child: preload the stub, print its URL as one JSON line, serve
    until stdin closes."""
    from kube_batch_tpu_torch.testing.e2e import StubApiServer

    t = time.perf_counter()
    objects = cluster_objects(n_tasks, n_nodes)
    stub = StubApiServer()
    for kind in ("queues", "nodes", "podgroups", "pods"):
        stub.load(kind, objects[kind])
    del objects
    url = stub.start()
    print(json.dumps({"url": url, "preload_s": time.perf_counter() - t}), flush=True)
    try:
        sys.stdin.read()
    finally:
        stub.stop()


def _module_process(args, stdin=subprocess.PIPE) -> subprocess.Popen:
    """``python -m kube_batch_tpu_torch.testing.k8s_drive <args>``, a fresh
    interpreter with no card (started, not forked: CUDA may be up here)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-m", "kube_batch_tpu_torch.testing.k8s_drive",
                             *args], cwd=str(ROOT), env=env, stdin=stdin,
                            stdout=subprocess.PIPE, text=True)


class StubProcess:
    """The stub's child process.  The constructor starts it and returns at
    once (its preload runs while the caller works on); :meth:`wait_ready`
    reads its URL; :meth:`stop` closes its stdin and waits for it to exit
    (killing it past the wait)."""

    def __init__(self, n_tasks: int, n_nodes: int):
        self.proc = _module_process(["--serve-stub", "--tasks", str(n_tasks),
                                     "--nodes", str(n_nodes)])
        self.url = self.preload_s = self.exit_code = None

    def wait_ready(self, timeout: float = 600) -> str:
        if self.url is None:
            ready, _, _ = select.select([self.proc.stdout], [], [], timeout)
            line = self.proc.stdout.readline() if ready else ""
            if not line:
                fail(f"the stub process did not start (exit {self.proc.poll()})")
            hello = json.loads(line)
            self.url, self.preload_s = hello["url"], hello["preload_s"]
        return self.url

    def get(self, path: str):
        status, body, _ = call(self.url, "GET", path)
        if status != 200:
            fail(f"stub GET {path}: {status}")
        return json.loads(body)

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self.exit_code = self.proc.returncode
        return self.exit_code


def create_objects(url: str, path: str) -> None:
    """The arrivals' client (a process of its own, as ``e2e.run_density``'s
    test process is): POST each [collection path, object] of the JSON file
    at ``path`` in order, one request each; print each pod's creation time
    (wall clock, just before its POST) as one JSON object."""
    from kube_batch_tpu_torch.k8s.transport import ApiTransport

    with open(path) as f:
        posts = json.load(f)
    client = ApiTransport(url)
    created: Dict[str, float] = {}
    for collection, obj in posts:
        meta = obj["metadata"]
        if obj["kind"] == "Pod":
            created[f"{meta['namespace']}/{meta['name']}"] = time.time()
        client.request("POST", collection, obj)
    print(json.dumps(created), flush=True)


class TimedStatusUpdater:
    """Times the status writes passing through the cache's updater: calls
    and busy ms per kind (the 16-thread pool overlaps them, so the busy
    ms is summed thread time, not wall)."""

    def __init__(self, inner):
        self._inner = inner
        self._lock = threading.Lock()
        self.calls: Dict[str, int] = {}
        self.busy_ms: Dict[str, float] = {}
        self.first = self.last = None

    def __getattr__(self, name):  # parallel_safe, degraded
        return getattr(self._inner, name)

    def _timed(self, kind: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.calls[kind] = self.calls.get(kind, 0) + 1
                self.busy_ms[kind] = self.busy_ms.get(kind, 0.0) + (t1 - t0) * 1e3
                self.first = t0 if self.first is None else min(self.first, t0)
                self.last = t1 if self.last is None else max(self.last, t1)

    def update_pod_group(self, pg):
        return self._timed("podgroup", self._inner.update_pod_group, pg)

    def update_pod_condition(self, pod, cond):
        return self._timed("pod_condition", self._inner.update_pod_condition, pod, cond)

    def update_queue_status(self, name, counts):
        return self._timed("queue", self._inner.update_queue_status, name, counts)


# --------------------------------------------------------------------------
# the drive
# --------------------------------------------------------------------------


def _own_cpu_s() -> float:
    """This process's CPU seconds, every thread (the scheduler's side)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def drive_k8s(n_tasks: int, n_nodes: int, arrivals: int, device=None,
              stub: StubProcess = None) -> dict:
    """The headline cluster through the apiserver (module docstring).
    ``stub``: a :class:`StubProcess` of the same size started earlier (its
    preload then overlaps the caller's work); the drive stops it.  Returns
    the report; raises on a failed check."""
    stub = stub if stub is not None else StubProcess(n_tasks, n_nodes)
    try:
        stub.wait_ready()
        return _drive(stub, n_tasks, n_nodes, arrivals, device)
    finally:
        stub.stop()


def _drive(stub: StubProcess, n_tasks: int, n_nodes: int, arrivals: int, device) -> dict:
    from kube_batch_tpu_torch.api.types import PodPhase
    from kube_batch_tpu_torch.cmd import options
    from kube_batch_tpu_torch.cmd.server import StandaloneServer
    from kube_batch_tpu_torch.framework.conf import shipped_conf_path
    from kube_batch_tpu_torch.ops import kernels

    report: dict = dict(tasks=n_tasks, nodes=n_nodes, arrivals=arrivals,
                        stub_preload_s=stub.preload_s)
    opt = options.parse(["--master", stub.url, "--listen-address", "127.0.0.1:0",
                         "--scheduler-conf", shipped_conf_path()] + DENSITY_BUCKET)
    t = time.perf_counter()
    server = StandaloneServer(opt, device=device)
    report["build_s"] = time.perf_counter() - t
    cache, sched, watcher = server.cache, server.sched, server.watcher
    report["device"] = str(server.device)
    listed = stub.get("/stub/stats")
    report["seed"] = dict(
        synced_ms=watcher.seeded_ms,
        resources={k: dict(v, bytes=listed["list_bytes"].get(k, 0))
                   for k, v in sorted(watcher.seed_stats.items())})
    if len(cache.pods) != n_tasks or len(cache.nodes) != n_nodes:
        fail(f"the seed listed {len(cache.pods)} pods and {len(cache.nodes)} nodes")
    timed = cache.status_updater = TimedStatusUpdater(cache.status_updater)
    ends: List[tuple] = []
    actions = {a.name: a for a in sched.actions}
    programs: List[dict] = []  # per cycle: allocate's program, enqueue's gate rows

    def on_cycle_end():
        ends.append((time.time(), time.perf_counter(), dict(kernels.launches),
                     dict(sched.last_cycle_ms)))
        programs.append({"compacted": actions["allocate"].last_topk is not None,
                         "gate_rows": actions["enqueue"].last_gate_rows})

    sched.on_cycle_end = on_cycle_end
    loop = threading.Thread(target=server.serve, daemon=True, name="k8s-drive-loop")
    stopped = False
    try:
        kernels.reset_launches()
        loop.start()
        wait_for(lambda: ends, 900, "cycle 1")
        c1_wall, _c1_perf, c1_launches, c1_ms = ends[0]
        report["cycle1"] = dict(ms=c1_ms, launches=c1_launches)

        def bound_on_stub():
            return stub.get("/stub/stats")["pods_on_nodes"]

        stub_cpu0, own_cpu0, t_cpu0 = stub.get("/stub/stats")["cpu_s"], _own_cpu_s(), time.time()
        wait_for(lambda: bound_on_stub() >= n_tasks, 900,
                 f"{n_tasks} Binding POSTs on the stub", poll=0.25)
        stub_cpu1, own_cpu1, t_cpu1 = stub.get("/stub/stats")["cpu_s"], _own_cpu_s(), time.time()
        bound_at = stub.get("/stub/bound")
        stamps = sorted(bound_at.values())
        # the cache's acked binds of cycle 1 (every pod was pending)
        cache.flush_binds()
        with cache._lock:
            acked = {k: p.node_name for k, p in cache.pods.items() if p.node_name}
        if len(acked) != n_tasks:
            fail(f"cycle 1: {len(acked)} acked binds of {n_tasks}")
        report["cycle1_bindings_digest"] = bindings_digest(acked)
        report["binds"] = dict(
            posts=len(stamps), per_s=len(stamps) / max(stamps[-1] - stamps[0], 1e-9),
            cycle1_end_to_last_post_ms=(stamps[-1] - c1_wall) * 1e3,
            cycle1_end_to_first_post_ms=(stamps[0] - c1_wall) * 1e3,
            # CPU seconds each process spent from cycle 1's end to the last
            # Binding seen, against the wall: which side bounds the rate
            window_cpu_s=dict(stub=stub_cpu1 - stub_cpu0, scheduler=own_cpu1 - own_cpu0,
                              wall=t_cpu1 - t_cpu0))

        def echoed():
            with cache._lock:
                return all(p.phase == PodPhase.RUNNING for p in cache.pods.values())

        wait_for(echoed, 900, "the watch's MODIFIED echo of every bind", poll=0.05)
        report["echo_tail_ms"] = (time.time() - stamps[-1]) * 1e3
        report["status_writes_cycle1"] = dict(
            calls=dict(timed.calls), busy_ms=dict(timed.busy_ms),
            span_ms=None if timed.first is None else (timed.last - timed.first) * 1e3)

        # the arrivals, created on the apiserver one POST at a time
        launches_before = dict(kernels.launches)
        queues = sorted(cache.queues)
        objs = arrival_objects(queues, arrivals)
        posts = ([(PATHS["podgroups"].format(ns=o["metadata"]["namespace"]), o)
                  for o in objs["podgroups"]]
                 + [(PATHS["pods"].format(ns=o["metadata"]["namespace"]), o)
                    for o in objs["pods"]])
        with tempfile.TemporaryDirectory(prefix="k8s-drive-") as tmp:
            path = os.path.join(tmp, "arrivals.json")
            with open(path, "w") as f:
                json.dump(posts, f)
            t0 = time.perf_counter()
            creator = _module_process(["--create-from", path, "--url", stub.url],
                                      stdin=subprocess.DEVNULL)
            out, _ = creator.communicate(timeout=900)
            report["arrivals_create_ms"] = (time.perf_counter() - t0) * 1e3
        if creator.returncode != 0:
            fail(f"the arrivals' client exited {creator.returncode}")
        created: Dict[str, float] = json.loads(out)

        # settled: every arrival bound, or some bound and QUIET_CYCLES
        # cycles ended since the count last moved (what the proportion
        # caps leave pending stays pending)
        last = {"bound": -1, "cycles": len(ends)}

        def settled():
            got = stub.get("/stub/stats")["pods_on_nodes"] - n_tasks
            if got != last["bound"]:
                last.update(bound=got, cycles=len(ends))
            return got >= arrivals or (got > 0 and len(ends) - last["cycles"] >= QUIET_CYCLES)

        wait_for(settled, 900, "the arrivals to bind", poll=0.25)
        cycles_seen = len(ends)
        wait_for(lambda: len(ends) > cycles_seen, 300, "one more cycle")
        sched.stop()
        loop.join(600)
        stopped = True
        if loop.is_alive():
            fail("the scheduler loop did not stop")
        cache.flush_binds()
        bound_at = stub.get("/stub/bound")
        lat = [(bound_at[k] - created[k]) * 1e3 for k in created if k in bound_at]
        after = {k: v - launches_before[k] for k, v in kernels.launches.items()}
        report["arrivals_bound"] = len(lat)
        report["arrivals_latency"] = dict(
            p50_ms=pct(lat, 50), p99_ms=pct(lat, 99), max_ms=max(lat) if lat else None,
            measured="Binding at the stub less the client's clock just before its create")
        report["cycles"] = len(ends)
        report["cycles_after_cycle1"] = len(ends) - 1
        report["compacted_cycles"] = sum(p["compacted"] for p in programs)
        report["gate_rows"] = [p["gate_rows"] for p in programs if p["gate_rows"]]
        if programs[0]["compacted"]:
            fail("cycle 1 ran the compacted program (every pod was pending)")
        report["launches_after_cycle1"] = after
        report["launches"] = dict(kernels.launches)
        report["status_writes"] = dict(
            calls=dict(timed.calls), busy_ms=dict(timed.busy_ms),
            stub_requests=stub.get("/stub/stats")["requests"])
        stats = stub.get("/stub/stats")
        with cache._lock:
            cache_bound = {k: p.node_name for k, p in cache.pods.items() if p.node_name}
        report["bound"] = dict(cache=len(cache_bound), stub=stats["pods_on_nodes"])
        if len(cache_bound) != stats["pods_on_nodes"]:
            fail(f"{len(cache_bound)} pods bound in the cache, {stats['pods_on_nodes']} "
                 "on the stub")
        t0 = time.perf_counter()
        errors = cache.columns.check_consistency(cache)
        report["consistency"] = dict(errors=errors[:5], ms=(time.perf_counter() - t0) * 1e3)
        if errors:
            fail(f"check_consistency after the k8s drive: {errors[:5]}")
        report["resync_parked"] = cache.resync.parked_total
        report["failed_cycles"] = sched.failed_cycles
        if sched.failed_cycles or sched.failed_writebacks:
            fail(f"{sched.failed_cycles} failed cycles, {sched.failed_writebacks} "
                 "failed writebacks")
    finally:
        if not stopped:
            sched.stop()
            loop.join(600)
        server.close()
    ledger = cache.volume_binder
    report["ledger_closed"] = ledger._writer is None and ledger._retry_timer is None
    stub.stop()
    report["stub_exit"] = stub.exit_code
    report["watch_joined"] = watcher.join(30)
    if not report["ledger_closed"] or not report["watch_joined"]:
        fail(f"close: ledger closed {report['ledger_closed']}, watch threads joined "
             f"{report['watch_joined']}")
    return report


def main() -> None:
    ap = argparse.ArgumentParser(prog="k8s_drive")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    ap.add_argument("--tasks", type=int, default=50_000)
    ap.add_argument("--nodes", type=int, default=5_000)
    ap.add_argument("--arrivals", type=int, default=5_000)
    ap.add_argument("--serve-stub", action="store_true",
                    help="serve the preloaded stub apiserver until stdin closes")
    ap.add_argument("--create-from", help="POST the [path, object] pairs of this "
                    "JSON file to --url, in order")
    ap.add_argument("--url")
    a = ap.parse_args()
    if a.serve_stub:
        serve_stub(a.tasks, a.nodes)
        return
    if a.create_from:
        create_objects(a.url, a.create_from)
        return
    print(json.dumps(drive_k8s(a.tasks, a.nodes, a.arrivals, device=a.device)))


if __name__ == "__main__":
    main()
