"""The port's list+watch front end (``kube_batch_tpu_torch/k8s/watch.py``
and ``translate.apply_event``) against the JAX package's: the same event
sequences through both packages' ``WatchAdapter.replay`` — the recorded
gang, the modify/delete sequence, the shuffled-duplicate fuzz and its
re-list — leave equal caches (each package's ``save_state`` file, the
PV ledgers, the task statuses); the recorded gang binds the same pods to
the same nodes in a real cycle of each package.  Then over real HTTP
against the port's ``testing/e2e.StubApiServer``: the seed (both packages'
adapters listing the same stub), bad objects isolated, live watch events,
the reconcile of a re-list, a 410 Gone after a lost stream (the re-list
deletes what vanished), and ``stop`` + ``join`` once the stub ends its
streams."""

from __future__ import annotations

import json
import re
import time

import numpy as np
import pytest

from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
from kube_batch_tpu_torch import actions as _port_actions  # noqa: F401 — registers
from kube_batch_tpu_torch import plugins as _port_plugins  # noqa: F401 — registers
from kube_batch_tpu_torch.testing.e2e import StubApiServer

import test_k8s_shim as shim
from test_torch_k8s_translate import canon
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

FIXTURES = shim.FIXTURES
GANG_CONF = """
actions: "enqueue, allocate, backfill"
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


class Pkg:
    """One package's cache (GPU scalar, K8sPVLedger), adapter and state."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            from kube_batch_tpu.api.resources import GPU, ResourceSpec
            from kube_batch_tpu.cache.cache import SchedulerCache
            from kube_batch_tpu.cache.persistence import save_state
            from kube_batch_tpu.cache.volume import K8sPVLedger
            from kube_batch_tpu.framework.conf import parse_scheduler_conf
            from kube_batch_tpu.k8s import WatchAdapter
            from kube_batch_tpu.scheduler import Scheduler
        else:
            from kube_batch_tpu_torch.api.resources import GPU, ResourceSpec
            from kube_batch_tpu_torch.cache.cache import SchedulerCache
            from kube_batch_tpu_torch.cache.persistence import save_state
            from kube_batch_tpu_torch.cache.volume import K8sPVLedger
            from kube_batch_tpu_torch.framework.conf import parse_scheduler_conf
            from kube_batch_tpu_torch.k8s import WatchAdapter
            from kube_batch_tpu_torch.scheduler import Scheduler
        self.cache = SchedulerCache(spec=ResourceSpec(scalar_names=(GPU,)),
                                    volume_binder=K8sPVLedger())
        self.WatchAdapter, self._save = WatchAdapter, save_state
        self._conf, self._Scheduler = parse_scheduler_conf, Scheduler
        self.adapter = WatchAdapter(self.cache, api_server="http://unused")

    def scheduler(self):
        kw = {} if self.name == "jax" else {"device": "cpu"}
        return self._Scheduler(self.cache, conf=self._conf(GANG_CONF), **kw)

    def state(self, tmp_path) -> dict:
        """The cache's save_state file with auto-generated uids masked (the
        two packages count them apart), the PV ledger and task statuses."""
        path = tmp_path / f"{self.name}.json"
        self._save(self.cache, str(path))
        text = re.sub(r'"uid": "(pod|pg|queue)-[^"]*-\d+"', '"uid": "<auto>"', path.read_text())
        vb = self.cache.volume_binder
        with self.cache._lock:
            tasks = {k: sorted((t, canon(task.status)) for t, task in j.tasks.items())
                     for k, j in self.cache.jobs.items()}
            phases = {k: canon(j.pod_group.phase) if j.pod_group else None
                      for k, j in self.cache.jobs.items()}
            used = {n: node.used.vec.tolist() for n, node in self.cache.nodes.items()}
        return dict(state=json.loads(text), pvs=canon(vb.pvs), claims=canon(vb.claims),
                    classes=dict(vb.storage_classes), bound=dict(vb.bound), tasks=tasks,
                    phases=phases, used=used)

    def stop(self):
        self.cache.stop()


@pytest.fixture
def pkgs():
    made = [Pkg("jax"), Pkg("port")]
    yield made
    for p in made:
        p.stop()


def _same(pkgs, tmp_path):
    a, b = (p.state(tmp_path) for p in pkgs)
    for key in a:
        assert a[key] == b[key], key
    errs = pkgs[1].cache.columns.check_consistency(pkgs[1].cache)
    assert errs == [], errs[:3]
    return b


def _node(name):
    n = json.loads(json.dumps(FIXTURES["node"]))
    n["metadata"]["name"] = name
    n["spec"]["taints"] = []
    return n


RECORDED = ([("priorityclasses", "ADDED", FIXTURES["priorityclass"]),
             ("queues", "ADDED", FIXTURES["queue"]),
             ("podgroups", "ADDED", FIXTURES["podgroup"]),
             ("nodes", "ADDED", FIXTURES["node"])]
            + [("pods", "ADDED", shim._gang_pod(i)) for i in range(4)])


def _modify_delete():
    done = json.loads(json.dumps(FIXTURES["pod_bound"]))
    done["status"]["phase"] = "Succeeded"
    cordoned = json.loads(json.dumps(FIXTURES["node"]))
    cordoned["spec"]["unschedulable"] = True
    return [[("queues", "ADDED", FIXTURES["queue"]), ("nodes", "ADDED", FIXTURES["node"]),
             ("pods", "ADDED", FIXTURES["pod_bound"])],
            [("pods", "MODIFIED", done)], [("pods", "DELETED", done)],
            [("nodes", "MODIFIED", cordoned)], [("nodes", "DELETED", cordoned)]]


def test_recorded_events_equal_caches(pkgs, tmp_path):
    for p in pkgs:
        p.adapter.replay(RECORDED)
    got = _same(pkgs, tmp_path)
    assert len(got["tasks"]["ml/train-job"]) == 4


def test_modify_and_delete_steps_equal_caches(pkgs, tmp_path):
    for step in _modify_delete():
        for p in pkgs:
            p.adapter.replay(step)
        _same(pkgs, tmp_path)


def test_volume_events_equal_ledgers(pkgs, tmp_path):
    q = shim.TestVolumeK8sMode.DEFAULT_QUEUE
    events = [("queues", "ADDED", q),
              ("storageclasses", "ADDED", FIXTURES["storageclass_local"]),
              ("storageclasses", "ADDED", FIXTURES["storageclass_dynamic"]),
              ("persistentvolumes", "ADDED", FIXTURES["pv_local"]),
              ("persistentvolumeclaims", "ADDED", FIXTURES["pvc_unbound"]),
              ("persistentvolumeclaims", "ADDED", FIXTURES["pvc_dynamic"]),
              ("nodes", "ADDED", _node("node-b")),
              ("pods", "ADDED", shim._pvc_pod("stateful-1", "train-data"))]
    for p in pkgs:
        p.adapter.replay(events)
    got = _same(pkgs, tmp_path)
    assert got["classes"] and got["claims"] and got["pvs"]
    for p in pkgs:
        p.adapter.replay([("persistentvolumeclaims", "DELETED", FIXTURES["pvc_unbound"]),
                          ("storageclasses", "DELETED", FIXTURES["storageclass_local"])])
        p.adapter._reconcile_deletions("persistentvolumes", [])
    got = _same(pkgs, tmp_path)
    assert not got["pvs"] and list(got["classes"]) == ["standard"]


@pytest.mark.parametrize("seed", range(4))
def test_shuffled_duplicate_fuzz_equal_caches(pkgs, tmp_path, seed):
    """tests/test_k8s_shim.py TestEventFuzz's multisets of ADDED /
    MODIFIED / DELETED per object, shuffled, then a full re-list as
    MODIFIED upserts: equal caches after each."""
    rng = np.random.default_rng(seed)
    objects = ([("queues", FIXTURES["queue"]),
                ("queues", {"metadata": {"name": "default"}, "spec": {"weight": 1}}),
                ("priorityclasses", FIXTURES["priorityclass"]),
                ("podgroups", FIXTURES["podgroup"]),
                ("storageclasses", FIXTURES["storageclass_local"]),
                ("persistentvolumes", FIXTURES["pv_local"]),
                ("persistentvolumeclaims", FIXTURES["pvc_unbound"]),
                ("poddisruptionbudgets", FIXTURES["pdb"])]
               + [("nodes", _node(f"n{i}")) for i in range(3)]
               + [("pods", shim._gang_pod(i)) for i in range(4)])
    events = []
    for kind, obj in objects:
        for _ in range(int(rng.integers(1, 4))):
            events.append((kind, str(rng.choice(["ADDED", "MODIFIED", "DELETED"])), obj))
    order = rng.permutation(len(events))
    for p in pkgs:
        p.adapter.replay([events[i] for i in order])
    _same(pkgs, tmp_path)
    for p in pkgs:
        p.adapter.replay([(k, "MODIFIED", o) for k, o in objects])
    _same(pkgs, tmp_path)


def test_recorded_gang_binds_equal_in_a_cycle(pkgs):
    """The recorded LIST+WATCH events → a real cycle of each package: the
    gang binds the same pods to the same nodes (all on node-a, through its
    taint by the toleration), priority resolved from the PriorityClass."""
    binds = []
    for p in pkgs:
        p.adapter.replay(RECORDED)
        p.cache.mark_synced()
        sched = p.scheduler()
        try:
            sched.run_once()
            p.cache.flush_binds()
        finally:
            sched.close()
        binds.append(dict(p.cache.binder.binds))
        assert p.cache.jobs["ml/train-job"].priority == 1000
    assert binds[0] == binds[1] and len(binds[1]) == 4
    assert set(binds[1].values()) == {"node-a"}
    assert pkgs[1].cache.columns.check_consistency(pkgs[1].cache) == []


def test_stream_factory_start():
    from kube_batch_tpu_torch.cache.cache import SchedulerCache
    from kube_batch_tpu_torch.k8s import WatchAdapter

    cache = SchedulerCache()

    def stream(kind):
        return {"nodes": [("ADDED", FIXTURES["node"])],
                "queues": [("ADDED", FIXTURES["queue"])]}.get(kind, [])

    adapter = WatchAdapter(cache, api_server="http://unused",
                           resources=("nodes", "queues"), stream_factory=stream)
    try:
        adapter.start()
        assert cache.wait_for_cache_sync()
        assert "node-a" in cache.nodes and "ml-queue" in cache.queues
        adapter.stop()
        assert adapter.join(5)
    finally:
        cache.stop()


# ---------------------------------------------------------------------------
# over HTTP against the port's stub apiserver
# ---------------------------------------------------------------------------


def _preload(stub: StubApiServer, bad_pod: bool = False):
    objs = {"priorityclasses": [FIXTURES["priorityclass"]], "queues": [FIXTURES["queue"]],
            "podgroups": [FIXTURES["podgroup"]], "nodes": [FIXTURES["node"]],
            "storageclasses": [FIXTURES["storageclass_local"]],
            "persistentvolumes": [FIXTURES["pv_local"]],
            "persistentvolumeclaims": [FIXTURES["pvc_unbound"]],
            "poddisruptionbudgets": [FIXTURES["pdb"]],
            "pods": [shim._gang_pod(i) for i in range(4)]}
    if bad_pod:
        objs["pods"].append({"metadata": {"name": "bad", "namespace": "ml"},
                             "spec": {"containers": [{"resources": {"requests": {
                                 "cpu": "not-a-quantity"}}}]}})
    for kind, items in objs.items():
        stub.load(kind, json.loads(json.dumps(items)))


def _wait(pred, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def test_seed_over_http_equal_to_the_jax_adapter(tmp_path):
    """Both packages' adapters list and watch the same stub: equal caches
    at sync; a bad object is dropped without poisoning the seed; the
    watch then carries a created and a deleted pod; stop + join once the
    stub ends its streams."""
    stub = StubApiServer()
    url = stub.start()
    _preload(stub, bad_pod=True)
    made = [Pkg("jax"), Pkg("port")]
    adapters = [p.WatchAdapter(p.cache, api_server=url) for p in made]
    try:
        for a in adapters:
            a.start()
        for p in made:
            assert p.cache.wait_for_cache_sync() and len(p.cache.pods) == 4
        _same(made, tmp_path)
        port = adapters[1]
        assert port.seeded_ms is not None
        assert port.seed_stats["pods"]["items"] == 5  # the bad one listed, dropped
        assert stub.stats()["list_bytes"]["pods"] > 0
        extra = shim._gang_pod(9)
        stub.create("pods", extra)
        stub.delete("pods", "ml/trainer-0")
        for p in made:
            _wait(lambda: "ml/trainer-9" in p.cache.pods
                  and "ml/trainer-0" not in p.cache.pods, f"{p.name}: the watch events")
        _same(made, tmp_path)
    finally:
        for a in adapters:
            a.stop()
        stub.stop()
        for p in made:
            p.stop()
    assert adapters[1].join(10)


def test_relist_reconciles_over_http(tmp_path):
    """An object gone from the listing without an event (a watch gap) is
    deleted by the re-list's reconcile — the stored pod, so its gang task
    and node accounting go with it."""
    stub = StubApiServer()
    url = stub.start()
    _preload(stub)
    bound = shim._gang_pod(5)
    bound["spec"]["nodeName"] = "node-a"
    bound["status"]["phase"] = "Running"
    stub.load("pods", [bound])
    p = Pkg("port")
    adapter = p.WatchAdapter(p.cache, api_server=url)
    try:
        adapter.start()
        assert "ml/trainer-5" in p.cache.jobs["ml/train-job"].tasks
        assert p.cache.nodes["node-a"].used.vec[0] > 0
        with stub._lock:
            del stub._store["pods"]["ml/trainer-5"]
        rv = adapter._seed("pods")
        assert rv == str(stub._rv)
        assert "ml/trainer-5" not in p.cache.pods
        assert "ml/trainer-5" not in p.cache.jobs["ml/train-job"].tasks
        assert p.cache.nodes["node-a"].used.vec[0] == 0.0
        assert p.cache.columns.check_consistency(p.cache) == []
    finally:
        adapter.stop()
        stub.stop()
        p.stop()
    assert adapter.join(10)


def test_gone_after_a_lost_stream_relists():
    """The streams drop while new watches are held; the store changes
    past the stub's one-event history; the resumed watch gets 410 Gone and
    re-lists: the deleted pod and node leave the cache, the created pod
    arrives, and the cache stays consistent."""
    stub = StubApiServer(history=1)
    url = stub.start()
    _preload(stub)
    p = Pkg("port")
    adapter = p.WatchAdapter(p.cache, api_server=url)
    try:
        adapter.start()
        assert len(p.cache.pods) == 4
        _wait(lambda: all(stub._watchers[k] for k in ("pods", "nodes")), "the watches open")
        stub.hold_watches()
        stub.drop_watches()
        _wait(lambda: not stub._watchers["pods"], "the pod stream to drop")
        stub.delete("pods", "ml/trainer-1")
        stub.delete("pods", "ml/trainer-2")
        stub.create("pods", shim._gang_pod(7))
        extra = _node("node-z")
        stub.create("nodes", extra)
        stub.delete("nodes", "node-z")
        stub.release_watches()
        _wait(lambda: set(p.cache.pods) == {"ml/trainer-0", "ml/trainer-3", "ml/trainer-7"},
              "the re-list after 410")
        assert "node-z" not in p.cache.nodes
        assert adapter.seed_stats["pods"]["items"] == 3
        assert p.cache.columns.check_consistency(p.cache) == []
    finally:
        adapter.stop()
        stub.release_watches()
        stub.stop()
        p.stop()
    assert adapter.join(10)
