"""The port's ``--master`` server against the port's stub apiserver
(``kube_batch_tpu_torch/testing/e2e.py``), on the CPU: the reference's
``gang``, ``gang_full`` and ``volume`` scenarios pass against
``StandaloneServer`` built in this process (the watch seeds it, binds POST
``pods/binding``, the PV ledger pre-binds the claim's PV by claimRef), each
scenario on a fresh stub and server as ``e2e.main`` runs them; the watch
threads join once the stub stops.

The ``slow`` tests mirror ``tests/test_e2e_live.py`` with port processes
on the CPU: ``python -m kube_batch_tpu_torch.testing.e2e --stub --device
cpu`` passes 10/10 scenarios, the density run binds 150 pods on 30
nodes, and two ``--leader-elect`` processes fail over through the stub's
Lease."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from kube_batch_tpu_torch.testing import e2e
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["gang", "gang_full", "volume"])
def test_scenario_against_the_master_server(name):
    stub = e2e.StubApiServer()
    master = stub.start()
    server = None
    try:
        c = e2e.Cluster(master)
        c.apply_crds()
        with e2e.scheduler_thread(master, device="cpu") as server:
            assert server.k8s_mode and server.cache.wait_for_cache_sync()
            ns = e2e.namespace_of(name)
            c.ensure_namespace(ns)
            e2e.SCENARIOS[name](c, ns=ns)
            assert server.sched.failed_cycles == 0
            binds = stub.stats()["requests"].get("POST pods/binding", 0)
            assert binds == {"gang": 6, "gang_full": 3, "volume": 1}[name]
            if name == "volume":
                assert server.cache.volume_binder.bound == {f"{ns}/data": f"{ns}-pv"}
    finally:
        stub.stop()
    assert server.watcher.join(10)


def _contested_events():
    """``scenario_proportion``'s cluster at the moment a quick scheduler
    reaches it: gold (weight 2) runs 4 pods and bronze (weight 1) runs 2
    on the one 6-cpu node, each with pods still pending."""
    c = e2e.Cluster.__new__(e2e.Cluster)
    ns = "p"
    events = [("queues", "ADDED", {"metadata": {"name": n}, "spec": {"weight": w}})
              for n, w in (("gold", 2), ("bronze", 1))]
    events.append(("nodes", "ADDED", e2e.Cluster.node_obj(c, "n1", cpu_m=6000)))
    events += [("podgroups", "ADDED", {"metadata": {"name": g, "namespace": ns, "uid": g},
                                       "spec": {"minMember": 1, "queue": q}})
               for g, q in (("gj", "gold"), ("bj", "bronze"))]
    for i in range(12):
        gold, k = i % 2 == 0, i // 2
        name, group = (f"gp{k}", "gj") if gold else (f"bp{k}", "bj")
        pod = {"metadata": {"name": name, "namespace": ns, "uid": name,
                            "creationTimestamp": f"2026-01-01T00:00:{i:02d}Z",
                            "annotations": {"scheduling.k8s.io/group-name": group}},
               "spec": {"schedulerName": e2e.SCHED, "containers": [
                   {"resources": {"requests": {"cpu": "1000m", "memory": "1Gi"}}}]},
               "status": {"phase": "Pending"}}
        if k < (4 if gold else 2):
            pod["spec"]["nodeName"] = "n1"
            pod["status"]["phase"] = "Running"
        events.append(("pods", "ADDED", pod))
    return events


def _one_shipped_cycle(pkg: str, events):
    if pkg == "jax":
        from kube_batch_tpu.cache.cache import SchedulerCache
        from kube_batch_tpu.framework.conf import load_scheduler_conf, shipped_conf_path
        from kube_batch_tpu.k8s import WatchAdapter
        from kube_batch_tpu.scheduler import Scheduler
        kw = {}
    else:
        from kube_batch_tpu_torch.cache.cache import SchedulerCache
        from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
        from kube_batch_tpu_torch.k8s import WatchAdapter
        from kube_batch_tpu_torch.scheduler import Scheduler
        kw = {"device": "cpu"}
    cache = SchedulerCache()
    WatchAdapter(cache, api_server="http://unused").replay(events)
    cache.mark_synced()
    sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()), **kw)
    try:
        sched.run_once()
        cache.flush_binds()
        return list(cache.evictor.evicts), dict(cache.binder.binds)
    finally:
        sched.close()
        cache.stop()


def test_proportion_scenarios_contested_state_evicts_alike():
    """What ``proportion`` meets when the scheduler is quick (ROADMAP Queue
    3): under the shipped conf the first tier's gang and conformance vote
    on reclaim victims, so proportion never protects a queue at its share,
    and reclaim evicts across both queues — in both packages, the same six
    pods.  The JAX package passes the scenario by reaching this state only
    after the scenario's check, its eviction solve still compiling."""
    from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
    from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
    from kube_batch_tpu_torch import actions as _port_actions  # noqa: F401 — registers
    from kube_batch_tpu_torch import plugins as _port_plugins  # noqa: F401 — registers

    events = _contested_events()
    port = _one_shipped_cycle("port", events)
    assert port == _one_shipped_cycle("jax", events)
    assert sorted(port[0]) == ["p/bp0", "p/bp1", "p/gp0", "p/gp1", "p/gp2", "p/gp3"]


def _run_e2e(*args, timeout=650):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return subprocess.run(
        [sys.executable, "-m", "kube_batch_tpu_torch.testing.e2e", "--stub",
         "--device", "cpu", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


@pytest.mark.slow
def test_e2e_scenarios_against_stub_apiserver():
    r = _run_e2e()
    assert r.returncode == 0, f"e2e driver failed:\n{r.stdout[-6000:]}\n{r.stderr[-2000:]}"
    assert "10/10 scenarios passed" in r.stdout, r.stdout[-3000:]


@pytest.mark.slow
def test_density_benchmark_against_stub():
    r = _run_e2e("--density", "--density-pods", "150", "--density-nodes", "30",
                 timeout=800)
    assert r.returncode == 0, f"{r.stdout[-4000:]}\n{r.stderr[-2000:]}"
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["pods"] == 150 and out["startup_p99_ms"] > 0


@pytest.mark.slow
def test_ha_failover_against_stub_apiserver():
    """Two port scheduler processes contend for the stub's
    coordination.k8s.io Lease; killing one leaves the other (or the
    standby taking over after the lease expires) scheduling new work."""
    stub = e2e.StubApiServer()
    master = stub.start()
    try:
        c = e2e.Cluster(master)
        c.apply_crds()
        c.ensure_namespace("ha")
        c.queue("ha-q", 1)
        c.create(e2e._COLLECTIONS["nodes"], c.node_obj("ha-n1"))
        ha_args = ("--leader-elect", "--lock-object-namespace", "kube-system")
        with e2e.scheduler_process(master, extra_args=ha_args, device="cpu") as a, \
                e2e.scheduler_process(master, extra_args=ha_args, device="cpu"):
            c.podgroup("ha", "j1", 1, "ha-q")
            c.pod("ha", "p1", "j1")
            c.wait(lambda: c.n_on_nodes("ha", "p1") == 1, timeout=120,
                   what="leader schedules")
            lease = stub._store["leases"].get("kube-system/kube-batch-tpu")
            assert lease and lease["spec"]["holderIdentity"]
            a.kill()
            a.wait(timeout=10)
            time.sleep(1.0)
            c.podgroup("ha", "j2", 1, "ha-q")
            c.pod("ha", "p2", "j2")
            c.wait(lambda: c.n_on_nodes("ha", "p2") == 1, timeout=90,
                   what="standby takeover schedules")
    finally:
        stub.stop()
