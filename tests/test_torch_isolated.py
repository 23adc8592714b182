"""Isolated sessions and the object snapshot, the port against the JAX
package.

``cache.snapshot()`` and the info objects' ``clone()`` (the cases of
``tests/test_cache.py`` and ``tests/test_node_job_info.py``);
``api/snapshot.build_snapshot`` against the JAX package's, every field of
the ``DeviceSnapshot`` bit-exact (dtype and value) and the meta's index
maps equal, on every fixture of ``tests/test_torch_cycle.py`` (host ports
and the constraint mix among them); and whole isolated cycles through the
shipped conf — the same events into both packages, ``open_session(...,
isolated=True)`` on each, the conf's actions, the close — with binds,
evictions, task statuses, PodGroup statuses, pod conditions and queue
statuses equal after each of three cycles.  The "mixed" runs put the
isolated cycle between two exclusive ones, so the exclusive session's
cross-cycle state meets what an isolated session wrote to the cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from kube_batch_tpu.api.snapshot import build_snapshot as jax_build_snapshot
from kube_batch_tpu.framework import session as jax_session
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.pod import PodDisruptionBudget, PodGroup, Queue
from kube_batch_tpu_torch.api.resources import DEFAULT_SPEC
from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot, build_snapshot
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.api.types import PodPhase, TaskStatus
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing.cycle_drive import isolated_cycle
from test_torch_cycle import CONFS, FIXTURES, _assert_same, apply, kubelet, observed
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

GiB = float(1 << 30)


def port_cache(queues=("default",), nodes=()):
    cache = SchedulerCache(spec=DEFAULT_SPEC)
    for q in queues:
        cache.add_queue(Queue(name=q))
    for n in nodes:
        cache.add_node(n)
    return cache


def node(name, cpu=8000.0, **kw):
    from kube_batch_tpu_torch.api.pod import Node

    return Node(name=name, allocatable={"cpu": cpu, "memory": 16 * GiB, "pods": 110.0}, **kw)


def pod(name, cpu=1000.0, phase=PodPhase.PENDING, node_name=None, **kw):
    from kube_batch_tpu_torch.api.pod import Pod

    return Pod(name=name, namespace="ns", requests={"cpu": cpu, "memory": GiB},
               phase=phase, node_name=node_name, **kw)


# --------------------------------------------------------------------------
# cache.snapshot() and the clones
# --------------------------------------------------------------------------


def test_snapshot_excludes_a_job_without_podgroup_or_pdb():
    cache = port_cache()
    cache.jobs["ns/bare"] = JobInfo("ns/bare", cache.spec)
    assert "ns/bare" not in cache.snapshot().jobs


def test_snapshot_keeps_a_pdb_job():
    cache = port_cache()
    cache.add_pdb(PodDisruptionBudget(name="pdb", namespace="ns", min_available=2,
                                      owner="rs"))
    cache.add_pod(pod("w0", owner="rs"))
    snap = cache.snapshot()
    assert snap.jobs["ns/rs"].pdb is not None and snap.jobs["ns/rs"].min_available == 2


def test_snapshot_excludes_a_job_in_an_unknown_queue():
    cache = port_cache()
    cache.add_pod_group(PodGroup(name="pg", namespace="ns", queue="ghost"))
    assert cache.snapshot().jobs == {}


def test_snapshot_excludes_a_not_ready_node():
    cache = port_cache(nodes=[node("up"), node("down", ready=False)])
    assert set(cache.snapshot().nodes) == {"up"}


def test_snapshot_is_a_deep_clone():
    cache = port_cache(nodes=[node("n1")])
    cache.add_pod(pod("p1", phase=PodPhase.RUNNING, node_name="n1"))
    snap = cache.snapshot()
    sjob = snap.jobs["ns/p1"]
    stask = next(iter(sjob.tasks.values()))
    assert sjob._cols is None and stask._store is None and snap.nodes["n1"]._cols is None
    snap.nodes["n1"].idle.vec[0] = 0
    sjob.min_available = 99
    sjob.update_task_status(stask, TaskStatus.RELEASING)
    assert cache.nodes["n1"].idle.vec[0] == 7000
    job = cache.jobs["ns/p1"]
    assert job.min_available == 1 and job.ready_task_num == 1
    assert next(iter(job.tasks.values())).status == TaskStatus.RUNNING
    assert cache.columns.check_consistency(cache) == []


def test_clone_keeps_dict_order_and_ledgers():
    cache = port_cache(nodes=[node("n1", cpu=64000.0)])
    cache.add_pod_group(PodGroup(name="g", namespace="ns", min_member=3, queue="default"))
    from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION

    for i in (3, 1, 2):
        cache.add_pod(pod(f"t{i}", phase=PodPhase.RUNNING if i != 2 else PodPhase.PENDING,
                          node_name="n1" if i != 2 else None,
                          annotations={GROUP_NAME_ANNOTATION: "g"}))
    job = cache.jobs["ns/g"]
    clone = job.clone()
    assert list(clone.tasks) == list(job.tasks)
    for s, bucket in job.task_status_index.items():
        assert list(clone.task_status_index[s]) == list(bucket)
    for name in ("allocated", "total_request", "pending_request"):
        assert np.array_equal(getattr(clone, name).vec, getattr(job, name).vec)
        assert getattr(clone, name).vec is not getattr(job, name).vec
    nclone = cache.nodes["n1"].clone()
    assert list(nclone.tasks) == list(cache.nodes["n1"].tasks)
    assert np.array_equal(nclone.idle.vec, cache.nodes["n1"].idle.vec)


def test_task_clone_updates_its_node_by_key():
    n = node("n1", cpu=4000.0)
    from kube_batch_tpu_torch.api.node_info import NodeInfo

    info = NodeInfo(n, DEFAULT_SPEC)
    t = TaskInfo(pod("p1", phase=PodPhase.RUNNING, node_name="n1"), DEFAULT_SPEC)
    info.add_task(t)
    t2 = t.clone()
    t2.status = TaskStatus.RELEASING
    info.update_task(t2)
    assert info.releasing.vec[0] == 1000 and info.used.vec[0] == 1000
    assert t.status == TaskStatus.RUNNING


def test_bulk_bind_distrusts_a_stale_presum():
    """Outside a session (an isolated session's binds), a presummed job or
    node sum is used only when every task's resreq is the Resource the
    session cloned: a pod updated mid-cycle is summed afresh."""
    cache = port_cache(nodes=[node("n1")])
    p = pod("p1")
    cache.add_pod(p)
    session_task = next(iter(cache.snapshot().jobs["ns/p1"].tasks.values()))
    cache.update_pod(dataclasses.replace(p, requests={"cpu": 2000.0, "memory": GiB}))
    stale = session_task.resreq.vec.copy()
    cache.bulk_bind([(session_task, "n1")], job_sums={"ns/p1": (1, stale)},
                    node_sums={"n1": (1, stale)})
    cache.flush_binds()
    assert cache.jobs["ns/p1"].allocated.vec[0] == 2000
    assert cache.nodes["n1"].used.vec[0] == 2000
    assert cache.binder.binds == {"ns/p1": "n1"}
    assert cache.columns.check_consistency(cache) == []


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_snapshot_matches_jax(fixture):
    """cache.snapshot(): the same jobs, nodes and queues in the same order,
    each job's priority, gang size, queue and tasks (in order, with status
    and node) equal."""
    jcache, pcache = FIXTURES[fixture]()
    want, got = jcache.snapshot(), pcache.snapshot()
    assert list(want.jobs) == list(got.jobs)
    assert list(want.nodes) == list(got.nodes)
    assert list(want.queues) == list(got.queues)
    for uid, wj in want.jobs.items():
        gj = got.jobs[uid]
        assert (wj.priority, wj.min_available, wj.queue) == (gj.priority, gj.min_available,
                                                             gj.queue), uid
        assert [(k, int(t.status), t.node_name) for k, t in wj.tasks.items()] == [
            (k, int(t.status), t.node_name) for k, t in gj.tasks.items()], uid
    for name, wn in want.nodes.items():
        assert np.array_equal(wn.idle.vec, got.nodes[name].idle.vec), name
        assert list(wn.tasks) == list(got.nodes[name].tasks), name


# --------------------------------------------------------------------------
# build_snapshot, field by field
# --------------------------------------------------------------------------


def assert_snapshots_equal(want, wmeta, got, gmeta, where: str) -> None:
    for field in DeviceSnapshot._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field)
        assert isinstance(g, np.ndarray), f"{where}: {field} is not numpy"
        assert w.dtype == g.dtype and w.shape == g.shape, f"{where}: {field} shape/dtype"
        assert np.array_equal(w, g), f"{where}: {field} differs"
    for name in ("task_keys", "node_names", "job_uids", "queue_names",
                 "label_pair_bit", "taint_bit", "n_tasks", "n_nodes", "n_jobs",
                 "n_queues"):
        assert getattr(wmeta, name) == getattr(gmeta, name), f"{where}: meta {name}"
    assert np.array_equal(wmeta.task_resreq64, gmeta.task_resreq64), where
    assert np.array_equal(wmeta.task_needs_host, gmeta.task_needs_host), where
    assert [t._key for t in gmeta.task_objs] == gmeta.task_keys, where
    assert [j.uid for j in gmeta.job_objs] == gmeta.job_uids, where
    assert gmeta.live_nodes == gmeta.n_nodes, where


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_build_snapshot_matches_jax(fixture):
    jcache, pcache = FIXTURES[fixture]()
    want, wmeta = jax_build_snapshot(jcache.snapshot())
    got, gmeta = build_snapshot(pcache.snapshot())
    assert_snapshots_equal(want, wmeta, got, gmeta, fixture)
    # the unpadded form and the session's node exclusions too
    excluded = sorted(pcache.nodes)[:2]
    want, wmeta = jax_build_snapshot(jcache.snapshot(), pad=False, excluded_nodes=excluded)
    got, gmeta = build_snapshot(pcache.snapshot(), pad=False, excluded_nodes=excluded)
    assert_snapshots_equal(want, wmeta, got, gmeta, fixture + " unpadded")


@pytest.mark.parametrize("fixture", ["homogeneous", "constraints"])
def test_build_snapshot_matches_jax_after_cycles(fixture):
    """After two cycles and their kubelet churn: bound, running and
    releasing tasks, used and releasing node ledgers, pipelined-free
    queues."""
    jcache, pcache = FIXTURES[fixture]()
    jconf, pconf = CONFS["shipped"]()
    jsched, psched = JaxScheduler(jcache, conf=jconf), Scheduler(pcache, conf=pconf,
                                                                 device="cpu")
    rng = np.random.default_rng(3)
    for cycle in range(2):
        jsched.run_once()
        psched.run_once()
        apply(jcache, pcache, kubelet(jcache, rng, cycle))
        want, wmeta = jax_build_snapshot(jcache.snapshot())
        got, gmeta = build_snapshot(pcache.snapshot())
        assert_snapshots_equal(want, wmeta, got, gmeta, f"{fixture} cycle {cycle}")


# --------------------------------------------------------------------------
# whole isolated cycles
# --------------------------------------------------------------------------


def jax_isolated_cycle(sched) -> None:
    ssn = jax_session.open_session(sched.cache, sched.conf.tiers, isolated=True)
    ssn.action_names = [a.name for a in sched.actions]
    for action in sched.actions:
        action.execute(ssn)
    jax_session.close_session(ssn)
    sched.cache.flush_binds()


@pytest.mark.parametrize("mode", ["isolated", "mixed"])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_isolated_cycles_match_jax(fixture, mode):
    jcache, pcache = FIXTURES[fixture]()
    jconf, pconf = CONFS["shipped"]()
    jsched = JaxScheduler(jcache, conf=jconf)
    psched = Scheduler(pcache, conf=pconf, device="cpu")
    rng = np.random.default_rng(7)
    for cycle in range(3):
        if mode == "isolated" or cycle == 1:
            jax_isolated_cycle(jsched)
            ssn = isolated_cycle(psched)
            assert ssn.columns is None and not ssn.exclusive
        else:
            jsched.run_once()
            psched.run_once()
        where = f"{fixture} {mode} cycle {cycle}"
        _assert_same(observed(jcache), observed(pcache), where)
        assert pcache.columns.check_consistency(pcache) == [], where
        assert not pcache._session_active, where
        apply(jcache, pcache, kubelet(jcache, rng, cycle))
    assert pcache.binder.binds
