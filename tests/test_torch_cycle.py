"""The port's scheduling cycle against the JAX package's, cycle by cycle.

The same cluster is built in a ``kube_batch_tpu`` cache and in a
``kube_batch_tpu_torch`` cache from one list of ingest events (the port's
objects are field-for-field copies of the JAX package's), and both
schedulers run three serial cycles of ``run_once`` with the shipped tier
list and ``actions: "allocate"``.  Between cycles the same kubelet
simulation feeds both: bound pods start Running, some running pods finish
(deleted) or start terminating (Releasing), and new gangs arrive.  After
every cycle the binds, every task's status and node, every PodGroup's
phase, counts and conditions, the written pod conditions (the fit-error
messages) and the queue statuses must be equal, and the port's column
store must agree with its object model.  The JAX side runs at its
defaults: delta open, warm carry, the guard, and the sharded solve on the
8-device CPU mesh from 129 nodes.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.api.pod as ppod
import kube_batch_tpu_torch.api.types as ptypes
from kube_batch_tpu.api.pod import (
    Affinity,
    PodAffinityTerm,
    PodGroup,
    Queue,
    Taint,
    Toleration,
)
from kube_batch_tpu.api.resources import DEFAULT_SPEC as JAX_DEFAULT_SPEC
from kube_batch_tpu.api.types import PodPhase
from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
from kube_batch_tpu.framework.conf import parse_scheduler_conf as jax_parse_conf
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu.testing import synthetic as jax_synth
from kube_batch_tpu_torch.api.resources import DEFAULT_SPEC
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.framework.conf import DEFAULT_CONF, parse_scheduler_conf
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing import synthetic as port_synth
from fixtures import GiB, build_node, build_pod

N_CYCLES = 3


def mirror(v):
    """A JAX ingest object as the port's object of the same class name,
    built from identical field values (nested objects and enums too)."""
    if dataclasses.is_dataclass(v):
        cls = getattr(ppod, type(v).__name__)
        return cls(**{f.name: mirror(getattr(v, f.name)) for f in dataclasses.fields(v)})
    if isinstance(v, enum.Enum):
        return getattr(ptypes, type(v).__name__)(v.value)
    if isinstance(v, list):
        return [mirror(x) for x in v]
    if isinstance(v, tuple):
        return tuple(mirror(x) for x in v)
    if isinstance(v, dict):
        return {k: mirror(x) for k, x in v.items()}
    return v


def apply(jcache, pcache, events) -> None:
    """Feed (handler name, JAX object) events to both caches."""
    for kind, obj in events:
        getattr(jcache, kind)(obj)
        getattr(pcache, kind)(mirror(obj))


# --------------------------------------------------------------------------
# fixtures: each returns (jax cache, port cache)
# --------------------------------------------------------------------------


def _synthetic(**kw):
    return jax_synth.synthetic_cluster(**kw), port_synth.synthetic_cluster(**kw)


def _overcommit(**kw):
    return (jax_synth.synthetic_overcommit_cluster(**kw),
            port_synth.synthetic_overcommit_cluster(**kw))


def _from_events(events):
    jcache = JaxCache(spec=JAX_DEFAULT_SPEC)
    pcache = SchedulerCache(spec=DEFAULT_SPEC)
    apply(jcache, pcache, events)
    return jcache, pcache


def _gang(name, queue, n, requests, min_member=None, **pod_kw):
    """A PodGroup and its n pods as ingest events."""
    events = [("add_pod_group", PodGroup(name=name, namespace="ns", queue=queue,
                                         min_member=n if min_member is None else min_member))]
    for i in range(n):
        events.append(("add_pod", build_pod("ns", f"{name}-{i}", None, PodPhase.PENDING,
                                            dict(requests), group_name=name, **pod_kw)))
    return events


def _constraints():
    """Selectors, taints and tolerations, an unschedulable and a not-ready
    node, required inter-pod affinity and anti-affinity, a preferred node
    term, and selectors no node can satisfy."""
    events = [("add_queue", Queue(name="default", weight=1)),
              ("add_queue", Queue(name="gold", weight=2))]
    for i in range(24):
        taints = [Taint("dedicated", "gpu", "NoSchedule")] if i % 4 == 0 else []
        events.append(("add_node", build_node(
            f"n{i}", cpu=8000, mem=16 * GiB,
            labels={"zone": f"z{i % 3}", "kubernetes.io/hostname": f"n{i}"},
            taints=taints, unschedulable=(i == 5), ready=(i != 6))))
    small = {"cpu": 1000, "memory": GiB}
    events += _gang("sel", "default", 4, small, node_selector={"zone": "z1"})
    events += _gang("tol", "gold", 4, {"cpu": 3000, "memory": 2 * GiB},
                    tolerations=[Toleration(key="dedicated", value="gpu",
                                            effect="NoSchedule")])
    events += _gang("aff", "default", 3, small, labels={"app": "web"},
                    affinity=Affinity(pod_affinity=[PodAffinityTerm({"app": "web"})]))
    events += _gang("anti", "gold", 3, small, labels={"app": "db"},
                    affinity=Affinity(pod_anti_affinity=[PodAffinityTerm({"app": "db"})]))
    events += _gang("pref", "default", 2, small, affinity=Affinity(
        preferred_node_terms=[(5.0, [("zone", "In", ("z2",))])]))
    events += _gang("nowhere", "default", 2, small, node_selector={"zone": "z9"})
    for j in range(6):
        events += _gang(f"plain{j}", "gold" if j % 2 else "default", 4,
                        {"cpu": 500 * (1 + j % 3), "memory": GiB})
    return _from_events(events)


def _gang_unmet():
    """Gangs whose minMember cannot be met: one too large for the free
    capacity (the solve discards it: Unschedulable, NotEnoughResources) and
    one with fewer pods than minMember (the open gate drops it:
    NotEnoughPods)."""
    events = [("add_queue", Queue(name="default", weight=1))]
    for i in range(8):
        events.append(("add_node", build_node(f"n{i}", cpu=8000, mem=16 * GiB)))
    big = {"cpu": 6000, "memory": 2 * GiB}
    events += _gang("fits", "default", 4, big)
    events += _gang("toolarge", "default", 6, big)
    events += _gang("short", "default", 3, {"cpu": 500, "memory": GiB}, min_member=5)
    events += _gang("small", "default", 4, {"cpu": 1000, "memory": GiB})
    return _from_events(events)


FIXTURES = {
    "homogeneous": lambda: _synthetic(n_tasks=256, n_nodes=48, n_queues=3, seed=0),
    "host_ports": lambda: _synthetic(n_tasks=384, n_nodes=160, n_queues=2, seed=1,
                                     host_ports_frac=0.3),
    "overcommit": lambda: _overcommit(n_running=192, n_pending=96, n_nodes=48, seed=2),
    "constraints": _constraints,
    "gang_unmet": _gang_unmet,
}


# --------------------------------------------------------------------------
# the kubelet simulation and the compared state
# --------------------------------------------------------------------------


def kubelet(jcache, rng, cycle: int):
    """One round of cluster churn, decided on the JAX cache's state (the
    two caches were just checked equal): bound pods start Running, one in
    twenty running pods finishes and is deleted, one in seven starts
    terminating,
    and two jobs arrive: an elastic one (minMember 1, in the last queue,
    whose members may pipeline onto terminating capacity) and a gang with fewer pods than its
    minMember."""
    events = []
    for key in sorted(jcache.pods):
        pod = jcache.pods[key]
        if pod.phase == PodPhase.PENDING and pod.node_name is not None:
            events.append(("update_pod", dataclasses.replace(pod, phase=PodPhase.RUNNING)))
        elif pod.phase == PodPhase.RUNNING and not pod.deleting:
            u = rng.random()
            if u < 0.05:
                events.append(("delete_pod", pod))
            elif u < 0.2:
                events.append(("update_pod", dataclasses.replace(pod, deleting=True)))
    queues = sorted(jcache.queues)
    for g in range(2):
        name = f"arrive{cycle}-{g}"
        n = int(rng.integers(24, 33)) if g == 0 else int(rng.integers(2, 5))
        events.append(("add_pod_group", PodGroup(
            name=name, namespace="bench", queue=queues[-1] if g == 0 else queues[0],
            min_member=1 if g == 0 else n + 1)))
        for i in range(n):
            events.append(("add_pod", build_pod(
                "bench", f"{name}-{i}", None, PodPhase.PENDING,
                {"cpu": 4000.0 if g == 0 else float(rng.choice([500.0, 1000.0, 2000.0])),
                 "memory": float(rng.choice([1, 2, 4])) * GiB},
                group_name=name)))
    return events


def observed(cache) -> dict:
    """What a user of the scheduler sees after a cycle."""
    tasks, groups = {}, {}
    for uid, job in cache.jobs.items():
        for key, t in job.tasks.items():
            tasks[key] = (int(t.status), t.node_name)
        pg = job.pod_group
        if pg is not None:
            groups[uid] = (
                None if pg.phase is None else pg.phase.value,
                pg.running, pg.failed, pg.succeeded,
                [(c.type, c.status, c.reason, c.message) for c in pg.conditions],
            )
    return {
        "binds": dict(cache.binder.binds),
        "tasks": tasks,
        "podgroups": groups,
        "pod_conditions": [(k, c["message"]) for k, c in cache.status_updater.pod_conditions],
        "queue_statuses": dict(cache.status_updater.queue_statuses),
    }


def _assert_same(want: dict, got: dict, where: str) -> None:
    for field in want:
        w, g = want[field], got[field]
        if isinstance(w, dict) and w != g:
            diff = sorted(k for k in set(w) | set(g) if w.get(k) != g.get(k))
            pytest.fail(f"{where}: {field} differ at {len(diff)} keys, e.g. "
                        f"{[(k, w.get(k), g.get(k)) for k in diff[:3]]}")
        assert w == g, f"{where}: {field} differ"


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_cycles_match_jax(fixture):
    jcache, pcache = FIXTURES[fixture]()
    jsched = JaxScheduler(jcache, conf=jax_parse_conf(DEFAULT_CONF))
    psched = Scheduler(pcache, conf=parse_scheduler_conf(DEFAULT_CONF), device="cpu")
    rng = np.random.default_rng(7)
    seen = {"binds": 0, "fit_histograms": 0, "pipelined": 0, "slow_jobs": 0}
    for cycle in range(N_CYCLES):
        jsched.run_once()
        psched.run_once()
        where = f"{fixture} cycle {cycle}"
        _assert_same(observed(jcache), observed(pcache), where)
        assert pcache.columns.check_consistency(pcache) == [], where
        action = psched.actions[0]
        seen["binds"] = len(pcache.binder.binds)
        seen["fit_histograms"] += int(action.last_fit_histogram)
        seen["slow_jobs"] += action.last_fallback.get("slow_jobs", 0)
        # a pipelined placement records its node's fit shortfall
        seen["pipelined"] += sum(len(j.nodes_fit_delta) for j in pcache.jobs.values())
        apply(jcache, pcache, kubelet(jcache, rng, cycle))
    # each fixture exercises what it is for
    assert seen["binds"] > 0
    if fixture in ("overcommit", "constraints", "gang_unmet"):
        assert seen["fit_histograms"] > 0
    if fixture == "overcommit":
        assert seen["pipelined"] > 0
    if fixture in ("host_ports", "constraints"):
        assert seen["slow_jobs"] > 0
    if fixture == "gang_unmet":
        conds = {uid: [c.reason for c in j.pod_group.conditions]
                 for uid, j in pcache.jobs.items() if j.pod_group is not None}
        assert "NotEnoughResources" in conds["ns/toolarge"]
        assert "NotEnoughPods" in conds["ns/short"]


@pytest.mark.parametrize("fixture", ["constraints", "overcommit"])
def test_failure_histograms_match_jax(fixture):
    """The fit-error histogram, full and over the pending bucket, on a
    session snapshot with unhealthy nodes, selectors, taints and resource
    shortfalls: bit-exact at every row the allocate action reads (the
    bucket's rows; the bucket program leaves the others zero)."""
    from kube_batch_tpu.framework.session import close_session as jax_close
    from kube_batch_tpu.framework.session import open_session as jax_open
    from kube_batch_tpu.ops.assignment import (
        failure_histogram_bucket_solve as jax_bucket_hist,
        failure_histogram_solve as jax_hist,
    )
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
    from kube_batch_tpu_torch.ops.assignment import (
        failure_histogram_bucket_solve,
        failure_histogram_solve,
    )

    jcache, _ = FIXTURES[fixture]()
    ssn = jax_open(jcache, jax_parse_conf(DEFAULT_CONF).tiers)
    try:
        snap, _meta = jcache.columns.device_snapshot(ssn)
    finally:
        jax_close(ssn)
    port = snapshot_from_numpy(snap, "cpu")
    want = np.asarray(jax_hist(snap))
    got = failure_histogram_solve(port).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert want[:, 1:].any(), "the fixture should fail some predicate"
    rows = np.flatnonzero(np.asarray(snap.task_pending)).astype(np.int32)
    pend_rows = np.full(rows.size + 5, -1, np.int32)
    pend_rows[: rows.size] = rows
    want_b = np.asarray(jax_bucket_hist(snap, pend_rows))
    got_b = failure_histogram_bucket_solve(port, torch.from_numpy(pend_rows)).numpy()
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_b[rows], want[rows])


def test_cycle_drive_on_the_cpu():
    """chip_smoke's three-cycle drive, small and on the CPU: the full
    program, then the compacted one once the arrivals fit the pending
    bucket, then the idle path; every check inside the drive passes, and a
    second run binds identically."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive

    kw = dict(n_tasks=512, n_nodes=64, arrivals=64, host_ports_frac=0.1,
              device="cpu", keep_states=True)
    first, second = drive(**kw), drive(**kw)
    c1, c2, c3 = first["cycles"]
    assert [c["mode"] for c in first["cycles"]] == ["full", "compacted", "idle"]
    assert (c1["new_binds"], c1["gangs_running"]) == (512, 128)
    assert c1["fallback"]["promoted_ports_jobs"] > 0
    assert (c2["new_binds"], c2["gangs_running"]) == (64, 144)
    assert c3["new_binds"] == 0 and c3["allocate_ms"]["solve"] == 0.0
    assert all(c["launches"] == {"masked_best_node_raw": 0, "masked_topk_blocks": 0}
               for c in first["cycles"]), "a CPU cycle launched a CUDA kernel"
    assert first["states"] == second["states"]


def test_round_cap_leaves_correlated_arrivals_unplaced_like_jax():
    """After a first cycle has filled part of every node, new gangs all bid
    for the same best-scoring nodes, and the bidding rounds end with only
    part of them placed: the reference's behaviour, which the port repeats
    bind for bind (the chip run's cycle 2 shows the same at 50k)."""
    from kube_batch_tpu_torch.testing.cycle_drive import GANG

    jcache, pcache = _synthetic(n_tasks=2048, n_nodes=256, n_queues=3, seed=0)
    jsched = JaxScheduler(jcache, conf=jax_parse_conf(DEFAULT_CONF))
    psched = Scheduler(pcache, conf=parse_scheduler_conf(DEFAULT_CONF), device="cpu")
    jsched.run_once()
    psched.run_once()
    _assert_same(observed(jcache), observed(pcache), "cycle 1")
    events = [("update_pod", dataclasses.replace(jcache.pods[k], phase=PodPhase.RUNNING))
              for k in sorted(jcache.pods) if jcache.pods[k].node_name is not None]
    rng = np.random.default_rng(1)
    n_arrivals = 512
    for j in range(n_arrivals // GANG):
        events.append(("add_pod_group", PodGroup(
            name=f"arrive{j}", namespace="bench", min_member=GANG,
            queue=f"q{j % 3}", creation_index=10**6 + j)))
    for i in range(n_arrivals):
        events.append(("add_pod", build_pod(
            "bench", f"arrive-t{i}", None, PodPhase.PENDING,
            {"cpu": float(rng.choice(port_synth.CPU_CHOICES)),
             "memory": float(rng.choice(port_synth.MEM_CHOICES))},
            group_name=f"arrive{i // GANG}")))
    apply(jcache, pcache, events)
    binds_before = len(pcache.binder.binds)
    jsched.run_once()
    psched.run_once()
    _assert_same(observed(jcache), observed(pcache), "cycle 2")
    action = psched.actions[0]
    placed = len(pcache.binder.binds) - binds_before
    assert action.last_topk is not None
    assert 0 < placed < n_arrivals
    assert pcache.columns.check_consistency(pcache) == []
