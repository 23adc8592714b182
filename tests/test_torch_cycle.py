"""The port's scheduling cycle against the JAX package's, cycle by cycle.

The same cluster is built in a ``kube_batch_tpu`` cache and in a
``kube_batch_tpu_torch`` cache from one list of ingest events (the port's
objects are field-for-field copies of the JAX package's), and both
schedulers run three serial cycles of ``run_once``, under the built-in
default conf (``allocate, backfill``) and under the shipped five-action
conf (``enqueue, reclaim, allocate, backfill, preempt``).  Between cycles
the same kubelet simulation feeds both: evicted pods are deleted, bound
pods start Running, some running pods finish (deleted) or start
terminating (Releasing), and new gangs arrive.  After every cycle the
binds, the evictions, every task's status and node, every PodGroup's
phase, counts and conditions, the written pod conditions (the fit-error
messages) and the queue statuses must be equal, and the port's column
store must agree with its object model.  The JAX side runs at its
defaults: delta open, warm carry, the guard, and the sharded solve on the
8-device CPU mesh from 129 nodes.  The port runs each case twice: at its
defaults (the delta open and close, the resident snapshot, the warm
carry, the guard) and as the oracle, with the four cross-cycle
mechanisms switched off, so both forms are held against the JAX
package.
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
    PriorityClass,
    Queue,
    Taint,
    Toleration,
)
from kube_batch_tpu.api.resources import DEFAULT_SPEC as JAX_DEFAULT_SPEC
from kube_batch_tpu.api.types import PodGroupPhase, PodPhase
from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
from kube_batch_tpu.framework.conf import load_scheduler_conf as jax_load_conf
from kube_batch_tpu.framework.conf import parse_scheduler_conf as jax_parse_conf
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu.testing import synthetic as jax_synth
from kube_batch_tpu_torch.api.resources import DEFAULT_SPEC
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.framework.conf import (
    DEFAULT_CONF,
    load_scheduler_conf,
    parse_scheduler_conf,
    shipped_conf_path,
)
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing import synthetic as port_synth
from kube_batch_tpu_torch.testing.cycle_drive import oracle_switches
from fixtures import GiB, build_node, build_pod
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

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


def _preempt():
    """One queue's low-priority elastic jobs fill every node's cpu while
    its high-priority gangs wait (preempt's work), and a heavier queue's
    pending jobs starve (reclaim's)."""
    events = [("add_queue", Queue(name="busy", weight=1)),
              ("add_queue", Queue(name="starved", weight=3)),
              ("add_priority_class", PriorityClass(name="high", value=100))]
    for i in range(16):
        events.append(("add_node", build_node(f"n{i}", cpu=8000, mem=32 * GiB)))
    for j in range(32):
        events.append(("add_pod_group", PodGroup(name=f"low{j}", namespace="ns",
                                                 queue="busy", min_member=1)))
        for k in range(2):
            events.append(("add_pod", build_pod(
                "ns", f"low{j}-{k}", f"n{(2 * j + k) % 16}", PodPhase.RUNNING,
                {"cpu": 2000, "memory": 2 * GiB}, group_name=f"low{j}")))
    for j in range(6):
        events += _gang(f"high{j}", "busy", 2, {"cpu": 1000, "memory": GiB},
                        priority=100)
        events[-3] = ("add_pod_group", dataclasses.replace(events[-3][1],
                                                           priority_class="high"))
    for j in range(4):
        events += _gang(f"starved{j}", "starved", 2, {"cpu": 2000, "memory": GiB})
    return _from_events(events)


def _minres():
    """PodGroups created Pending with MinResources (as Volcano's job
    controller creates them) over three queues, one with a capability,
    against an overcommitted idle that admits only part of them."""
    events = [("add_queue", Queue(name="q0", weight=1)),
              ("add_queue", Queue(name="q1", weight=2, capability={"cpu": 20000})),
              ("add_queue", Queue(name="q2", weight=1))]
    for i in range(8):
        events.append(("add_node", build_node(f"n{i}", cpu=8000, mem=16 * GiB)))
    events.append(("add_pod_group", PodGroup(name="busy", namespace="ns", queue="q0",
                                             min_member=1)))
    for i in range(20):
        events.append(("add_pod", build_pod("ns", f"busy-{i}", f"n{i % 8}", PodPhase.RUNNING,
                                            {"cpu": 2000, "memory": 2 * GiB},
                                            group_name="busy")))
    for j in range(24):
        cpu = float(500 * (1 + j % 4))
        events += _gang(f"mr{j}", f"q{j % 3}", 3, {"cpu": cpu, "memory": GiB})
        pg = events[-4][1]
        events[-4] = ("add_pod_group", dataclasses.replace(
            pg, phase=PodGroupPhase.PENDING,
            min_resources={"cpu": 3 * cpu, "memory": 3.0 * GiB}))
    return _from_events(events)


def _best_effort():
    """Nodes whose cpu is taken, pending pods with no requests (plain and in
    a gang of two best-effort pods), and a gang whose second member can
    never fit."""
    events = [("add_queue", Queue(name="default", weight=1))]
    for i in range(4):
        events.append(("add_node", build_node(f"n{i}", cpu=1000, mem=4 * GiB)))
        events.append(("add_pod", build_pod("ns", f"full-{i}", f"n{i}", PodPhase.RUNNING,
                                            {"cpu": 1000, "memory": GiB})))
    for i in range(5):
        events.append(("add_pod", build_pod("ns", f"be-{i}", None, PodPhase.PENDING, {})))
    events += _gang("begang", "default", 2, {})
    events += _gang("unready", "default", 2, {})
    events[-1] = ("add_pod", build_pod("ns", "unready-1", None, PodPhase.PENDING,
                                       {"cpu": 64000, "memory": GiB}, group_name="unready"))
    return _from_events(events)


FIXTURES = {
    "homogeneous": lambda: _synthetic(n_tasks=256, n_nodes=48, n_queues=3, seed=0),
    "host_ports": lambda: _synthetic(n_tasks=384, n_nodes=160, n_queues=2, seed=1,
                                     host_ports_frac=0.3),
    "overcommit": lambda: _overcommit(n_running=192, n_pending=96, n_nodes=48, seed=2),
    "constraints": _constraints,
    "gang_unmet": _gang_unmet,
    "preempt": _preempt,
    "minres": _minres,
    "best_effort": _best_effort,
}

#: conf name → (JAX conf, port conf): the built-in default and the
#: shipped five-action file
CONFS = {
    "default": lambda: (jax_parse_conf(DEFAULT_CONF), parse_scheduler_conf(DEFAULT_CONF)),
    "shipped": lambda: (jax_load_conf(shipped_conf_path()),
                        load_scheduler_conf(shipped_conf_path())),
}


# --------------------------------------------------------------------------
# the kubelet simulation and the compared state
# --------------------------------------------------------------------------


def kubelet(jcache, rng, cycle: int):
    """One round of cluster churn, decided on the JAX cache's state (the
    two caches were just checked equal): evicted pods are deleted, bound
    pods start Running, one in twenty running pods finishes and is deleted,
    one in seven starts terminating, and two jobs arrive: an elastic one
    (minMember 1, in the last queue, whose members may pipeline onto
    terminating capacity) and a gang with fewer pods than its minMember."""
    evicted = set(jcache.evictor.evicts)
    events = [("delete_pod", jcache.pods[k]) for k in sorted(evicted) if k in jcache.pods]
    for key in sorted(jcache.pods):
        if key in evicted:
            continue
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
        "evicts": list(cache.evictor.evicts),
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


#: (conf, the port's path): "defaults" runs the port's cross-cycle forms,
#: "oracle" switches them off (KB_SNAPSHOT_DELTA, KB_DEVICE_CACHE,
#: KB_DELTA_CLOSE and KB_WARM at 0) around the port's cycles only — the
#: JAX side keeps its defaults
PATHS = [pytest.param(conf, path, id=conf if path == "defaults" else f"{conf}-{path}")
         for path in ("defaults", "oracle") for conf in sorted(CONFS)]


@pytest.mark.parametrize("conf,path", PATHS)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_cycles_match_jax(fixture, conf, path):
    jcache, pcache = FIXTURES[fixture]()
    jconf, pconf = CONFS[conf]()
    oracle = path == "oracle"
    pcache.delta_enabled = not oracle
    jsched = JaxScheduler(jcache, conf=jconf)
    psched = Scheduler(pcache, conf=pconf, device="cpu")
    actions = {a.name: a for a in psched.actions}
    rng = np.random.default_rng(7)
    seen = {"binds": 0, "fit_histograms": 0, "pipelined": 0, "slow_jobs": 0,
            "evicts": 0, "reclaim_evicts": 0, "reclaim_pipelined": 0,
            "preempt_claims": 0, "gate_rows": 0,
            "best_effort": 0}
    for cycle in range(N_CYCLES):
        jsched.run_once()
        with oracle_switches(oracle):
            psched.run_once()
        where = f"{fixture} {conf} {path} cycle {cycle}"
        _assert_same(observed(jcache), observed(pcache), where)
        assert pcache.columns.check_consistency(pcache) == [], where
        # every job left carrying fit diagnostics was recorded for the next
        # delta open's clearing (note_fit_state at every write site)
        carrying = {uid for uid, j in pcache.jobs.items()
                    if j.nodes_fit_delta or j.nodes_fit_errors or j.job_fit_errors}
        assert carrying <= pcache.fit_state_jobs, where
        action = actions["allocate"]
        seen["binds"] = len(pcache.binder.binds)
        seen["evicts"] = len(pcache.evictor.evicts)
        seen["fit_histograms"] += int(action.last_fit_histogram)
        seen["slow_jobs"] += action.last_fallback.get("slow_jobs", 0)
        # a pipelined placement records its node's fit shortfall
        seen["pipelined"] += sum(len(j.nodes_fit_delta) for j in pcache.jobs.values())
        seen["best_effort"] += actions["backfill"].last_placed["best_effort"]
        if conf == "shipped":
            seen["reclaim_evicts"] += actions["reclaim"].last_stats.get("evicted", 0)
            seen["reclaim_pipelined"] += actions["reclaim"].last_stats.get("pipelined", 0)
            seen["preempt_claims"] += actions["preempt"].last_stats.get("claims", 0)
            seen["gate_rows"] += actions["enqueue"].last_gate_rows
        apply(jcache, pcache, kubelet(jcache, rng, cycle))
    # each fixture exercises what it is for
    assert seen["binds"] > 0
    if fixture in ("overcommit", "constraints", "gang_unmet"):
        assert seen["fit_histograms"] > 0
    if fixture == "overcommit":
        # allocate pipelines onto terminating capacity; under the shipped
        # conf reclaim's claimants take that capacity first
        assert seen["pipelined" if conf == "default" else "reclaim_pipelined"] > 0
    if fixture in ("host_ports", "constraints"):
        assert seen["slow_jobs"] > 0
    if fixture == "best_effort":
        assert seen["best_effort"] > 0
    if conf == "shipped" and fixture in ("overcommit", "preempt"):
        assert seen["evicts"] > 0 and seen["reclaim_evicts"] > 0
    if conf == "shipped" and fixture == "preempt":
        assert seen["preempt_claims"] > 0
    if conf == "shipped" and fixture == "minres":
        assert seen["gate_rows"] > 0
        phases = [j.pod_group.phase.value for uid, j in pcache.jobs.items()
                  if uid.startswith("ns/mr")]
        assert "Pending" in phases and len(set(phases)) > 1
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
    """chip_smoke's three-cycle headline drive under the shipped conf,
    small and on the CPU: the full program, then the compacted one once the
    arrivals fit the pending bucket, then the idle path; every check inside
    the drive passes, and a second run binds identically."""
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
    assert all(f"action:{a}" in c1["stages_ms"]
               for a in ("enqueue", "reclaim", "allocate", "backfill", "preempt"))
    assert not any(c["launches"][k] for c in first["cycles"] for k in c["launches"]), \
        "a CPU cycle launched a CUDA kernel"
    assert first["states"] == second["states"]


def test_overcommit_drive_on_the_cpu():
    """chip_smoke's overcommit drive, small and on the CPU: reclaim evicts
    and pipelines in cycle 1 (every eviction check inside the drive
    passes), the claimants bind in cycle 2 once the kubelet deleted the
    victims, and a second run evicts and binds identically."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_overcommit

    kw = dict(n_running=512, n_pending=256, n_nodes=64, device="cpu", keep_states=True)
    first, second = drive_overcommit(**kw), drive_overcommit(**kw)
    c1, c2, c3 = first["cycles"]
    assert c1["new_evicts"] > 0 and c1["pipelined_claimants"] > 0
    assert c1["reclaim"]["rounds"] >= 1
    assert c1["eviction_checks"]["victims"] == c1["new_evicts"]
    assert c2["evicted_deleted"] == c1["new_evicts"]
    assert c2["new_binds"] >= c1["pipelined_claimants"]
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


def test_steady_drive_on_the_cpu():
    """chip_smoke's steady-state drive, small and on the CPU: the defaults
    leg (delta open and close, resident snapshot, every swap held against a
    fresh upload, warm carry, guard), the cold leg (KB_WARM=0), the
    noguard leg (KB_GUARD=0) and the oracle leg decide identically in
    every cycle; the defaults leg takes the delta open, the scatter path
    and the warm merge, and its guard reads clean verdicts."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_steady

    kw = dict(n_tasks=2048, n_nodes=256, cycles=4, device="cpu", keep_states=True)
    delta = drive_steady(**kw, check_swaps=True)
    oracle = drive_steady(**kw, leg="oracle")
    cold = drive_steady(**kw, leg="cold")
    noguard = drive_steady(**kw, leg="noguard")
    for other in (oracle, cold, noguard):
        assert [c["digest"] for c in delta["cycles"]] == [c["digest"] for c in other["cycles"]]
        assert delta["states"] == other["states"]
    steady = delta["cycles"][delta["warmup_cycles"]:]
    assert "delta" in delta["steady"]["open_paths"]
    assert set(oracle["steady"]["open_paths"]) == {"full"}
    assert sum(c["resident"]["scatter_updates"] for c in steady if c["resident"]) > 0
    assert all(c["swaps_checked"] == c["swaps"] for c in delta["cycles"])
    assert sum(c["swaps"] for c in delta["cycles"]) > 0
    assert all(c["resident"] is None for c in oracle["cycles"])
    assert sum(c["completed_gangs"] for c in steady) > 0
    # warm: the defaults leg's first plan is cold and later ones merge
    # (here, on 256 nodes, a cycle that moves more than 64 of them plans
    # cold again); the cold and oracle legs never run the carried table
    warm = [c["warm"] for c in delta["cycles"] if c["warm"] is not None]
    assert warm and warm[0]["cold"] and any(not w["cold"] for w in warm[1:])
    assert all(c["warm"] is None for leg in (cold, oracle) for c in leg["cycles"])
    # guard: every guarded leg read verdicts, all clean; noguard read none
    for leg in (delta, cold, oracle):
        assert sum(c["guard"]["verdicts"] for c in leg["cycles"]) > 0
        assert not any(c["guard"]["trips"] or c["guard"]["failed_closed"]
                       for c in leg["cycles"])
    assert all(c["guard"]["enabled"] == 0 and c["guard"]["verdicts"] == 0
               for c in noguard["cycles"])
