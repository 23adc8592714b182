"""Each of the port's actions against the JAX package's, on the cases of
``tests/test_actions.py``: the same ingest events feed a JAX cache and a
port cache, one session runs the named actions on each, and the binds,
evictions, task statuses, PodGroup phases and conditions, pod conditions
and queue statuses must be equal afterwards.  Then enqueue's columnar path
is held against its object walk on PodGroups with MinResources and queue
capabilities, where the gate both admits and rejects."""

from __future__ import annotations

import pytest

from kube_batch_tpu.api.pod import PodGroup, PriorityClass, Queue
from kube_batch_tpu.api.types import PodGroupPhase, PodPhase
from kube_batch_tpu.framework.conf import parse_scheduler_conf as jax_parse_conf
from kube_batch_tpu.framework.interface import get_action as jax_get_action
from kube_batch_tpu.framework.session import close_session as jax_close
from kube_batch_tpu.framework.session import open_session as jax_open
from kube_batch_tpu_torch.api.types import PodGroupPhase as PortPhase
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.conf import DEFAULT_CONF, parse_scheduler_conf
from kube_batch_tpu_torch.framework.interface import get_action
from kube_batch_tpu_torch.framework.session import close_session, open_session
from fixtures import GiB, build_node, build_pod
from test_torch_cycle import _assert_same, _from_events, observed


def run_both(events, action_names):
    """The events into both caches, then one session of ``action_names``
    on each; returns (jax cache, port cache, port actions)."""
    jcache, pcache = _from_events(events)
    tiers = parse_scheduler_conf(DEFAULT_CONF).tiers
    ssn = jax_open(jcache, jax_parse_conf(DEFAULT_CONF).tiers)
    for name in action_names:
        jax_get_action(name).execute(ssn)
    jax_close(ssn)
    jcache.flush_binds()
    ssn = open_session(pcache, tiers, "cpu")
    actions = [get_action(name) for name in action_names]
    for action in actions:
        action.execute(ssn)
    close_session(ssn)
    want, got = observed(jcache), observed(pcache)
    want["evicts"], got["evicts"] = list(jcache.evictor.evicts), list(pcache.evictor.evicts)
    _assert_same(want, got, f"actions {action_names}")
    assert pcache.columns.check_consistency(pcache) == []
    return jcache, pcache, actions


def _pod(name, node, phase, cpu, mem_gib, group, **kw):
    return ("add_pod", build_pod("c1", name, node, phase,
                                 {"cpu": cpu, "memory": mem_gib * GiB}, group_name=group, **kw))


def test_enqueue_promotes_then_allocates():
    events = [("add_queue", Queue(name="default", weight=1)),
              ("add_pod_group", PodGroup(name="pg1", namespace="c1", min_member=1,
                                         queue="default", phase=PodGroupPhase.PENDING)),
              ("add_node", build_node("n1")),
              _pod("p0", None, PodPhase.PENDING, 1000, 1, "pg1")]
    _, pcache, _ = run_both(events, ["enqueue", "allocate"])
    assert pcache.binder.binds == {"c1/p0": "n1"}
    assert pcache.jobs["c1/pg1"].pod_group.phase.value == "Running"


def test_best_effort_backfilled():
    events = [("add_queue", Queue(name="default", weight=1)),
              ("add_node", build_node("n1", cpu=100, mem=GiB)),
              ("add_pod", build_pod("c1", "be", None, PodPhase.PENDING, {}))]
    _, pcache, actions = run_both(events, ["allocate", "backfill"])
    assert pcache.binder.binds == {"c1/be": "n1"}
    assert actions[1].last_placed["best_effort"] == 1


def test_backfill_into_unready_gang_reverts_at_close():
    events = [("add_queue", Queue(name="default", weight=1)),
              ("add_pod_group", PodGroup(name="pg1", namespace="c1", min_member=2,
                                         queue="default")),
              ("add_node", build_node("n1", cpu=100, mem=GiB)),
              ("add_pod", build_pod("c1", "be", None, PodPhase.PENDING, {}, group_name="pg1")),
              _pod("big", None, PodPhase.PENDING, 64000, 64, "pg1")]
    _, pcache, _ = run_both(events, ["allocate", "backfill"])
    assert pcache.binder.binds == {}
    task = pcache.jobs["c1/pg1"].tasks["c1/be"]
    assert task.status == TaskStatus.PENDING and task.node_name is None
    assert not pcache.nodes["n1"].tasks


def _preempt_events(min_member_low: int, high_class: bool):
    events = [("add_queue", Queue(name="default", weight=1))]
    if high_class:
        events.append(("add_priority_class", PriorityClass(name="high-prio", value=100)))
    events += [
        ("add_pod_group", PodGroup(name="low", namespace="c1", min_member=min_member_low,
                                   queue="default")),
        ("add_pod_group", PodGroup(name="high", namespace="c1", min_member=1,
                                   queue="default",
                                   priority_class="high-prio" if high_class else "")),
        ("add_node", build_node("n1", cpu=2000, mem=4 * GiB, pods=10)),
        _pod("low-1", "n1", PodPhase.RUNNING, 1000, 1, "low"),
        _pod("low-2", "n1", PodPhase.RUNNING, 1000, 1, "low"),
        _pod("high-1", None, PodPhase.PENDING, 1000, 1, "high", priority=100),
    ]
    return events


def test_high_priority_job_preempts_within_queue():
    _, pcache, actions = run_both(_preempt_events(1, True), ["preempt"])
    assert len(pcache.evictor.evicts) == 1
    assert pcache.evictor.evicts[0].startswith("c1/low-")
    assert actions[0].last_stats["claims"] == 1


def test_no_preemption_when_gang_would_break():
    _, pcache, _ = run_both(_preempt_events(2, False), ["preempt"])
    assert pcache.evictor.evicts == []


def test_starved_queue_reclaims_from_overfed_queue():
    events = [("add_queue", Queue(name="qa", weight=1)),
              ("add_queue", Queue(name="qb", weight=1)),
              ("add_pod_group", PodGroup(name="ja", namespace="c1", min_member=1, queue="qa")),
              ("add_pod_group", PodGroup(name="jb", namespace="c1", min_member=1, queue="qb")),
              ("add_node", build_node("n1", cpu=2000, mem=4 * GiB, pods=10)),
              _pod("a-1", "n1", PodPhase.RUNNING, 1000, 1, "ja"),
              _pod("a-2", "n1", PodPhase.RUNNING, 1000, 1, "ja"),
              _pod("b-1", None, PodPhase.PENDING, 1000, 1, "jb")]
    _, pcache, actions = run_both(events, ["reclaim"])
    assert len(pcache.evictor.evicts) == 1
    assert pcache.evictor.evicts[0].startswith("c1/a-")
    assert actions[0].last_stats["evicted"] == 1
    # the claimant pipelined onto the freed capacity: session-only state,
    # reverted at close
    assert pcache.jobs["c1/jb"].tasks["c1/b-1"].status == TaskStatus.PENDING


def _minres_events():
    """Pending PodGroups with MinResources in three queues, one queue with
    a capability, against an idle budget that admits only part of them;
    plus one PodGroup without MinResources (promoted unconditionally) and
    an already-Inqueue one (not a candidate)."""
    events = [("add_queue", Queue(name="q0", weight=1)),
              ("add_queue", Queue(name="q1", weight=2, capability={"cpu": 9000})),
              ("add_queue", Queue(name="q2", weight=1))]
    for i in range(3):
        events.append(("add_node", build_node(f"n{i}", cpu=8000, mem=16 * GiB)))
    for j in range(15):
        cpu = float(1000 * (1 + j % 4))
        phase = PodGroupPhase.INQUEUE if j == 14 else PodGroupPhase.PENDING
        events.append(("add_pod_group", PodGroup(
            name=f"pg{j}", namespace="c1", queue=f"q{j % 3}", min_member=2,
            phase=phase, creation_index=j % 5,  # repeated: the uid breaks ties
            min_resources={"cpu": 2 * cpu, "memory": 2.0 * GiB})))
        for k in range(2):
            events.append(_pod(f"pg{j}-{k}", None, PodPhase.PENDING, cpu, 1, f"pg{j}"))
    events.append(("add_pod_group", PodGroup(name="nominres", namespace="c1", queue="q0",
                                             min_member=1, phase=PodGroupPhase.PENDING)))
    events.append(_pod("nominres-0", None, PodPhase.PENDING, 500, 1, "nominres"))
    return events


def test_enqueue_gate_admits_and_rejects_like_jax():
    jcache, pcache, actions = run_both(_minres_events(), ["enqueue"])
    enqueue = actions[0]
    assert enqueue.last_path == "columnar" and enqueue.last_gate_rows == 14
    phases = {uid: j.pod_group.phase for uid, j in pcache.jobs.items()}
    inqueue = sorted(u for u, p in phases.items() if p.value == "Inqueue")
    pending = sorted(u for u, p in phases.items() if p.value == "Pending")
    assert "c1/nominres" in inqueue
    assert len(inqueue) > 2 and len(pending) > 2


def test_enqueue_columnar_path_matches_its_walk():
    """The promoted set of the columnar gate equals the object walk's on
    the same session."""
    _, pcache = _from_events(_minres_events())
    tiers = parse_scheduler_conf(DEFAULT_CONF).tiers
    ssn = open_session(pcache, tiers, "cpu")
    try:
        walk = {job.uid for job in get_action("enqueue")._walk_decisions(ssn)}
        get_action("enqueue").execute(ssn)
        columnar = {uid for uid, job in ssn.jobs.items()
                    if job.pod_group.phase == PortPhase.INQUEUE}
    finally:
        close_session(ssn)
    # the already-Inqueue group is no candidate of either
    assert columnar - {"c1/pg14"} == walk
    assert 2 < len(walk) < 15


@pytest.mark.parametrize("conf_flag", ["reclaim.referenceExact", "preempt.referenceExact"])
def test_reference_exact_flags_are_read(conf_flag):
    text = DEFAULT_CONF.replace("  - name: nodeorder",
                                f'  - name: nodeorder\n    arguments:\n      {conf_flag}: "true"')
    _, pcache = _from_events([("add_queue", Queue(name="default", weight=1))])
    ssn = open_session(pcache, parse_scheduler_conf(text).tiers, "cpu")
    try:
        assert ssn.conf_flag(conf_flag)
        assert not ssn.conf_flag("backfill.realRequests")
        assert ssn.conf_flag("backfill.realRequests", default=True)
    finally:
        close_session(ssn)
