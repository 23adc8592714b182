"""The port's host half against the JAX package's: resource arithmetic,
the job and node ledgers, the column store's snapshot, the conf reader
(against ``yaml.safe_load``), the import boundary of a whole cycle, and
the no-fallback device rule of the scheduler."""

from __future__ import annotations

import ast
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from kube_batch_tpu.api.job_info import JobInfo as JaxJobInfo
from kube_batch_tpu.api.node_info import NodeInfo as JaxNodeInfo
from kube_batch_tpu.api.pod import Node, Pod
from kube_batch_tpu.api.resources import DEFAULT_SPEC as JAX_SPEC
from kube_batch_tpu.api.task_info import TaskInfo as JaxTaskInfo
from kube_batch_tpu.api.types import PodPhase, TaskStatus as JaxTaskStatus
from kube_batch_tpu.framework.conf import parse_scheduler_conf as jax_parse_conf
from kube_batch_tpu.framework.session import close_session as jax_close
from kube_batch_tpu.framework.session import open_session as jax_open
from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.resources import DEFAULT_SPEC
from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.conf import (
    DEFAULT_CONF,
    _load_yaml,
    default_configuration,
    parse_scheduler_conf,
)
from kube_batch_tpu_torch.framework.session import close_session, open_session
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster
from test_torch_cycle import FIXTURES, apply, kubelet, mirror, observed

REPO = Path(__file__).resolve().parent.parent


def _module_string(path: Path, name: str) -> str:
    """The string literal assigned to ``name`` in a test module, read
    without importing it."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


TWO_TIER_CONF = _module_string(REPO / "tests" / "test_actions.py", "TWO_TIER_CONF")

# --------------------------------------------------------------------------
# resources and ledgers
# --------------------------------------------------------------------------


def _vectors(seed, n=200):
    """Pairs of resource vectors on a quantum grid, with near-quantum
    offsets and zeros, so the epsilon-tolerant comparisons see both sides."""
    rng = np.random.default_rng(seed)
    R = DEFAULT_SPEC.n
    base = rng.integers(0, 5, size=(n, 2, R)).astype(np.float64) * 1000.0
    jitter = rng.choice([0.0, 5.0, -5.0, 20.0], size=(n, 2, R))
    return np.maximum(base + jitter, 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_resource_arithmetic_matches_jax(seed):
    for a, b in _vectors(seed):
        pa, pb = DEFAULT_SPEC.from_vec(a), DEFAULT_SPEC.from_vec(b)
        ja, jb = JAX_SPEC.from_vec(a), JAX_SPEC.from_vec(b)
        for op in ("less_equal", "less_equal_semantic", "share"):
            assert getattr(pa, op)(pb) == getattr(ja, op)(jb), op
        assert pa.is_empty() == ja.is_empty()
        np.testing.assert_array_equal(pa.add(pb).vec, ja.add(jb).vec)
        np.testing.assert_array_equal(pa.fit_delta(pb).vec, ja.fit_delta(jb).vec)
        np.testing.assert_array_equal(pa.clone().set_max_(pb).vec,
                                      ja.clone().set_max_(jb).vec)
        if pb.less_equal(pa):
            np.testing.assert_array_equal(pa.sub(pb).vec, ja.sub(jb).vec)


_STATUS_PHASE = {
    "pending": dict(phase=PodPhase.PENDING),
    "bound": dict(phase=PodPhase.PENDING, node_name="n0"),
    "running": dict(phase=PodPhase.RUNNING, node_name="n0"),
    "releasing": dict(phase=PodPhase.RUNNING, node_name="n0", deleting=True),
    "succeeded": dict(phase=PodPhase.SUCCEEDED, node_name="n0"),
}


def test_job_and_node_ledgers_match_jax():
    """The same task sequence through both packages' JobInfo and NodeInfo:
    add, status moves (including Pipelined onto Releasing capacity) and
    removals leave equal ledgers, counts and gang predicates."""
    jnode = JaxNodeInfo(Node(name="n0", allocatable={"cpu": 32000, "memory": 2**37,
                                                     "pods": 110}), JAX_SPEC)
    pnode = NodeInfo(mirror(jnode.node), DEFAULT_SPEC)
    jjob, pjob = JaxJobInfo("ns/j", JAX_SPEC), JobInfo("ns/j", DEFAULT_SPEC)
    jjob.min_available = pjob.min_available = 4
    pairs = []
    for i, kind in enumerate(["running", "releasing", "pending", "bound",
                              "succeeded", "pending", "running"]):
        pod = Pod(name=f"t{i}", namespace="ns",
                  requests={"cpu": 1000.0 + 250.0 * (i % 2), "memory": float(2**30)},
                  **_STATUS_PHASE[kind])
        jt, pt = JaxTaskInfo(pod, JAX_SPEC), TaskInfo(mirror(pod), DEFAULT_SPEC)
        jjob.add_task(jt)
        pjob.add_task(pt)
        if pod.node_name:
            jnode.add_task(jt)
            pnode.add_task(pt)
        pairs.append((jt, pt))

    def check():
        for name in ("allocated", "total_request", "pending_request"):
            np.testing.assert_array_equal(getattr(pjob, name).vec,
                                          getattr(jjob, name).vec, err_msg=name)
        for name in ("idle", "used", "releasing", "allocatable"):
            np.testing.assert_array_equal(getattr(pnode, name).vec,
                                          getattr(jnode, name).vec, err_msg=name)
        assert {int(s): len(b) for s, b in pjob.task_status_index.items()} == \
            {int(s): len(b) for s, b in jjob.task_status_index.items()}
        assert (pjob.ready(), pjob.pipelined(), pjob.valid_task_num) == \
            (jjob.ready(), jjob.pipelined(), jjob.valid_task_num)
        assert pjob.fit_error() == jjob.fit_error()

    check()
    # a pending task pipelines onto the Releasing capacity, another binds
    for idx, status in ((2, TaskStatus.PIPELINED), (5, TaskStatus.BINDING)):
        jt, pt = pairs[idx]
        jjob.update_task_status(jt, JaxTaskStatus(int(status)))
        pjob.update_task_status(pt, status)
        jnode.add_task(jt)
        pnode.add_task(pt)
        check()
    for idx in (2, 1, 0):
        jt, pt = pairs[idx]
        jnode.remove_task(jt)
        pnode.remove_task(pt)
        jjob.delete_task(jt)
        pjob.delete_task(pt)
        check()


# --------------------------------------------------------------------------
# the column store's snapshot
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", ["constraints", "host_ports", "overcommit"])
def test_device_snapshot_matches_jax(fixture):
    """``ColumnStore.device_snapshot`` field by field, bit-exact, on the same
    cache events — at ingest and again after a round of churn."""
    jcache, pcache = FIXTURES[fixture]()
    conf = jax_parse_conf(DEFAULT_CONF)
    pconf = parse_scheduler_conf(DEFAULT_CONF)
    rng = np.random.default_rng(11)
    for round_ in range(2):
        jssn = jax_open(jcache, conf.tiers)
        pssn = open_session(pcache, pconf.tiers, "cpu")
        try:
            want, wmeta = jcache.columns.device_snapshot(jssn)
            got, gmeta = pcache.columns.device_snapshot(pssn)
        finally:
            jax_close(jssn)
            close_session(pssn)
        assert tuple(type(want)._fields) == DeviceSnapshot._fields
        for name in DeviceSnapshot._fields:
            w, g = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{fixture} round {round_}: {name}")
        for name in ("task_keys", "node_names", "job_uids", "queue_names",
                     "label_pair_bit", "taint_bit", "n_tasks", "n_nodes",
                     "n_jobs", "n_queues", "live_nodes"):
            assert getattr(gmeta, name) == getattr(wmeta, name), name
        np.testing.assert_array_equal(gmeta.task_resreq64, wmeta.task_resreq64)
        assert pcache.columns.check_consistency(pcache) == []
        # churn without a scheduling cycle: pods come and go, a node drains
        events = kubelet(jcache, rng, round_)
        events.append(("delete_node", sorted(jcache.nodes)[0]))
        apply(jcache, pcache, events)


def test_check_consistency_catches_a_stale_column():
    cache = synthetic_cluster(32, 4, seed=0)
    cols = cache.columns
    assert cols.check_consistency(cache) == []
    row = next(iter(next(iter(cache.jobs.values())).tasks.values()))._row
    cols.t_status[row] = int(TaskStatus.RUNNING)
    assert cols.check_consistency(cache)


# --------------------------------------------------------------------------
# the conf reader
# --------------------------------------------------------------------------

_CONFS = {
    "shipped": (REPO / "config" / "kube-batch-tpu-conf.yaml").read_text(),
    "port_default": DEFAULT_CONF,
    "two_tier": TWO_TIER_CONF,
    "three_actions": TWO_TIER_CONF.replace('"allocate, backfill"',
                                           '"enqueue, allocate, preempt"'),
    "bogus": 'actions: "bogus"\ntiers: []',
    "switches_and_scalars": textwrap.dedent("""\
        # comments, switches, unquoted and quoted scalars
        actions: allocate, backfill   # trailing comment
        tiers:
          - plugins:
              - name: gang
                enabledJobReady: false
                enabledPredicate: no
                arguments:
                  allocate.pallas: true
                  leastrequested.weight: 2
                  ratio: 0.5
                  quoted: 'a''b'
                  hash: "q#r"
          -   plugins: []
          - plugins:
            - name: nodeorder
        """),
}


@pytest.mark.parametrize("name", sorted(_CONFS))
def test_conf_reader_matches_yaml(name):
    text = _CONFS[name]
    assert _load_yaml(text) == yaml.safe_load(text)
    got = dataclasses.asdict(parse_scheduler_conf(text))
    want = dataclasses.asdict(jax_parse_conf(text))
    assert got == want
    # the parsed dict is accepted too
    assert dataclasses.asdict(parse_scheduler_conf(yaml.safe_load(text))) == want


def test_default_conf_is_the_shipped_tiers_with_allocate():
    """The built-in default equals the JAX package's (``allocate,
    backfill`` over the shipped tiers' plugins, without nodeorder's
    arguments), and the shipped file is reachable by path."""
    from kube_batch_tpu.framework.conf import default_configuration as jax_default
    from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path

    conf, want = default_configuration(), jax_default()
    assert conf.actions == want.actions == ["allocate", "backfill"]
    assert [dataclasses.asdict(t) for t in conf.tiers] == \
        [dataclasses.asdict(t) for t in want.tiers]
    shipped = jax_parse_conf(_CONFS["shipped"])
    assert [[o.name for o in t.plugins] for t in conf.tiers] == \
        [[o.name for o in t.plugins] for t in shipped.tiers]
    assert dataclasses.asdict(load_scheduler_conf(shipped_conf_path())) == \
        dataclasses.asdict(shipped)


def test_conf_reader_rejects_bad_indentation():
    with pytest.raises(ValueError):
        parse_scheduler_conf("actions: allocate\n  tiers: x\n bad: y")


# --------------------------------------------------------------------------
# the scheduler's construction rules and the import boundary
# --------------------------------------------------------------------------


def test_unknown_action_raises_at_construction():
    cache = synthetic_cluster(8, 2)
    for actions in ("enqueue, bogus", "allocate, backfil", "bogus"):
        conf = parse_scheduler_conf(f'actions: "{actions}"\ntiers: []')
        with pytest.raises(KeyError):
            Scheduler(cache, conf=conf, device="cpu")
    # every action of the shipped conf is known
    conf = parse_scheduler_conf(
        'actions: "enqueue, reclaim, allocate, backfill, preempt"\ntiers: []')
    assert [a.name for a in Scheduler(cache, conf=conf, device="cpu").actions] == \
        ["enqueue", "reclaim", "allocate", "backfill", "preempt"]


def test_scheduler_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    cache = synthetic_cluster(8, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(cache)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(cache, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        open_session(cache, default_configuration().tiers)
    assert not cache._session_active
    sched = Scheduler(cache, device="cpu")
    sched.run_once()
    assert len(cache.binder.binds) == 8


def test_cycle_imports_neither_jax_nor_the_jax_package_nor_yaml():
    """One port cycle on the CPU, in a fresh interpreter, loads no jax, no
    kube_batch_tpu module and no yaml: the port must run where PyYAML is not
    installed."""
    code = textwrap.dedent("""
        import sys
        from kube_batch_tpu_torch.scheduler import Scheduler
        from kube_batch_tpu_torch.framework.conf import parse_scheduler_conf, DEFAULT_CONF
        from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster
        cache = synthetic_cluster(64, 8, host_ports_frac=0.2, seed=1)
        Scheduler(cache, conf=parse_scheduler_conf(DEFAULT_CONF), device="cpu").run_once()
        assert len(cache.binder.binds) > 0
        assert cache.columns.check_consistency(cache) == []
        bad = sorted(n for n in sys.modules
                     if n in ("jax", "jaxlib", "yaml") or n.startswith(("jax.", "jaxlib.", "yaml."))
                     or n == "kube_batch_tpu" or n.startswith("kube_batch_tpu."))
        print("LOADED", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


# --------------------------------------------------------------------------
# the session's plugin hooks, the volume seam, and binds outside a cycle
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", ["constraints", "overcommit"])
def test_session_hooks_match_jax(fixture):
    """Every tiered dispatch of an open session — job / queue / task order,
    JobReady / JobPipelined / JobValid / JobEnqueueable, Overused, the
    predicates (with their reasons), node order, Preemptable and
    Reclaimable — gives the same verdicts in both packages, after one
    cycle has placed part of the cluster."""
    from kube_batch_tpu.framework.session import FitFailure as JaxFitFailure
    from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
    from kube_batch_tpu_torch.framework.session import FitFailure

    jcache, pcache = FIXTURES[fixture]()
    JaxScheduler(jcache, conf=jax_parse_conf(DEFAULT_CONF)).run_once()
    Scheduler(pcache, conf=parse_scheduler_conf(DEFAULT_CONF), device="cpu").run_once()
    jssn = jax_open(jcache, jax_parse_conf(DEFAULT_CONF).tiers)
    pssn = open_session(pcache, parse_scheduler_conf(DEFAULT_CONF).tiers, "cpu")
    try:
        rng = np.random.default_rng(5)
        uids = sorted(jssn.jobs)
        for _ in range(40):
            a, b = rng.choice(uids, 2)
            assert pssn.job_order_fn(pssn.jobs[a], pssn.jobs[b]) == \
                jssn.job_order_fn(jssn.jobs[a], jssn.jobs[b])
        for uid in uids:
            pj, jj = pssn.jobs[uid], jssn.jobs[uid]
            assert (pssn.job_ready(pj), pssn.job_pipelined(pj), pssn.job_valid(pj),
                    pssn.job_enqueueable(pj)) == \
                (jssn.job_ready(jj), jssn.job_pipelined(jj), jssn.job_valid(jj),
                 jssn.job_enqueueable(jj))
        for qa in sorted(jssn.queues):
            assert pssn.overused(pssn.queues[qa]) == jssn.overused(jssn.queues[qa])
            for qb in sorted(jssn.queues):
                assert pssn.queue_order_fn(pssn.queues[qa], pssn.queues[qb]) == \
                    jssn.queue_order_fn(jssn.queues[qa], jssn.queues[qb])

        def tasks(ssn):
            return {k: t for j in ssn.jobs.values() for k, t in j.tasks.items()}

        ptasks, jtasks = tasks(pssn), tasks(jssn)
        keys = sorted(jtasks)
        pending = [k for k in keys if jtasks[k].status == JaxTaskStatus.PENDING]
        placed = [k for k in keys if jtasks[k].node_name in jssn.nodes]
        for _ in range(40):
            a, b = rng.choice(keys, 2)
            assert pssn.task_order_fn(ptasks[a], ptasks[b]) == \
                jssn.task_order_fn(jtasks[a], jtasks[b])
        assert pending and placed
        for key in pending[:12]:
            for name in sorted(jssn.nodes)[:12]:
                try:
                    jssn.predicate(jtasks[key], jssn.nodes[name])
                    want = None
                except JaxFitFailure as e:
                    want = e.reason
                try:
                    pssn.predicate(ptasks[key], pssn.nodes[name])
                    got = None
                except FitFailure as e:
                    got = e.reason
                assert got == want, (key, name)
                assert pssn.node_order(ptasks[key], pssn.nodes[name]) == \
                    jssn.node_order(jtasks[key], jssn.nodes[name])
        for key in pending[:6]:
            victims = sorted(placed)[:24]
            for hook in ("preemptable", "reclaimable"):
                want = getattr(jssn, hook)(jtasks[key], [jtasks[k] for k in victims])
                got = getattr(pssn, hook)(ptasks[key], [ptasks[k] for k in victims])
                assert (None if got is None else [t.key() for t in got]) == \
                    (None if want is None else [t.key() for t in want]), hook
    finally:
        jax_close(jssn)
        close_session(pssn)


class _RecordingVolumes:
    """A volume binder that records every call, refuses node n3, and is not
    a no-op — so the allocate replay takes its volume paths."""

    noop = False

    def __init__(self, fit_failure):
        self.fit_failure = fit_failure
        self.calls = []

    def allocate_volumes(self, task, hostname):
        self.calls.append(("allocate", task.key(), hostname))
        if hostname == "n3":
            raise self.fit_failure("node n3 cannot attach the claim")

    def bind_volumes(self, task):
        self.calls.append(("bind", task.key()))

    def release_task(self, uid):
        self.calls.append(("release",))

    def volume_feasible(self, task, hostname):
        return hostname != "n3"


def test_volume_binder_seam_matches_jax():
    """A volume binder that refuses one node: jobs placed there by the
    solve fail the replay's volume pre-check, replay sequentially and move
    to other nodes — the same binds, statuses and volume calls in both
    packages."""
    from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
    from kube_batch_tpu.framework.session import FitFailure as JaxFitFailure
    from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
    from kube_batch_tpu_torch.cache.cache import SchedulerCache
    from kube_batch_tpu_torch.framework.session import FitFailure
    from test_torch_cycle import _synthetic

    jsrc, psrc = _synthetic(n_tasks=96, n_nodes=8, n_queues=2, seed=4,
                            host_ports_frac=0.1)
    jvol, pvol = _RecordingVolumes(JaxFitFailure), _RecordingVolumes(FitFailure)
    jcache = JaxCache(spec=jsrc.spec, volume_binder=jvol)
    pcache = SchedulerCache(spec=psrc.spec, volume_binder=pvol)
    events = [("add_queue", q.queue) for q in jsrc.queues.values()]
    events += [("add_node", n.node) for n in jsrc.nodes.values()]
    events += [("add_pod_group", j.pod_group) for j in jsrc.jobs.values()]
    events += [("add_pod", jsrc.pods[k]) for k in sorted(jsrc.pods)]
    apply(jcache, pcache, events)
    JaxScheduler(jcache, conf=jax_parse_conf(DEFAULT_CONF)).run_once()
    sched = Scheduler(pcache, conf=parse_scheduler_conf(DEFAULT_CONF), device="cpu")
    sched.run_once()
    want, got = observed(jcache), observed(pcache)
    assert got == want
    assert pvol.calls == jvol.calls
    assert any(c[0] == "allocate" and c[2] == "n3" for c in pvol.calls)
    assert "n3" not in set(pcache.binder.binds.values())
    assert sched.actions[0].last_fallback["slow_jobs"] > 0
    assert pcache.columns.check_consistency(pcache) == []


def test_bind_outside_a_session_matches_jax():
    """``bind`` and ``bulk_bind`` with no cycle running apply the Binding
    transition and the node accounting themselves, as the JAX package's do;
    ``bulk_bind``'s binder calls run on the dispatcher, joined by
    ``flush_binds`` on both sides."""
    jcache, pcache = FIXTURES["homogeneous"]()
    keys = sorted(jcache.pods)[:9]

    def tasks(cache):
        return {k: t for job in cache.jobs.values() for k, t in job.tasks.items()
                if k in keys}

    jt, pt = tasks(jcache), tasks(pcache)
    jcache.bind(jt[keys[0]], "n1")
    pcache.bind(pt[keys[0]], "n1")
    jcache.bulk_bind([(jt[k], f"n{i % 3}") for i, k in enumerate(keys[1:])])
    jcache.flush_binds()
    pcache.bulk_bind([(pt[k], f"n{i % 3}") for i, k in enumerate(keys[1:])])
    pcache.flush_binds()
    assert observed(pcache) == observed(jcache)
    for name in ("n0", "n1", "n2"):
        np.testing.assert_array_equal(pcache.nodes[name].idle.vec,
                                      jcache.nodes[name].idle.vec)
    assert pcache.columns.check_consistency(pcache) == []
