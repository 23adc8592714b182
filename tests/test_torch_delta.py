"""The port's cross-cycle state against its own full forms and the JAX
package's defaults.

A seed-deterministic churner (the JAX package's
``tests/test_snapshot_delta.py`` ``_Churner``: gang arrivals, completions,
status flips, node crashes and rejoins, and here also a PodGroup moved to
another queue) drives a real port cache through
its ingest handlers, and real cycles run on it.  After every cycle the
delta-built session and snapshot must equal a forced full rebuild, and,
fed the same events, the port must take the JAX package's open paths and
reach its open state, job rows, snapshot arrays and decisions.  The open
rule's full fallbacks, the delta close against ``KB_DELTA_CLOSE=0``, the
fit-state clearing and the open cache's invalidation on a failed open are
held too.  Node counts stay below 129, so the JAX side keeps its
single-device path on the 8-device CPU test mesh.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

import kube_batch_tpu.api.pod as jpod
import kube_batch_tpu.api.types as jtypes
import kube_batch_tpu_torch.api.pod as ppod
import kube_batch_tpu_torch.api.types as ptypes
from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
from kube_batch_tpu.framework.conf import load_scheduler_conf as jax_load_conf
from kube_batch_tpu.framework.conf import parse_scheduler_conf as jax_parse_conf
from kube_batch_tpu.framework.session import close_session as jax_close
from kube_batch_tpu.framework.session import open_session as jax_open
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.api.job_info import FitErrors
from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.framework.conf import (
    DEFAULT_CONF,
    load_scheduler_conf,
    parse_scheduler_conf,
    shipped_conf_path,
)
from kube_batch_tpu_torch.framework.session import close_session, open_session
from kube_batch_tpu_torch.plugins.gang import GangPlugin
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_cycle import _assert_same, apply, observed
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

GiB = float(1 << 30)

JAX = types.SimpleNamespace(pod=jpod, types=jtypes)
PORT = types.SimpleNamespace(pod=ppod, types=ptypes)

#: the session job-row columns both packages keep
JOB_ROWS = ("j_sess", "j_min", "j_queue", "j_prio", "j_creation", "j_sched",
            "j_has_pg", "j_shadow", "j_pdb", "j_phase", "j_has_conds")


def node_event(pkg, i: int):
    return ("add_node", pkg.pod.Node(
        name=f"n{i}", allocatable={"cpu": 16000.0, "memory": 64 * GiB, "pods": 110.0}))


def cluster_events(pkg, n_nodes: int = 6, n_queues: int = 2) -> list:
    events = [("add_queue", pkg.pod.Queue(name=f"q{q}", uid=f"uq{q}", weight=q + 1))
              for q in range(n_queues)]
    return events + [node_event(pkg, i) for i in range(n_nodes)]


class Churner:
    """Randomized, seed-deterministic churn as ingest events of ``pkg``'s
    classes, decided on ``cache``'s state (the JAX package's
    ``tests/test_snapshot_delta.py`` ``_Churner``): ``step()`` returns the
    events of one step, which the caller applies to one or both caches."""

    def __init__(self, cache, rng, pkg, n_queues: int = 2):
        self.cache = cache
        self.rng = rng
        self.pkg = pkg
        self.n_queues = n_queues
        self.serial = 0
        self.gangs = []  # job names with live pods

    def add_gang(self, size=None) -> list:
        pod = self.pkg.pod
        self.serial += 1
        g = f"g{self.serial}"
        size = size or int(self.rng.integers(1, 4))
        events = [("add_pod_group", pod.PodGroup(
            name=g, namespace="churn", uid=f"pg-{g}", min_member=size,
            queue=f"q{int(self.rng.integers(self.n_queues))}",
            creation_index=self.serial))]
        for k in range(size):
            events.append(("add_pod", pod.Pod(
                name=f"{g}-{k}", namespace="churn", uid=f"pod-{g}-{k}",
                requests={"cpu": float(self.rng.choice([250.0, 500.0, 1000.0])),
                          "memory": 1 * GiB},
                annotations={pod.GROUP_NAME_ANNOTATION: g},
                phase=self.pkg.types.PodPhase.PENDING,
                creation_index=self.serial * 100 + k)))
        self.gangs.append(g)
        return events

    def complete_gang(self) -> list:
        if not self.gangs:
            return []
        g = self.gangs.pop(int(self.rng.integers(len(self.gangs))))
        job = self.cache.jobs.get(f"churn/{g}")
        keys = sorted(job.tasks) if job is not None else []
        events = [("delete_pod", self.cache.pods[k]) for k in keys if k in self.cache.pods]
        return events + [("delete_pod_group", f"churn/{g}")]

    def flip_statuses(self) -> list:
        # bound pods progress to Running / Succeeded as a kubelet's would
        phase = self.pkg.types.PodPhase
        pods = sorted((p for p in self.cache.pods.values() if p.node_name),
                      key=lambda p: p.key())
        events = []
        for p in pods[: int(self.rng.integers(1, 3))] if pods else ():
            if p.phase == phase.PENDING:
                events.append(("update_pod", dataclasses.replace(p, phase=phase.RUNNING)))
            elif p.phase == phase.RUNNING and self.rng.random() < 0.5:
                events.append(("update_pod", dataclasses.replace(p, phase=phase.SUCCEEDED)))
        return events

    def node_churn(self) -> list:
        if self.rng.random() < 0.5:
            return [("delete_node", f"n{int(self.rng.integers(3))}")]
        return [node_event(self.pkg, int(self.rng.integers(3)))]

    def requeue_gang(self) -> list:
        """A PodGroup update alone (no pod event): the gang moves queue."""
        if not self.gangs:
            return []
        job = self.cache.jobs.get(f"churn/{self.gangs[int(self.rng.integers(len(self.gangs)))]}")
        if job is None or job.pod_group is None:
            return []
        queue = f"q{(int(job.queue[1:]) + 1) % self.n_queues}"
        return [("update_pod_group", dataclasses.replace(job.pod_group, queue=queue))]

    def step(self) -> list:
        r = self.rng.random()
        if r < 0.45:
            return self.add_gang()
        if r < 0.70:
            return self.complete_gang()
        if r < 0.90:
            return self.flip_statuses()
        if r < 0.95:
            return self.node_churn()
        return self.requeue_gang()


class PdbChurner(Churner):
    """The churner plus PodDisruptionBudget gangs: owner-linked pods whose
    PDB arrives before or after them, PDBs deleted (the pods fall back to
    shadow singletons) and re-added, and PDB gangs completing."""

    def __init__(self, cache, rng, pkg, n_queues: int = 2):
        super().__init__(cache, rng, pkg, n_queues)
        self.owners = []  # owner uids with live pods
        self.pdbs = {}    # owner → the PDB ingested for it

    def add_pdb_gang(self) -> list:
        pod = self.pkg.pod
        self.serial += 1
        owner = f"rs{self.serial}"
        size = int(self.rng.integers(2, 4))
        pdb = pod.PodDisruptionBudget(name=f"pdb-{owner}", namespace="churn",
                                      min_available=size, owner=owner,
                                      creation_index=self.serial)
        pods = [("add_pod", pod.Pod(
            name=f"{owner}-{k}", namespace="churn", uid=f"pod-{owner}-{k}",
            requests={"cpu": float(self.rng.choice([250.0, 500.0])), "memory": 1 * GiB},
            owner=owner, phase=self.pkg.types.PodPhase.PENDING,
            creation_index=self.serial * 100 + k)) for k in range(size)]
        self.owners.append(owner)
        self.pdbs[owner] = pdb
        # the PDB before or after its pods (a shadow PodGroup then yields)
        if self.rng.random() < 0.5:
            return [("add_pdb", pdb)] + pods
        return pods + [("add_pdb", pdb)]

    def toggle_pdb(self) -> list:
        if not self.owners:
            return []
        owner = self.owners[int(self.rng.integers(len(self.owners)))]
        job = self.cache.jobs.get(f"churn/{owner}")
        if job is not None and job.pdb is not None:
            return [("delete_pdb", self.pdbs[owner])]
        return [("add_pdb", self.pdbs[owner])]

    def complete_pdb_gang(self) -> list:
        if not self.owners:
            return []
        owner = self.owners.pop(int(self.rng.integers(len(self.owners))))
        job = self.cache.jobs.get(f"churn/{owner}")
        keys = sorted(job.tasks) if job is not None else []
        return ([("delete_pdb", self.pdbs.pop(owner))]
                + [("delete_pod", self.cache.pods[k]) for k in keys if k in self.cache.pods])

    def step(self) -> list:
        r = self.rng.random()
        if r < 0.2:
            return self.add_pdb_gang()
        if r < 0.35:
            return self.toggle_pdb()
        if r < 0.45:
            return self.complete_pdb_gang()
        return super().step()


def feed(cache, events) -> None:
    for kind, obj in events:
        getattr(cache, kind)(obj)


def port_cluster(n_nodes: int = 6):
    cache = SchedulerCache()
    feed(cache, cluster_events(PORT, n_nodes))
    return cache


def both_clusters(n_nodes: int = 6):
    jcache, pcache = JaxCache(), SchedulerCache()
    apply(jcache, pcache, cluster_events(JAX, n_nodes))
    return jcache, pcache


def snapshot_arrays(snap) -> dict:
    return {f: np.array(getattr(snap, f)) for f in DeviceSnapshot._fields}


def assert_arrays_equal(got: dict, want: dict, where: str) -> None:
    for field, w in want.items():
        g = got[field]
        assert g.shape == w.shape and g.dtype == w.dtype, f"{where}: {field} shape/dtype"
        assert np.array_equal(g, w), f"{where}: {field} differs"


def at_open(statuses: dict) -> dict:
    return {uid: (None if p is None else p.value, r, f, s)
            for uid, (p, r, f, s) in statuses.items()}


def assert_fit_state_recorded(cache, where: str = "") -> None:
    """Every job carrying fit diagnostics after a cycle is in
    ``cache.fit_state_jobs``: a write site that missed ``note_fit_state``
    would leave its diagnostics uncleared by the next delta open."""
    carrying = {uid for uid, j in cache.jobs.items()
                if j.nodes_fit_delta or j.nodes_fit_errors or j.job_fit_errors}
    missed = carrying - cache.fit_state_jobs
    assert not missed, f"{where}: fit state not recorded for {sorted(missed)[:3]}"


def run_actions(actions, ssn) -> None:
    ssn.action_names = [a.name for a in actions]
    for action in actions:
        action.execute(ssn)


# --------------------------------------------------------------------------
# (a) the delta snapshot against the port's own forced full rebuild
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_delta_snapshot_equals_forced_full_rebuild(seed):
    rng = np.random.default_rng(seed)
    cache = port_cluster()
    conf = parse_scheduler_conf(DEFAULT_CONF)
    actions = Scheduler(cache, conf=conf, device="cpu").actions
    churn = Churner(cache, rng, PORT)
    for _ in range(4):
        feed(cache, churn.add_gang())
    cols = cache.columns
    delta_cycles = 0
    for cycle in range(14):
        feed(cache, churn.step())
        ssn = open_session(cache, conf.tiers, "cpu")
        try:
            snap, _ = cols.device_snapshot(ssn)
            got = snapshot_arrays(snap)
            path = cols.last_snapshot_path
            delta_cycles += path == "delta"
            assert cache.last_open_path == path
            cols.sync_session_rows(ssn)   # the forced full rescan
            full, _ = cols.device_snapshot(ssn)
            assert_arrays_equal(got, snapshot_arrays(full),
                                f"seed {seed} cycle {cycle} path {path}")
            run_actions(actions, ssn)
        finally:
            close_session(ssn)
        assert_fit_state_recorded(cache, f"seed {seed} cycle {cycle}")
    assert cols.check_consistency(cache) == []
    assert delta_cycles >= 5, f"the delta path engaged only {delta_cycles} times"


# --------------------------------------------------------------------------
# (b) the port against the JAX package on the same events
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_delta_cycles_match_jax(seed):
    """Each cycle both packages take the same open and snapshot paths with
    the same churn, and reach the same at-open PodGroup statuses, synced
    job rows, snapshot arrays and decisions (shipped conf)."""
    rng = np.random.default_rng(seed)
    jcache, pcache = both_clusters()
    jconf = jax_load_conf(shipped_conf_path())
    pconf = load_scheduler_conf(shipped_conf_path())
    jactions = JaxScheduler(jcache, conf=jconf).actions
    pactions = Scheduler(pcache, conf=pconf, device="cpu").actions
    churn = Churner(jcache, rng, JAX)
    for _ in range(4):
        apply(jcache, pcache, churn.add_gang())
    paths = []
    for cycle in range(14):
        apply(jcache, pcache, churn.step())
        where = f"seed {seed} cycle {cycle}"
        jssn = jax_open(jcache, jconf.tiers)
        pssn = open_session(pcache, pconf.tiers, "cpu")
        try:
            paths.append(pcache.last_open_path)
            assert (jcache.last_open_path, jcache.columns.last_snapshot_path) == (
                pcache.last_open_path, pcache.columns.last_snapshot_path), where
            assert jcache.last_churn == pcache.last_churn, where
            assert at_open(jssn.pod_group_status_at_open) == at_open(
                pssn.pod_group_status_at_open), where
            jsnap, _ = jcache.columns.device_snapshot(jssn)
            psnap, _ = pcache.columns.device_snapshot(pssn)
            assert_arrays_equal(
                {f: getattr(pcache.columns, f) for f in JOB_ROWS},
                {f: getattr(jcache.columns, f) for f in JOB_ROWS}, where + " job rows")
            assert_arrays_equal(snapshot_arrays(psnap), snapshot_arrays(jsnap), where)
            run_actions(jactions, jssn)
            run_actions(pactions, pssn)
        finally:
            jax_close(jssn)
            close_session(pssn)
        _assert_same(observed(jcache), observed(pcache), where)
        assert_fit_state_recorded(pcache, where)
    assert paths.count("delta") >= 5, paths
    assert pcache.columns.check_consistency(pcache) == []
    jcache.stop()


@pytest.mark.parametrize("seed", [3, 11])
def test_pdb_churn_rows_match_full_open_and_jax(seed):
    """PDB events stamp the dirty tracker like the JAX package's: after
    each step, the delta-synced job rows (j_pdb among them) and the
    snapshot equal a forced full rescan and the JAX package's, the
    job-alloc float32 twin equals a fresh cast of the ledger, and both
    packages decide alike (default conf)."""
    rng = np.random.default_rng(seed)
    jcache, pcache = both_clusters()
    jconf = jax_parse_conf(DEFAULT_CONF)
    pconf = parse_scheduler_conf(DEFAULT_CONF)
    apply(jcache, pcache, [("add_queue", JAX.pod.Queue(name="default", uid="udefault"))])
    jactions = JaxScheduler(jcache, conf=jconf).actions
    pactions = Scheduler(pcache, conf=pconf, device="cpu").actions
    churn = PdbChurner(jcache, rng, JAX)
    for _ in range(3):
        apply(jcache, pcache, churn.add_gang() + churn.add_pdb_gang())
    cols = pcache.columns
    paths, pdb_rows = [], 0
    for cycle in range(12):
        apply(jcache, pcache, churn.step())
        where = f"seed {seed} cycle {cycle}"
        jssn = jax_open(jcache, jconf.tiers)
        pssn = open_session(pcache, pconf.tiers, "cpu")
        try:
            paths.append(pcache.last_open_path)
            assert jcache.last_open_path == pcache.last_open_path, where
            psnap, _ = cols.device_snapshot(pssn)
            got = snapshot_arrays(psnap)
            rows = {f: getattr(cols, f).copy() for f in JOB_ROWS}
            pdb_rows += int(cols.j_pdb[cols.j_sess].sum())
            assert_arrays_equal(rows, {f: getattr(jcache.columns, f) for f in JOB_ROWS},
                                where + " job rows vs JAX")
            jsnap, _ = jcache.columns.device_snapshot(jssn)
            assert_arrays_equal(got, snapshot_arrays(jsnap), where + " snapshot vs JAX")
            cols.sync_session_rows(pssn)   # the forced full rescan
            assert_arrays_equal({f: getattr(cols, f) for f in JOB_ROWS}, rows,
                                where + " job rows vs full")
            full, _ = cols.device_snapshot(pssn)
            assert_arrays_equal(snapshot_arrays(full), got, where + " snapshot vs full")
            assert np.array_equal(cols.job_alloc32(), cols.j_alloc.astype(np.float32)), where
            run_actions(jactions, jssn)
            run_actions(pactions, pssn)
        finally:
            jax_close(jssn)
            close_session(pssn)
        _assert_same(observed(jcache), observed(pcache), where)
        assert sorted(jcache.events) == sorted(pcache.events), where
        assert cols.check_consistency(pcache) == [], where
        assert np.array_equal(cols.job_alloc32(), cols.j_alloc.astype(np.float32)), where
    assert paths.count("delta") >= 4, paths
    assert pdb_rows > 0
    jcache.stop()


# --------------------------------------------------------------------------
# (c), (d) the open rule's fallbacks
# --------------------------------------------------------------------------


def _open_close(cache, conf) -> str:
    close_session(open_session(cache, conf.tiers, "cpu"))
    return cache.last_open_path


def test_row_space_changes_force_one_full_open():
    """A queue add or a priority-class add forces one full open (the JAX
    package's test_full_fallback_on_row_space_changes)."""
    cache = port_cluster()
    conf = parse_scheduler_conf(DEFAULT_CONF)
    churn = Churner(cache, np.random.default_rng(1), PORT)
    feed(cache, churn.add_gang())
    seq = [_open_close(cache, conf)]               # cold cache
    feed(cache, churn.add_gang())
    seq.append(_open_close(cache, conf))           # low churn
    cache.add_queue(ppod.Queue(name="q9", uid="uq9", weight=1))
    seq += [_open_close(cache, conf), _open_close(cache, conf)]
    cache.add_priority_class(ppod.PriorityClass(name="p", value=9))
    seq += [_open_close(cache, conf), _open_close(cache, conf)]
    assert seq == ["full", "delta", "full", "delta", "full", "delta"]


def test_delta_disabled_always_takes_the_full_path():
    cache = port_cluster()
    cache.delta_enabled = False
    conf = parse_scheduler_conf(DEFAULT_CONF)
    churn = Churner(cache, np.random.default_rng(2), PORT)
    feed(cache, churn.add_gang())
    for _ in range(3):
        assert _open_close(cache, conf) == "full"
        assert cache.columns.last_snapshot_path == "full"


def test_snapshot_delta_env_switch_sets_the_oracle(monkeypatch):
    monkeypatch.setenv("KB_SNAPSHOT_DELTA", "0")
    assert SchedulerCache().delta_enabled is False
    monkeypatch.delenv("KB_SNAPSHOT_DELTA")
    assert SchedulerCache().delta_enabled is True


# --------------------------------------------------------------------------
# (e) the delta close against the full visit and the JAX package
# --------------------------------------------------------------------------


def test_delta_close_matches_full_close_and_jax(monkeypatch):
    """Over churn, the delta close (touched and reporting rows only) leaves
    the end state of KB_DELTA_CLOSE=0's full visit — phases, counts,
    events, queue statuses — and the JAX package's."""

    def run(delta_close: bool):
        if delta_close:
            monkeypatch.delenv("KB_DELTA_CLOSE", raising=False)
        else:
            monkeypatch.setenv("KB_DELTA_CLOSE", "0")
        rng = np.random.default_rng(13)
        jcache, pcache = both_clusters()
        jsched = JaxScheduler(jcache, conf=jax_parse_conf(DEFAULT_CONF))
        psched = Scheduler(pcache, conf=parse_scheduler_conf(DEFAULT_CONF), device="cpu")
        churn = Churner(jcache, rng, JAX)
        for _ in range(4):
            apply(jcache, pcache, churn.add_gang())
        states = []
        for cycle in range(10):
            apply(jcache, pcache, churn.step())
            jsched.run_once()
            psched.run_once()
            _assert_same(observed(jcache), observed(pcache),
                         f"delta_close={delta_close} cycle {cycle}")
            states.append({uid: (j.pod_group.phase, j.pod_group.running,
                                 j.pod_group.failed, j.pod_group.succeeded)
                           for uid, j in sorted(pcache.jobs.items())
                           if j.pod_group is not None})
            states.append({q: dict(c) for q, c in sorted(pcache._queue_status_written.items())})
        assert pcache.columns.check_consistency(pcache) == []
        jcache.stop()
        return states, list(pcache.events)

    delta_states, delta_events = run(True)
    full_states, full_events = run(False)
    assert delta_states == full_states
    assert delta_events == full_events


# --------------------------------------------------------------------------
# (f), (g) fit state and failed opens
# --------------------------------------------------------------------------


def test_stale_fit_state_cleared_across_delta_opens():
    """A job that recorded fit errors starts the next session clean even
    when the open takes the delta path (note_fit_state feeds the clearing
    set; the JAX package's test of the same name)."""
    cache = port_cluster()
    conf = parse_scheduler_conf(DEFAULT_CONF)
    feed(cache, Churner(cache, np.random.default_rng(4), PORT).add_gang(size=2))
    ssn = open_session(cache, conf.tiers, "cpu")
    job = next(iter(ssn.jobs.values()))
    job.job_fit_errors = "synthetic"
    fe = FitErrors()
    fe.set_histogram({"synthetic reason": 1}, 1)
    job.nodes_fit_errors["t"] = fe
    ssn.note_fit_state(job)
    close_session(ssn)
    ssn = open_session(cache, conf.tiers, "cpu")
    try:
        assert cache.last_open_path == "delta"
        assert job.uid not in cache.fit_state_jobs
        assert job.job_fit_errors == "" and job.nodes_fit_errors == {}
    finally:
        close_session(ssn)


def test_failed_plugin_open_invalidates_the_open_cache(monkeypatch):
    """An exception inside a plugin's open releases the session gate and
    invalidates the open cache, so the next open is full."""
    cache = port_cluster()
    conf = parse_scheduler_conf(DEFAULT_CONF)
    churn = Churner(cache, np.random.default_rng(5), PORT)
    feed(cache, churn.add_gang())
    assert _open_close(cache, conf) == "full"
    feed(cache, churn.add_gang())

    def boom(self, ssn):
        raise RuntimeError("plugin open failed")

    with monkeypatch.context() as m:
        m.setattr(GangPlugin, "on_session_open", boom)
        with pytest.raises(RuntimeError, match="plugin open failed"):
            open_session(cache, conf.tiers, "cpu")
    assert cache.last_open_path == "delta"   # the failed open was a delta
    assert not cache.open_cache.valid
    assert not cache._session_active
    assert _open_close(cache, conf) == "full"
    assert _open_close(cache, conf) == "delta"
