"""PodDisruptionBudget gangs and the PV ledger, the port against the JAX
package.

The cases of ``tests/test_conformance.py``'s ``TestPDBGang``,
``TestVolumeScenarios`` and ``TestRealRequestBackfill`` are built once as
ingest events (and PV ledger contents) and fed to a JAX cache and a port
cache, each with its own package's ``StandalonePVBinder`` where the case
has volumes.  Both run the case's actions for three cycles, a kubelet step
starting bound pods between them, and after every cycle the binds, task
statuses, PodGroup statuses, pod conditions, queue statuses, the event
record (as a multiset) and the PV ledger (durable bindings and
reservations) must be equal.  Each case runs on the port's three
session legs: exclusive at its defaults (the delta open and close, the
resident snapshot, the warm carry),
exclusive as the oracle (those switched off), and isolated
(``open_session(..., isolated=True)`` on both packages).  The original
assertions of each case are kept on the port's side.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest

import kube_batch_tpu_torch.api.pod as ppod
from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
from kube_batch_tpu.api.pod import PersistentVolume, PodDisruptionBudget, PodGroup, Queue
from kube_batch_tpu.api.types import PodPhase
from kube_batch_tpu.cache.volume import StandalonePVBinder as JaxPVBinder
from kube_batch_tpu.framework.conf import parse_scheduler_conf as jax_parse_conf
from kube_batch_tpu.framework.interface import get_action as jax_get_action
from kube_batch_tpu.framework.session import close_session as jax_close
from kube_batch_tpu.framework.session import open_session as jax_open
from kube_batch_tpu_torch.api.resources import DEFAULT_SPEC
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.cache.volume import StandalonePVBinder
from kube_batch_tpu_torch.framework.conf import parse_scheduler_conf
from kube_batch_tpu_torch.framework.interface import get_action
from kube_batch_tpu_torch.framework.session import close_session, open_session
from kube_batch_tpu_torch.testing.cycle_drive import oracle_switches
from fixtures import GiB, build_node, build_pod
from test_torch_cycle import _assert_same, _from_events, mirror, observed
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

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

#: TestRealRequestBackfill's conf with the stranded-capacity pass off
CONF_BACKFILL_OFF = """
actions: "allocate, backfill"
tiers:
- plugins:
  - name: priority
    arguments:
      backfill.realRequests: "false"
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: proportion
  - name: nodeorder
  - name: predicates
"""

LEGS = ("defaults", "oracle", "isolated")
N_CYCLES = 3


class Pair:
    """A JAX and a port cache fed the same events, the port's session leg
    chosen by ``leg``."""

    def __init__(self, events, leg: str, pvs=(), pv_binder: bool = False,
                 conf_text: str = TWO_TIER_CONF):
        self.jcache, self.pcache = _from_events(events)
        self.leg = leg
        if pv_binder:
            # the ledger goes in after the cluster, as test_conformance's
            # _cache_with_pv_binder does
            self.jcache.volume_binder = JaxPVBinder()
            self.pcache.volume_binder = StandalonePVBinder()
            for pv in pvs:
                self.jcache.volume_binder.add_pv(pv)
                self.pcache.volume_binder.add_pv(mirror(pv))
        self.pcache.delta_enabled = leg != "oracle"
        self.jconf = jax_parse_conf(conf_text)
        self.pconf = parse_scheduler_conf(conf_text)
        self.pactions = {}

    def apply(self, events) -> None:
        for kind, obj in events:
            getattr(self.jcache, kind)(obj)
            getattr(self.pcache, kind)(mirror(obj))

    def cycle(self, action_names, where: str):
        """One session of ``action_names`` on each cache; returns the port
        session."""
        isolated = self.leg == "isolated"
        jssn = jax_open(self.jcache, self.jconf.tiers, isolated=isolated)
        for name in action_names:
            jax_get_action(name).execute(jssn)
        jax_close(jssn)
        self.jcache.flush_binds()
        with oracle_switches(self.leg == "oracle"):
            pssn = open_session(self.pcache, self.pconf.tiers, "cpu", isolated=isolated)
            for name in action_names:
                self.pactions[name] = get_action(name)
                self.pactions[name].execute(pssn)
            close_session(pssn)
        self.pcache.flush_binds()
        self.check(where)
        return pssn

    def check(self, where: str) -> None:
        _assert_same(observed(self.jcache), observed(self.pcache), where)
        # as multisets: the binder's worker thread appends its Scheduled
        # events concurrently with the cycle's close
        assert sorted(self.jcache.events) == sorted(self.pcache.events), f"{where}: events"
        jvb, pvb = self.jcache.volume_binder, self.pcache.volume_binder
        if isinstance(pvb, StandalonePVBinder):
            assert jvb.bound == pvb.bound, f"{where}: PV bindings"
            assert jvb.reservations == pvb.reservations, f"{where}: PV reservations"
        assert self.pcache.columns.check_consistency(self.pcache) == [], where

    def kubelet(self) -> None:
        """Bound pods start Running (decided on the JAX cache)."""
        self.apply([("update_pod", dataclasses.replace(p, phase=PodPhase.RUNNING))
                    for key, p in sorted(self.jcache.pods.items())
                    if p.node_name and p.phase == PodPhase.PENDING])

    def run(self, action_names, where: str):
        """N_CYCLES cycles with the kubelet between them; returns the port
        session of the first cycle."""
        first = None
        for c in range(N_CYCLES):
            ssn = self.cycle(action_names, f"{where} cycle {c}")
            first = first or ssn
            if c == 0:
                self.after_first = (dict(self.pcache.binder.binds),
                                    list(self.pcache.events))
            self.kubelet()
        return first


def _pod(name, cpu=1000, **kw):
    return build_pod("c1", name, None, PodPhase.PENDING, {"cpu": cpu, "memory": GiB}, **kw)


def _pdb(min_available=3):
    return PodDisruptionBudget(name="pdb1", namespace="c1", min_available=min_available,
                               owner="rs-1")


def _owner_pods(n=3):
    return [("add_pod", _pod(f"w{i}", owner="rs-1")) for i in range(n)]


def _cluster(node_cpu, n_nodes=1):
    return [("add_queue", Queue(name="default"))] + [
        ("add_node", build_node(f"n{i + 1}", cpu=node_cpu, mem=8 * GiB))
        for i in range(n_nodes)]


# --------------------------------------------------------------------------
# TestPDBGang
# --------------------------------------------------------------------------


@pytest.mark.parametrize("leg", LEGS)
def test_gang_defined_only_by_pdb_schedules(leg):
    pair = Pair(_cluster(4000) + [("add_pdb", _pdb())] + _owner_pods(), leg)
    job = pair.pcache.jobs["c1/rs-1"]
    assert job.pdb is not None and job.pod_group is None
    assert job.min_available == 3 and job.queue == "default"
    pair.run(["allocate"], f"pdb-only {leg}")
    assert len(pair.after_first[0]) == 3


@pytest.mark.parametrize("leg", LEGS)
def test_pdb_gang_blocks_partial_placement(leg):
    pair = Pair(_cluster(2000) + [("add_pdb", _pdb())] + _owner_pods(), leg)
    pair.run(["allocate"], f"pdb 2-of-3 {leg}")
    binds, events = pair.after_first
    assert binds == {}  # all or nothing: 2 of 3 fit, 0 bind
    # events only: an Unschedulable event, no PodGroup status write
    assert any(kind == "Unschedulable" and key == "c1/rs-1" for kind, key, _ in events)
    assert pair.pcache.status_updater.pod_groups == []


@pytest.mark.parametrize("leg", LEGS)
def test_delete_pdb_releases_gang(leg):
    pdb = _pdb()
    pair = Pair(_cluster(2000) + [("add_pdb", pdb)] + _owner_pods(), leg)
    pair.apply([("delete_pdb", pdb)])
    job = pair.pcache.jobs["c1/rs-1"]
    assert job.pdb is None
    assert job.pod_group is not None and job.pod_group.shadow
    assert job.min_available == 1
    pair.run(["allocate"], f"pdb deleted {leg}")
    assert len(pair.after_first[0]) == 2


@pytest.mark.parametrize("leg", LEGS)
def test_pods_before_pdb_ordering(leg):
    pair = Pair(_cluster(2000) + _owner_pods(), leg)
    job = pair.pcache.jobs["c1/rs-1"]
    assert job.pod_group is not None and job.pod_group.shadow
    pair.apply([("add_pdb", _pdb())])
    assert job.pod_group is None and job.pdb is not None
    assert job.min_available == 3
    pair.run(["allocate"], f"pods before pdb {leg}")
    assert pair.after_first[0] == {}


@pytest.mark.parametrize("leg", LEGS)
def test_discarded_gang_releases_pv_reservations(leg):
    events = [("add_queue", Queue(name="default")),
              ("add_pod_group", PodGroup(name="gang2", namespace="c1", min_member=2,
                                         queue="default")),
              ("add_node", build_node("n1", cpu=8000, mem=16 * GiB)),
              # a: a satisfiable claim; b: an unsatisfiable one, so the gang
              # discards every cycle
              ("add_pod", _pod("a", group_name="gang2", volume_claims=("claim-a",))),
              ("add_pod", _pod("b", group_name="gang2", volume_claims=("ghost",))),
              # a singleton wanting the same wildcard PV
              ("add_pod", _pod("solo", volume_claims=("claim-solo",)))]
    pair = Pair(events, leg, pvs=[PersistentVolume(name="pv1")], pv_binder=True)
    pair.run(["allocate"], f"discarded gang {leg}")
    binds = pair.after_first[0]
    assert "c1/a" not in binds and "c1/b" not in binds
    assert binds.get("c1/solo") == "n1"
    assert pair.pcache.volume_binder.reservations == {}


# --------------------------------------------------------------------------
# TestVolumeScenarios
# --------------------------------------------------------------------------


@pytest.mark.parametrize("leg", LEGS)
def test_node_without_required_volume_is_skipped(leg):
    events = [("add_queue", Queue(name="default")),
              ("add_node", build_node("n1", cpu=8000, mem=16 * GiB)),
              ("add_node", build_node("n2", cpu=8000, mem=16 * GiB)),
              ("add_pod", _pod("dbpod", volume_claims=("data-claim",)))]
    pair = Pair(events, leg, pvs=[PersistentVolume(name="pv-local", node="n2",
                                                   claim="data-claim")],
                pv_binder=True)
    pair.run(["allocate"], f"node-local PV {leg}")
    assert pair.after_first[0]["c1/dbpod"] == "n2"
    assert pair.pcache.volume_binder.bound == {"data-claim": "pv-local"}
    assert pair.pcache.volume_binder.reservations == {}


@pytest.mark.parametrize("leg", LEGS)
def test_unsatisfiable_claim_fails_placement(leg):
    events = [("add_queue", Queue(name="default")),
              ("add_node", build_node("n1", cpu=8000, mem=16 * GiB)),
              ("add_pod", _pod("dbpod", volume_claims=("ghost-claim",)))]
    pair = Pair(events, leg, pvs=[PersistentVolume(name="pv-other", node="n1",
                                                   claim="someone-else")],
                pv_binder=True)
    pair.run(["allocate"], f"unsatisfiable claim {leg}")
    assert "c1/dbpod" not in pair.pcache.binder.binds


@pytest.mark.parametrize("leg", LEGS)
def test_two_claimants_one_pv(leg):
    events = [("add_queue", Queue(name="default")),
              ("add_node", build_node("n1", cpu=8000, mem=16 * GiB)),
              ("add_pod", _pod("a", volume_claims=("claim-a",))),
              ("add_pod", _pod("b", volume_claims=("claim-b",)))]
    pair = Pair(events, leg, pvs=[PersistentVolume(name="pv1")], pv_binder=True)
    pair.run(["allocate"], f"two claimants {leg}")
    placed = [k for k in ("c1/a", "c1/b") if k in pair.pcache.binder.binds]
    assert len(placed) == 1
    assert len(pair.pcache.volume_binder.bound) == 1


def test_allocate_volumes_idempotent_per_task():
    """The bulk path's pre-check and a demoted job's sequential replay
    allocate the same task twice: no double booking, in either ledger."""
    from kube_batch_tpu.api.pod import Pod as JaxPod
    from kube_batch_tpu.api.resources import DEFAULT_SPEC as JAX_SPEC
    from kube_batch_tpu.api.task_info import TaskInfo as JaxTaskInfo

    pod = JaxPod(name="p", namespace="c1", requests={"cpu": 100}, volume_claims=("c",))
    ledgers = []
    for binder, task, pv in (
            (JaxPVBinder(), JaxTaskInfo(pod, JAX_SPEC), PersistentVolume),
            (StandalonePVBinder(), TaskInfo(mirror(pod), DEFAULT_SPEC), ppod.PersistentVolume)):
        binder.add_pv(pv(name="pv1"))
        binder.add_pv(pv(name="pv2"))
        binder.allocate_volumes(task, "n1")
        binder.allocate_volumes(task, "n1")  # the replay: the same reservation
        assert len(binder.reservations) == 1
        assert len(binder.reservations[task.uid]) == 1
        binder.allocate_volumes(task, "n2")  # moved host: superseded
        assert len(binder.reservations[task.uid]) == 1
        binder.bind_volumes(task)
        assert len(binder.bound) == 1 and binder.reservations == {}
        ledgers.append(binder.bound)
    assert ledgers[0] == ledgers[1]


def test_topology_restricted_pv_follows_node_labels():
    """A PV whose node terms name a zone attaches only where the ingested
    node labels match, fails closed on a node whose labels were never
    ingested, and forgets a deleted node's labels — both ledgers alike."""
    from kube_batch_tpu.api.pod import Node as JaxNode

    zonal = PersistentVolume(name="pv-z", node="n-other",
                             node_terms=[[("zone", "In", ("a",))]])
    answers = []
    for binder, node_cls, pv in ((JaxPVBinder(), JaxNode, zonal),
                                 (StandalonePVBinder(), ppod.Node, mirror(zonal))):
        binder.add_pv(pv)
        binder.set_node_labels("n1", node_cls(name="n1", labels={"zone": "a"}).labels)
        binder.set_node_labels("n2", {"zone": "b"})
        got = [binder._reachable(pv, "n1"), binder._reachable(pv, "n2"),
               binder._reachable(pv, "n3")]
        binder.forget_node_labels("n1")
        got.append(binder._reachable(pv, "n1"))
        answers.append(got)
    assert answers[0] == answers[1] == [True, False, False, False]


def test_node_ingest_feeds_the_ledger_labels():
    """The cache's add_node / delete_node keep the ledger's node labels."""
    _, pcache = _from_events([])
    pcache.volume_binder = StandalonePVBinder()
    pcache.add_node(ppod.Node(name="n1", allocatable={"cpu": 1000.0},
                              labels={"zone": "a"}))
    assert pcache.volume_binder.node_labels["n1"]["zone"] == "a"
    assert pcache.volume_binder.node_labels["n1"]["kubernetes.io/hostname"] == "n1"
    pcache.delete_node("n1")
    assert "n1" not in pcache.volume_binder.node_labels


# --------------------------------------------------------------------------
# TestRealRequestBackfill (the stranded-capacity pass on a PV ledger)
# --------------------------------------------------------------------------


def _stranded_events():
    # gang g: 4 × 1000m whose claims have no PV anywhere — the solve places
    # it, the volume pre-check demotes it, the slow replay discards it;
    # singleton s (later, worse rank) was crowded out by it
    events = [("add_queue", Queue(name="default")),
              ("add_pod_group", PodGroup(name="g", namespace="c1", min_member=4,
                                         queue="default", creation_index=1)),
              ("add_pod_group", PodGroup(name="s", namespace="c1", min_member=1,
                                         queue="default", creation_index=2)),
              ("add_node", build_node("n1", cpu=4000, mem=16 * GiB))]
    events += [("add_pod", _pod(f"g-{i}", group_name="g", volume_claims=("no-such-pv",)))
               for i in range(4)]
    return events + [("add_pod", _pod("s-0", group_name="s"))]


@pytest.mark.parametrize("leg", LEGS)
def test_stranded_capacity_backfilled(leg):
    pair = Pair(_stranded_events(), leg, pv_binder=True)
    ssn = pair.run(["allocate", "backfill"], f"stranded {leg}")
    assert ssn.host_discards >= 1
    assert set(pair.after_first[0]) == {"c1/s-0"}
    assert not pair.pcache.evictor.evicts


@pytest.mark.parametrize("leg", LEGS)
def test_flag_off_leaves_capacity_stranded(leg):
    pair = Pair(_stranded_events(), leg, pv_binder=True, conf_text=CONF_BACKFILL_OFF)
    pair.run(["allocate", "backfill"], f"stranded, pass off {leg}")
    assert pair.after_first[0] == {}  # s-0 waits for the next cycle


# --------------------------------------------------------------------------
# the feature drive (chip_smoke's cycle_features) on the CPU
# --------------------------------------------------------------------------


def test_feature_drive_defaults_equal_oracle():
    """``drive_features`` at a small size: PDB gangs, claims on the PV
    ledger and on missing PVs and a custom score row, two exclusive cycles
    and one isolated that places new arrivals, with every per-cycle check
    passing; the defaults and
    the oracle (the four cross-cycle switches off) decide identically, as
    the card and the CPU must on the chip; cycle 1's K1 and K2 plain
    versions agree with themselves on the plane with the row."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_features, oracle_switches

    runs = []
    for oracle in (False, True):
        with oracle_switches(oracle):
            runs.append(drive_features(1024, 128, 48, 3, pdb_gang_frac=0.1, device="cpu",
                                       hold_first=True, keep_states=True))
    for c, (a, b) in enumerate(zip(runs[0]["states"], runs[1]["states"])):
        for key in a:
            assert a[key] == b[key], f"cycle {c + 1} {key}"
    cycles = runs[0]["cycles"]
    assert [c["session"] for c in cycles] == ["exclusive", "exclusive", "isolated"]
    assert cycles[0]["mode"] == "full" and cycles[0]["new_binds"] > 900
    assert any(c["volume_demoted_jobs"] for c in cycles)
    last = cycles[-1]["checks"]
    assert last["pdb_gangs_bound"] and last["pdb_gangs_blocked"]
    assert last["impossible_claims_unbound"] == 3 and last["bound_pods_with_claims"] > 0
    assert cycles[-1]["clone_ms"] > 0 and cycles[-1]["allocate_ms"]["snapshot_build"] > 0
    # the isolated cycle places arrivals: a PDB gang and claims on new PVs
    prev = cycles[1]["checks"]
    assert cycles[2]["arrivals"] > 0 and cycles[2]["new_binds"] > 0
    assert last["pdb_gangs_bound"] > prev["pdb_gangs_bound"]
    assert last["bound_pods_with_claims"] > prev["bound_pods_with_claims"]
    assert runs[0]["held"]["K1"]["max_abs_err"] == 0.0
