"""The port's guard plane (``KB_GUARD``) against the JAX package's.

The sentinel math — ``allocate_invariants``, ``evict_invariants``,
``enqueue_gate_invariants`` and the eligibility checksum — runs on the same
snapshots and results on both sides, lawful and with planted faults (a NaN
ledger, an inconsistent ledger, pipelined occupancy, ineligible
placements and victims, a non-candidate admission): verdicts, histograms
and checksums must be equal.  The breaker's arcs are the JAX package's
``TestGuardPlaneBreaker`` on the port's plane.  Fail-closed-then-heal (a
zeroed resident capacity word) and the phantom-pending checksum trip are
driven on a port cache and a JAX cache fed the same events: both must
bind the same pods, trip the same number of times and demote the same
paths.  A trip's bundle is dumped atomically, loads and replays; and the
guard adds no readback to the allocate action.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.api.pod import GROUP_NAME_ANNOTATION, Node, Pod, PodGroup, Queue
from kube_batch_tpu.api.types import PodPhase, TaskStatus
from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
from kube_batch_tpu.framework.conf import load_scheduler_conf as jax_load_conf
from kube_batch_tpu.guard import guard_of as jax_guard_of
from kube_batch_tpu.ops import invariants as jinv
from kube_batch_tpu.ops.assignment import AllocateResult as JaxAllocateResult
from kube_batch_tpu.ops.eviction import EvictConfig as JaxEvictConfig
from kube_batch_tpu.ops.eviction import EvictResult as JaxEvictResult
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.api.convert import (
    config_from_fields,
    result_to_numpy,
    snapshot_from_numpy,
)
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
from kube_batch_tpu_torch.guard import guard_of as port_guard_of
from kube_batch_tpu_torch.guard.plane import DEMOTED, HEALTHY, PROBING, GuardPlane
from kube_batch_tpu_torch.ops import invariants as pinv
from kube_batch_tpu_torch.ops.assignment import AllocateResult
from kube_batch_tpu_torch.ops.eviction import EvictConfig, EvictResult
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_cycle import apply
from test_torch_warm import session_snapshot
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

CPU = torch.device("cpu")
GiB = float(1 << 30)


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(jax.device_get(x))


def assert_verdicts(port, want, where: str) -> None:
    """(verdict, hist[, checksum]) equal on both sides."""
    for name, a, b in zip(("verdict", "hist", "checksum"), port, want):
        a, b = n(a), n(b)
        assert a.dtype == b.dtype == np.int32, f"{where}: {name} dtype"
        assert np.array_equal(a, b), f"{where}: {name} {a} / {b}"


def both_allocate_sentinels(jsnap, jconfig):
    want = jinv.allocate_sentinel_solve(jsnap, jconfig)
    got = pinv.allocate_sentinel_solve(snapshot_from_numpy(jsnap, CPU),
                                       config_from_fields(jconfig))
    return got, want


# --------------------------------------------------------------------------
# the sentinel math
# --------------------------------------------------------------------------


def test_allocate_sentinels_lawful_match_jax():
    """Lawful full and compacted solves: verdict 0, empty histogram, and
    the checksum equal to the JAX package's and to the host twin."""
    jsnap, jconfig = session_snapshot(400, 16, 7)
    got, want = both_allocate_sentinels(jsnap, jconfig)
    assert_verdicts(got[1:], want[1:], "full")
    assert int(got[1]) == 0 and not n(got[2]).any()
    assert int(n(got[3])) & 0xFFFFFFFF == pinv.host_eligibility_checksum(jsnap)
    assert pinv.host_eligibility_checksum(jsnap) == jinv.host_eligibility_checksum(jsnap)
    rows = np.flatnonzero(jsnap.task_pending).astype(np.int32)
    pend = np.full(512, -1, np.int32)
    pend[: rows.size] = rows
    cfg = jconfig._replace(topk=4)
    want = jinv.allocate_topk_sentinel_solve(jsnap, jnp.asarray(pend), cfg)
    got = pinv.allocate_topk_sentinel_solve(snapshot_from_numpy(jsnap, CPU),
                                            torch.from_numpy(pend), config_from_fields(cfg))
    assert_verdicts(got[1:], want[1:], "topk")


def _planted(jsnap, kind: str):
    s = {f: np.array(getattr(jsnap, f)) for f in jsnap._fields}
    if kind == "nan_ledger":
        s["node_used"][0, 0] = np.nan
    elif kind == "inconsistent_ledger":
        s["node_idle"][0, 0] = 1e9
    elif kind == "pipelined_occupancy":
        # a node full to its capacity plus a pipelined task's borrow: lawful
        r = int(np.flatnonzero(s["task_valid"] & ~s["task_pending"])[0]) \
            if (s["task_valid"] & ~s["task_pending"]).any() \
            else int(np.flatnonzero(s["task_pending"])[-1])
        s["task_status"][r] = int(TaskStatus.PIPELINED)
        s["task_node"][r] = 0
        s["task_pending"][r] = False
        s["node_idle"][0] = 0.0
        s["node_used"][0] = s["node_alloc"][0] + s["task_resreq"][r]
    return type(jsnap)(**s)


@pytest.mark.parametrize("kind,slot", [("nan_ledger", "nonfinite"),
                                       ("inconsistent_ledger", "node_overcommit"),
                                       ("pipelined_occupancy", None)])
def test_allocate_sentinel_planted_faults_match_jax(kind, slot):
    jsnap, jconfig = session_snapshot(400, 16, 7)
    bad = _planted(jsnap, kind)
    got, want = both_allocate_sentinels(bad, jconfig)
    assert_verdicts(got[1:], want[1:], kind)
    hist = n(got[2])
    if slot is None:
        assert int(got[1]) == 0, f"{kind}: {hist}"
    else:
        assert hist[pinv.INVARIANT_NAMES.index(slot)] > 0


def test_allocate_invariants_on_an_unlawful_result_match_jax():
    """A result that places rows that are not eligible pending ones (the
    padding past the live tasks), places on an unschedulable node,
    overcommits a node and breaks a gang: every slot equal on both sides."""
    jsnap, jconfig = session_snapshot(400, 16, 7)
    psnap = snapshot_from_numpy(jsnap, CPU)
    res = result_to_numpy(pinv.allocate_solve(psnap, config_from_fields(jconfig)))
    assigned = res.assigned.copy()
    ineligible = np.flatnonzero(~jsnap.task_valid)
    placed = np.flatnonzero(assigned >= 0)
    assigned[ineligible[:3]] = 1
    assigned[placed[:40]] = 2            # piles onto node 2
    assigned[placed[40]] = -1            # a gang loses a member
    ns = np.array(jsnap.node_sched)
    ns[5] = False
    assigned[placed[41]] = 5
    jsnap = jsnap._replace(node_sched=ns)
    res = res._replace(assigned=assigned)
    want = jax.jit(jinv.allocate_invariants, static_argnums=2)(
        jsnap, JaxAllocateResult(*map(jnp.asarray, res)), jconfig)
    got = pinv.allocate_invariants(snapshot_from_numpy(jsnap, CPU),
                                   AllocateResult(*map(torch.from_numpy, res)),
                                   config_from_fields(jconfig))
    assert_verdicts(got, want, "unlawful")
    hist = n(got[1])
    for slot in ("assign_ineligible", "assign_infeasible", "node_overcommit",
                 "gang_violation"):
        assert hist[pinv.INVARIANT_NAMES.index(slot)] > 0, slot


def _overcommit_snapshot():
    from kube_batch_tpu.framework.session import close_session, open_session
    from kube_batch_tpu.testing.synthetic import synthetic_overcommit_cluster

    cache = synthetic_overcommit_cluster(n_running=192, n_pending=96, n_nodes=48, seed=2)
    ssn = open_session(cache, jax_load_conf(None).tiers)
    try:
        snap, _meta = cache.columns.device_snapshot(ssn)
    finally:
        close_session(ssn)
    return jax.device_get(snap)


def test_evict_sentinel_and_invariants_match_jax():
    """The reclaim solve's sentinel (lawful: verdict 0, claims made) and
    ``evict_invariants`` on a result that evicts a pending row and leaves
    a claim uncovered — equal on both sides."""
    jsnap = _overcommit_snapshot()
    jcfg = JaxEvictConfig(mode="reclaim")
    jres, jv, jh, je = jinv.evict_sentinel_solve(jsnap, jcfg)
    psnap = snapshot_from_numpy(jsnap, CPU)
    pres, _rounds, pv, ph, pe = pinv.evict_sentinel_solve(psnap, EvictConfig(mode="reclaim"))
    assert_verdicts((pv, ph, pe), (jv, jh, je), "reclaim")
    assert int(pv) == 0 and int((pres.claim_node >= 0).sum()) > 0
    assert int(n(pe)) & 0xFFFFFFFF == pinv.host_eligibility_checksum(jsnap)
    claim = n(pres.claim_node).copy()
    evicted = n(pres.evicted).copy()
    vc = n(pres.victim_claimant).copy()
    pending = np.flatnonzero(jsnap.task_pending)
    evicted[pending[0]] = True            # a pending "victim"
    vc[pending[0]] = int(np.flatnonzero(claim >= 0)[0])
    victims = np.flatnonzero(n(pres.evicted))
    evicted[victims[0]] = False           # a claim loses cover
    vc[victims[0]] = -1
    want = jax.jit(jinv.evict_invariants, static_argnums=2)(
        jsnap, JaxEvictResult(*map(jnp.asarray, (claim, evicted, vc))), jcfg)
    got = pinv.evict_invariants(psnap, EvictResult(*map(torch.from_numpy, (claim, evicted, vc))),
                                EvictConfig(mode="reclaim"))
    assert_verdicts(got, want, "unlawful evictions")
    assert n(got[1])[pinv.INVARIANT_NAMES.index("victim_ineligible")] > 0


@pytest.mark.parametrize("fault", [None, "nan_idle", "non_candidate"])
def test_enqueue_gate_sentinel_matches_jax(fault):
    rng = np.random.default_rng(4)
    J, R = 256, 3
    min_res = rng.choice([500.0, 1000.0, 4000.0], (J, R)).astype(np.float32)
    cand = rng.random(J) < 0.7
    idle = np.array([60_000.0, 60_000.0, 60_000.0], np.float32)
    quanta = np.array([1.0, 1.0, 1.0], np.float32)
    if fault == "nan_idle":
        idle[1] = np.nan
    want = jinv.enqueue_gate_sentinel_solve(min_res, cand, idle, quanta)
    got = pinv.enqueue_gate_sentinel_solve(*map(torch.from_numpy, (min_res, cand, idle,
                                                                    quanta)))
    assert np.array_equal(n(got[0]), n(want[0]))
    assert_verdicts(got[1:], want[1:], f"gate {fault}")
    if fault == "non_candidate":
        admitted = n(got[0]).copy()
        admitted[np.flatnonzero(~cand)[0]] = True
        want = jinv.enqueue_gate_invariants(admitted, cand, min_res, idle, quanta)
        got = pinv.enqueue_gate_invariants(*map(torch.from_numpy, (admitted, cand, min_res,
                                                                    idle, quanta)))
        assert_verdicts(got, want, "non-candidate")
    if fault is not None:
        assert int(got[-2]) > 0  # the verdict


def test_eligibility_checksum_matches_jax_and_the_host_twin():
    """The device checksum equals the JAX package's and the host twin's
    (unsigned) on a snapshot with running and pending rows, and moves when
    one running row's pending bit flips."""
    jsnap = _overcommit_snapshot()
    want = int(n(jax.jit(jinv.eligibility_checksum)(jsnap)))
    got = int(pinv.eligibility_checksum(snapshot_from_numpy(jsnap, CPU)))
    assert got == want
    assert got & 0xFFFFFFFF == pinv.host_eligibility_checksum(jsnap)
    pending = np.array(jsnap.task_pending)
    pending[np.flatnonzero(jsnap.task_status == int(TaskStatus.RUNNING))[0]] = True
    flipped = jsnap._replace(task_pending=pending)
    assert int(pinv.eligibility_checksum(snapshot_from_numpy(flipped, CPU))) != got


# --------------------------------------------------------------------------
# the breaker (the JAX package's TestGuardPlaneBreaker on the port's plane)
# --------------------------------------------------------------------------


class TestGuardPlaneBreaker:
    def _plane(self, cooldown=3):
        return GuardPlane(enabled=True, audit_every=0, cooldown=cooldown)

    def test_demote_probe_repromote_arc(self):
        gp = self._plane(cooldown=3)
        assert gp.allow("topk")
        gp.consume_verdict("allocate", ["topk"], 7)
        assert gp.paths["topk"].state == DEMOTED and not gp.allow("topk")
        gp.end_cycle()  # the trip cycle itself is not a clean cycle
        for _ in range(3):
            gp.end_cycle()
        assert gp.paths["topk"].state == PROBING and gp.allow("topk")
        gp.consume_verdict("allocate", ["topk"], 0)
        gp.end_cycle()
        assert gp.paths["topk"].state == HEALTHY
        assert gp.paths["topk"].promotions == 1

    def test_failed_probe_re_demotes_and_never_flaps_per_cycle(self):
        gp = self._plane(cooldown=2)
        gp.consume_verdict("allocate", ["topk"], 1)
        for _ in range(3):
            gp.end_cycle()
        assert gp.paths["topk"].state == PROBING
        gp.consume_verdict("allocate", ["topk"], 1)
        assert gp.paths["topk"].state == DEMOTED
        gp.end_cycle()
        gp.end_cycle()
        assert gp.paths["topk"].state == DEMOTED
        gp.end_cycle()
        assert gp.paths["topk"].state == PROBING

    def test_unengaged_probe_waits_without_wedging(self):
        gp = self._plane(cooldown=1)
        gp.consume_verdict("allocate", ["warm"], 1)
        gp.end_cycle()
        gp.end_cycle()
        assert gp.paths["warm"].state == PROBING
        for _ in range(5):
            gp.end_cycle()
        assert gp.paths["warm"].state == PROBING and gp.allow("warm")
        gp.consume_verdict("allocate", ["warm"], 0)
        gp.end_cycle()
        assert gp.paths["warm"].state == HEALTHY

    def test_unattributable_trip_demotes_engaged_history(self):
        gp = self._plane()
        gp.consume_verdict("allocate", ["topk", "warm"], 0)
        gp.consume_verdict("reclaim", [], 3)
        assert gp.paths["topk"].state == DEMOTED
        assert gp.paths["warm"].state == DEMOTED
        assert gp.paths["shard_map"].state == HEALTHY
        assert gp.paths["pallas"].state == HEALTHY

    def test_audit_mismatch_trips_and_demotes(self):
        gp = self._plane()
        gp.note_audit("allocate", ["topk"], matched=False, detail="mismatch")
        assert gp.paths["topk"].state == DEMOTED
        assert gp.audits_mismatched == 1
        assert any(t["reason"] == "audit" for t in gp.trip_log)

    def test_audit_cadence_counts_dispatches(self):
        gp = GuardPlane(enabled=True, audit_every=4, cooldown=2)
        due = [gp.audit_due("allocate") for _ in range(8)]
        assert due == [False, False, False, True, False, False, False, True]
        assert gp.audit_due("reclaim") is False

    def test_trip_concurrent_with_inflight_audit_does_not_wedge(self):
        import threading

        for _ in range(20):
            gp = self._plane(cooldown=2)
            barrier = threading.Barrier(2)

            def sentinel_trip():
                barrier.wait()
                gp.consume_verdict("allocate", ["topk"], 5)

            def audit_mismatch():
                barrier.wait()
                gp.note_audit("allocate", ["topk"], matched=False)

            ts = [threading.Thread(target=sentinel_trip),
                  threading.Thread(target=audit_mismatch)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert gp.paths["topk"].state == DEMOTED
            for _ in range(3):
                gp.end_cycle()
            assert gp.paths["topk"].state == PROBING
            gp.consume_verdict("allocate", ["topk"], 0)
            gp.end_cycle()
            assert gp.paths["topk"].state == HEALTHY

    def test_disabled_plane_allows_and_records_nothing(self):
        gp = GuardPlane(enabled=False)
        assert gp.consume_verdict("allocate", ["topk"], 9) is True
        assert gp.allow("topk") and not gp.audit_due("allocate")
        assert gp.trips_total == 0 and gp.verdicts_consumed == 0

    def test_state_keeps_the_jax_packages_keys(self):
        from kube_batch_tpu.guard.plane import GuardPlane as JaxGuardPlane

        got = GuardPlane(enabled=True, audit_every=0, cooldown=2).state()
        want = JaxGuardPlane(enabled=True, audit_every=0, cooldown=2).state()
        assert set(want) <= set(got)
        assert got["paths"] == want["paths"]


# --------------------------------------------------------------------------
# the guarded cycle, the port against the JAX package on the same events
# --------------------------------------------------------------------------


def gang_events(serial: int, size: int = 2, cpu: float = 500.0) -> list:
    g = f"g{serial}"
    events = [("add_pod_group", PodGroup(name=g, namespace="t", uid=f"pg-{g}",
                                         min_member=size, queue="q0",
                                         creation_index=serial))]
    for k in range(size):
        events.append(("add_pod", Pod(
            name=f"{g}-{k}", namespace="t", uid=f"pod-{g}-{k}",
            requests={"cpu": cpu, "memory": 1 * GiB},
            annotations={GROUP_NAME_ANNOTATION: g}, phase=PodPhase.PENDING,
            creation_index=serial * 100 + k)))
    return events


class Pair:
    """A JAX cache and a port cache fed the same events, each run by its
    scheduler under the shipped conf (capacities reserved so the compacted
    solve and the warm carry engage at this scale)."""

    def __init__(self, tmp_path):
        self.j, self.p = JaxCache(), SchedulerCache()
        for cache in (self.j, self.p):
            cache.columns.reserve(n_tasks=1024, n_nodes=64)
        events = [("add_queue", Queue(name="q0", uid="uq0", weight=1))]
        events += [("add_node", Node(name=f"n{i}", allocatable={
            "cpu": 8000.0, "memory": 64 * GiB, "pods": 110.0})) for i in range(4)]
        apply(self.j, self.p, events)
        self.jsched = JaxScheduler(self.j, conf=jax_load_conf(shipped_conf_path()))
        self.psched = Scheduler(self.p, conf=load_scheduler_conf(shipped_conf_path()),
                                device="cpu")
        # the planes attach now (reading KB_GUARD and its knobs), each
        # dumping its bundles into its own directory
        for cache, attach in ((self.j, jax_guard_of), (self.p, port_guard_of)):
            attach(cache).bundle_dir = str(tmp_path / type(cache).__module__)

    def cycle(self) -> None:
        self.jsched.run_once()
        self.psched.run_once()
        assert self.j.binder.binds == self.p.binder.binds

    def add(self, events) -> None:
        apply(self.j, self.p, events)

    def start_bound(self) -> None:
        self.add([("update_pod", dataclasses.replace(pod, phase=PodPhase.RUNNING))
                  for _k, pod in sorted(self.j.pods.items()) if pod.node_name])

    def guards(self):
        return self.j.guard_plane, self.p.guard_plane

    def assert_same_guard(self) -> None:
        jg, pg = self.guards()
        assert (pg.trips_total, pg.failed_closed) == (jg.trips_total, jg.failed_closed)
        assert ({k: v.state for k, v in pg.paths.items()}
                == {k: v.state for k, v in jg.paths.items()})
        assert [t["demoted"] for t in pg.trip_log] == [t["demoted"] for t in jg.trip_log]


def corrupt_ledger(jcache, pcache) -> None:
    """Zero a live node's capacity word in the resident feature cache (in
    place on the port's tensor; the JAX package's buffer is replaced)."""
    cols = jcache.columns
    feat = cols._dev_cache[None]
    ver, dev = feat["node_alloc"]
    host = np.array(jax.device_get(dev))
    live = int(np.flatnonzero(np.asarray(cols.n_valid))[0])
    host[live] = 0.0
    feat["node_alloc"] = (ver, jax.device_put(host))
    _ver, tensor = pcache.columns._dev_cache[CPU]["node_alloc"]
    tensor[int(np.flatnonzero(pcache.columns.n_valid)[0])] = 0.0


def corrupt_pending(jcache, pcache) -> int:
    """Flip a RUNNING row's resident pending bit, the mirror kept at the
    host's truth (the model of a flipped device word)."""
    cols = jcache.columns
    rc = cols._per_cycle_dev[None]
    r = int(np.flatnonzero(np.asarray(cols.t_status) == int(TaskStatus.RUNNING))[0])
    host = np.array(jax.device_get(rc._dev["task_pending"]))
    host[r] = True
    rc._dev["task_pending"] = jax.device_put(host)
    rc._mirror["task_pending"][r] = False
    pc = pcache.columns
    pr = int(np.flatnonzero(pc.t_status == int(TaskStatus.RUNNING))[0])
    assert pc.task_by_row[pr].key() == cols.task_by_row[r].key()
    prc = pc._per_cycle_dev[CPU]
    prc._dev["task_pending"][pr] = True
    prc._mirror["task_pending"][pr] = False
    return r


def test_clean_cycles_never_trip_and_match_jax(tmp_path):
    pair = Pair(tmp_path)
    for s in range(3):
        pair.add(gang_events(s))
        pair.cycle()
    jg, pg = pair.guards()
    assert pg.enabled and pg.trips_total == 0 and pg.verdicts_consumed > 0
    assert len(pair.p.binder.binds) == 6
    pair.assert_same_guard()
    pair.j.stop()


def test_corrupted_capacity_word_fails_closed_then_heals_like_jax(tmp_path):
    pair = Pair(tmp_path)
    pair.add(gang_events(0))
    pair.cycle()
    before = len(pair.p.binder.binds)
    corrupt_ledger(pair.j, pair.p)
    pair.add(gang_events(1))
    pair.cycle()
    jg, pg = pair.guards()
    assert pg.trips_total >= 1 and pg.failed_closed >= 1
    assert len(pair.p.binder.binds) == before
    assert any("node_overcommit" in t["detail"] for t in pg.trip_log)
    assert not pair.p.columns._warm_tables, "the heal left the carried table"
    pair.assert_same_guard()
    pair.cycle()
    assert len(pair.p.binder.binds) == before + 2
    assert pg.trips_total == jg.trips_total == 1
    pair.assert_same_guard()
    pair.j.stop()


def test_phantom_pending_bit_caught_by_the_host_checksum_like_jax(tmp_path):
    pair = Pair(tmp_path)
    pair.add(gang_events(0))
    pair.cycle()
    pair.start_bound()
    pair.cycle()
    corrupt_pending(pair.j, pair.p)
    before = len(pair.p.binder.binds)
    running = {k for k, p in pair.p.pods.items() if p.node_name}
    pair.add(gang_events(1))
    pair.cycle()
    jg, pg = pair.guards()
    assert pg.trips_total == 1
    assert any("eligibility" in t["detail"] for t in pg.trip_log)
    # the first dispatch on the corrupt column (reclaim) failed closed and
    # healed; the same cycle's allocate placed the new gang lawfully
    assert len(pair.p.binder.binds) == before + 2
    for key in running:
        assert pair.p.binder.binds[key] == pair.p.pods[key].node_name
    pair.assert_same_guard()
    pair.cycle()
    assert pg.trips_total == 1
    pair.assert_same_guard()
    pair.j.stop()


def test_kb_guard_escape_hatch_disables_everything(tmp_path, monkeypatch):
    monkeypatch.setenv("KB_GUARD", "0")
    pair = Pair(tmp_path)
    pair.add(gang_events(0))
    pair.cycle()
    jg, pg = pair.guards()
    assert not pg.enabled and pg.verdicts_consumed == 0
    corrupt_ledger(pair.j, pair.p)
    pair.add(gang_events(1))
    pair.cycle()
    assert pg.trips_total == jg.trips_total == 0
    pair.j.stop()


def test_demoted_paths_run_their_oracles_until_repromoted(tmp_path):
    """A demoted ``warm`` runs the cold build with compaction still on; a
    demoted ``topk`` runs the full solve; healthy again, both engage —
    every cycle places its gang."""
    pair = Pair(tmp_path)
    alloc = next(a for a in pair.psched.actions if a.name == "allocate")
    pg = pair.p.guard_plane
    for s in range(2):
        pair.add(gang_events(s))
        pair.cycle()
    assert alloc.last_topk is not None and alloc.last_warm is not None
    pg.paths["warm"].state = DEMOTED
    pair.add(gang_events(2))
    pair.psched.run_once()
    assert alloc.last_topk is not None and alloc.last_warm is None
    pg.paths["topk"].state = DEMOTED
    pair.add(gang_events(3))
    pair.psched.run_once()
    assert alloc.last_topk is None and alloc.last_warm is None
    pg.paths["topk"].state = pg.paths["warm"].state = HEALTHY
    pair.add(gang_events(4))
    pair.psched.run_once()
    assert alloc.last_topk is not None and alloc.last_warm is not None
    assert len(pair.p.binder.binds) == 10
    pair.j.stop()


def test_allocate_audit_runs_the_oracle_and_matches(tmp_path, monkeypatch):
    """``KB_AUDIT_EVERY=1``: every engaged allocate dispatch is compared
    with the full solve, and a clean run never mismatches."""
    monkeypatch.setenv("KB_AUDIT_EVERY", "1")
    pair = Pair(tmp_path)
    for s in range(3):
        pair.add(gang_events(s))
        pair.cycle()
    jg, pg = pair.guards()
    assert pg.audits_run >= 2 and pg.audits_mismatched == 0
    assert pg.audits_run == jg.audits_run
    pair.j.stop()


# --------------------------------------------------------------------------
# bundles
# --------------------------------------------------------------------------


def test_trip_bundle_is_atomic_loads_and_replays(tmp_path):
    from kube_batch_tpu.guard.bundle import load_bundle as jax_load_bundle
    from kube_batch_tpu_torch.guard.bundle import load_bundle, replay_bundle

    pair = Pair(tmp_path)
    pair.add(gang_events(0))
    pair.cycle()
    corrupt_ledger(pair.j, pair.p)
    pair.add(gang_events(1))
    pair.cycle()
    pg = pair.p.guard_plane
    assert pg.bundles
    root = tmp_path / SchedulerCache.__module__
    entries = sorted(p.name for p in root.iterdir())
    assert entries and all(e.startswith("trip-") for e in entries), entries
    path = pg.bundles[0]
    snap, meta, pend_rows = load_bundle(path)
    assert meta["report"]["verdict"] > 0 and meta["action"] == "allocate"
    assert snap.node_label_bits.dtype == np.uint32
    # the JAX package's loader reads the port's bundle, field for field
    jsnap, jmeta, jpend = jax_load_bundle(path)
    for f in snap._fields:
        assert np.array_equal(getattr(jsnap, f), getattr(snap, f)), f
    assert json.dumps(jmeta, sort_keys=True) == json.dumps(meta, sort_keys=True)
    rep1, rep2 = replay_bundle(path, "cpu"), replay_bundle(path, "cpu")
    assert rep1["reproduced"] and rep1 == rep2
    assert rep1["fast_violations"].get("node_overcommit", 0) > 0
    assert rep1["fast_vs_oracle_mismatches"] == 0
    pair.j.stop()


def test_checksum_trip_bundle_reproduces_via_the_host_checksum(tmp_path):
    from kube_batch_tpu_torch.guard.bundle import replay_bundle

    pair = Pair(tmp_path)
    pair.add(gang_events(0))
    pair.cycle()
    pair.start_bound()
    pair.cycle()
    corrupt_pending(pair.j, pair.p)
    pair.add(gang_events(1))
    pair.cycle()
    rep = replay_bundle(pair.p.guard_plane.bundles[-1], "cpu")
    assert rep["reproduced"] and rep["host_checksum_mismatch"] is True
    pair.j.stop()


def test_a_failed_dump_leaves_no_half_bundle(tmp_path, monkeypatch):
    from kube_batch_tpu_torch.guard import bundle

    jsnap, jconfig = session_snapshot(400, 16, 7)
    snap = snapshot_from_numpy(jsnap, CPU)
    monkeypatch.setattr(bundle.np, "savez",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(OSError, match="disk full"):
        bundle.dump_bundle("allocate", snap, config_from_fields(jconfig), {"verdict": 1},
                           directory=str(tmp_path))
    assert list(tmp_path.iterdir()) == []


# --------------------------------------------------------------------------
# no added readback
# --------------------------------------------------------------------------


def count_readbacks(monkeypatch):
    """Count the calls that move a tensor to the host or read a value off
    it (on the card each is a transfer or a sync)."""
    counts = {"n": 0}
    for name in ("cpu", "item", "tolist", "__bool__", "__int__", "__float__"):
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, _real=real, **k):
            counts["n"] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return counts


@pytest.mark.parametrize("failing", [False, True])
def test_the_guard_adds_no_readback_to_allocate(tmp_path, monkeypatch, failing):
    """An allocate execute reads back as often with the guard on as with it
    off — on a cycle that places everything and on one that leaves a gang
    unplaced (the fit-error histogram's readback)."""
    from kube_batch_tpu_torch.framework.session import close_session, open_session

    def run(guard: bool) -> int:
        monkeypatch.setenv("KB_GUARD", "1" if guard else "0")
        pair = Pair(tmp_path / str(guard))
        pair.add(gang_events(0))
        pair.cycle()
        pair.add(gang_events(1, cpu=9000.0 if failing else 500.0))
        actions = {a.name: a for a in pair.psched.actions}
        alloc = actions["allocate"]
        ssn = open_session(pair.p, pair.psched.conf.tiers, "cpu")
        ssn.action_names = list(actions)
        try:
            actions["enqueue"].execute(ssn)   # the new gang's PodGroup turns Inqueue
            with monkeypatch.context() as m:
                counts = count_readbacks(m)
                alloc.execute(ssn)
        finally:
            close_session(ssn)
        assert alloc.last_fit_histogram == failing
        assert pair.p.guard_plane.enabled == guard
        pair.j.stop()
        return counts["n"]

    assert run(True) == run(False)


def test_guard_drive_on_the_cpu(tmp_path):
    """chip_smoke's guard phase, small and on the CPU (``drive_guard``
    raises on any failed check): audited clean cycles, a zeroed capacity
    word failing closed and healing, re-promotion after the cooldown, the
    phantom pending bit, and the bundle replayed identically."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_guard

    r = drive_guard(1024, 128, 96, str(tmp_path), device="cpu")
    tags = [c["tag"] for c in r["cycles"]]
    assert tags[:5] == ["clean-full", "clean-compacted", "clean-warm",
                        "corrupt-node-alloc", "healed"] and tags[-1] == "phantom-pending"
    assert r["audits_clean"] >= 2 and r["restored_verdict"] == 0
    assert [t["reason"] for t in r["trip_log"]] == ["invariant", "invariant"]
    assert r["guard"]["paths"]["topk"]["promotions"] == 1
