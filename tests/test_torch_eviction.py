"""The port's eviction solve against the JAX package's on the same session
snapshots: reclaim and preempt, the idle-fit gate on and off, and the
victim-gate sets — the default tiers' (gang and conformance) and those a
conf with proportion or drf in the first voting tier gives.  Every
EvictResult field (claim_node, evicted, victim_claimant) must be equal bit
for bit.  The snapshots are small overcommitted clusters (at most 512 task
rows × 64 node rows) whose resource sums stay exact multiples of their
quanta, where any order of the f32 segment sums gives the same value."""

from __future__ import annotations

import numpy as np
import pytest

from kube_batch_tpu import actions as _actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _plugins  # noqa: F401 — registers
from kube_batch_tpu.api.pod import PodGroup, Queue
from kube_batch_tpu.api.types import PodPhase
from kube_batch_tpu.framework.conf import load_scheduler_conf
from kube_batch_tpu.framework.session import close_session, open_session
from kube_batch_tpu.ops.eviction import EvictConfig as JaxEvictConfig
from kube_batch_tpu.ops.eviction import evict_solve as jax_evict_solve
from kube_batch_tpu.testing.synthetic import synthetic_overcommit_cluster
from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
from kube_batch_tpu_torch.ops.eviction import EvictConfig, evict_solve
from fixtures import GiB, build_cache, build_node, build_pod


def _snapshot(cache):
    ssn = open_session(cache, load_scheduler_conf(None).tiers)
    try:
        snap, _meta = cache.columns.device_snapshot(ssn)
    finally:
        close_session(ssn)
    return snap


def _same_queue_cluster(seed: int):
    """One busy queue: low-priority elastic jobs and unbreakable gangs fill
    every node, a few kube-system pods run beside them, and high-priority
    jobs wait — preempt's claimants and victims in one queue, reclaim's
    across the second."""
    rng = np.random.default_rng(seed)
    nodes = [build_node(f"n{i}", cpu=8000, mem=16 * GiB) for i in range(24)]
    pgs, pods = [], []
    for j in range(40):
        gang = j % 4 == 0
        pgs.append(PodGroup(name=f"low{j}", namespace="c1", queue="busy",
                            min_member=2 if gang else 1))
        for k in range(2):
            i = 2 * j + k
            ns = "kube-system" if i % 17 == 0 else "c1"
            pods.append(build_pod(ns if not gang else "c1", f"low{j}-{k}", f"n{i % 24}",
                                  PodPhase.RUNNING,
                                  {"cpu": float(rng.choice([1000, 2000])), "memory": 2 * GiB},
                                  group_name=f"low{j}"))
    for j in range(12):
        pgs.append(PodGroup(name=f"high{j}", namespace="c1",
                            queue="busy" if j % 3 else "idle", min_member=2))
        for k in range(2):
            pods.append(build_pod("c1", f"high{j}-{k}", None, PodPhase.PENDING,
                                  {"cpu": float(rng.choice([500, 1000, 2000])),
                                   "memory": GiB}, group_name=f"high{j}",
                                  priority=100))
    return build_cache(nodes=nodes, pods=pods, pod_groups=pgs,
                       queues=[Queue(name="busy", weight=1), Queue(name="idle", weight=3)])


def _cpu_only_cluster():
    """Two queues of equal weight asking only for cpu: queue a runs on every
    node and holds all of its cpu and pod slots, queue b waits with half as
    much — a is over its deserved share in cpu and pods, so proportion's
    victim budget (which the JAX package checks over every dimension, pods
    included) binds."""
    nodes = [build_node(f"n{i}", cpu=4000, mem=8 * GiB, pods=4) for i in range(16)]
    pgs = [PodGroup(name=f"a{j}", namespace="c1", queue="a", min_member=1)
           for j in range(32)]
    pgs += [PodGroup(name=f"b{j}", namespace="c1", queue="b", min_member=2)
            for j in range(16)]
    pods = [build_pod("c1", f"a{j}-{k}", f"n{(2 * j + k) % 16}", PodPhase.RUNNING,
                      {"cpu": 1000.0}, group_name=f"a{j}")
            for j in range(32) for k in range(2)]
    pods += [build_pod("c1", f"b{j}-{k}", None, PodPhase.PENDING,
                       {"cpu": 1000.0}, group_name=f"b{j}")
             for j in range(16) for k in range(2)]
    return build_cache(nodes=nodes, pods=pods, pod_groups=pgs,
                       queues=[Queue(name="a", weight=1), Queue(name="b", weight=1)])


SNAPSHOTS = {
    "cpu_only": lambda: _snapshot(_cpu_only_cluster()),
    "overcommit": lambda: _snapshot(synthetic_overcommit_cluster(
        n_running=256, n_pending=128, n_nodes=32, seed=3)),
    "same_queue": lambda: _snapshot(_same_queue_cluster(5)),
}

# (mode, idle_gate, victim gates) — the default tiers give gang and
# conformance for both modes; proportion (reclaim) and drf (preempt) bind
# when a conf puts them in the first voting tier
CONFIGS = {
    "reclaim": dict(mode="reclaim"),
    "reclaim_idle_gate": dict(mode="reclaim", idle_gate=True),
    "reclaim_proportion_gate": dict(mode="reclaim", victim_gang=False,
                                    victim_conformance=False, victim_proportion=True),
    "preempt": dict(mode="preempt"),
    "preempt_drf_gate": dict(mode="preempt", victim_gang=False,
                             victim_conformance=False, victim_drf=True),
}


@pytest.fixture(scope="module")
def snapshots():
    return {name: build() for name, build in SNAPSHOTS.items()}


@pytest.mark.parametrize("snap_name", sorted(SNAPSHOTS))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_evict_solve_matches_jax(snapshots, snap_name, cfg_name):
    snap = snapshots[snap_name]
    want = jax_evict_solve(snap, JaxEvictConfig(**CONFIGS[cfg_name]))
    got, rounds = evict_solve(snapshot_from_numpy(snap, "cpu"),
                              EvictConfig(**CONFIGS[cfg_name]))
    for field in ("claim_node", "evicted", "victim_claimant"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert 1 <= rounds <= EvictConfig().rounds


@pytest.mark.parametrize("cfg_name", ["reclaim", "preempt",
                                      "reclaim_proportion_gate", "preempt_drf_gate"])
def test_fixtures_make_claims(snapshots, cfg_name):
    """Each mode and gate set claims and evicts on a snapshot built for
    it, so the parity above compares real work."""
    snap_name = {"reclaim": "overcommit", "preempt": "same_queue",
                 "reclaim_proportion_gate": "cpu_only",
                 "preempt_drf_gate": "same_queue"}[cfg_name]
    got, rounds = evict_solve(snapshot_from_numpy(snapshots[snap_name], "cpu"),
                              EvictConfig(**CONFIGS[cfg_name]))
    assert int((got.claim_node >= 0).sum()) > 0
    assert int(got.evicted.sum()) > 0
    # every victim serves a claimant that holds a claim
    vc = got.victim_claimant[got.evicted].long()
    assert bool((got.claim_node[vc] >= 0).all())


def test_idle_gate_leaves_idle_fitting_claimants_to_allocate(snapshots):
    """A claimant that fits some node's free Idle makes no claim when the
    gate is on (allocate places it later in the cycle)."""
    snap = snapshot_from_numpy(snapshots["same_queue"], "cpu")
    off, _ = evict_solve(snap, EvictConfig(mode="reclaim"))
    on, _ = evict_solve(snap, EvictConfig(mode="reclaim", idle_gate=True))
    assert int((on.claim_node >= 0).sum()) <= int((off.claim_node >= 0).sum())
