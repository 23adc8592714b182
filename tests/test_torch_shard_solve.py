"""The port's sharded solves (``kube_batch_tpu_torch/parallel``) on an
8-shard CPU mesh against the JAX package's on its 8-device CPU mesh, and
against the port's own single-device solves.

One session snapshot serves every solve: an overcommitted cluster padded to
512 task rows × 256 node rows (past ``SHARD_MIN_NODES``) whose running
gangs fill the nodes of queue q0 — a quarter of them being deleted
(Releasing capacity), a few gone (Idle capacity) — while q1 waits
(reclaim's claimants and allocate's bidders) and high-priority q0 gangs
wait too (preempt's).  The full solve runs on the 1-D mesh and the
(tasks=2, nodes=4) grid; the compacted, warm, evict (reclaim and
preempt), histogram, bucketed histogram, probe and gate solves on the
1-D mesh.  Int and bool fields must be equal bit for bit, f32 fields
equal.  A second snapshot of identical nodes makes score ties cross every
shard, and a crafted payload makes (score, hash) ties cross shards, where
only the lowest global index may win.  The collective byte counts are held
against the JAX package's ``collective_stats`` at the same mesh and
buckets.

The JAX package's sharded solve with ``use_pallas=True`` does not trace
(its ``_combine_best`` stacks K1's f32 hash with int32 keys), so the
Pallas leg holds the port's sharded solve against the JAX package's
single-device Pallas solve (interpret mode).  The snapshots' resource sums
are exact multiples of their quanta, so any order of the f32 sums gives
the same value; every score is +0.0 or away from zero (ROADMAP Queue 3)."""

from __future__ import annotations

import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu import actions as _actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _plugins  # noqa: F401 — registers
from kube_batch_tpu.ops.assignment import AllocateConfig as JaxConfig
from kube_batch_tpu.ops.eviction import EvictConfig as JaxEvict
from kube_batch_tpu_torch.api.convert import (
    config_from_fields,
    result_to_numpy,
    snapshot_from_numpy,
)
from kube_batch_tpu_torch.ops import assignment as asg
from kube_batch_tpu_torch.ops.eviction import EvictConfig, evict_solve
from kube_batch_tpu_torch.parallel import mesh as pm
from kube_batch_tpu_torch.parallel import shard_solve
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

GiB = float(2**30)
TOPK = 8


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """The JAX package's compile caches cleared before and after the module
    (``test_torch_sim_parity``'s docstring has why), and one torch thread
    for the module: the suite runs in several workers at once, and the
    shard loops' small ops gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()
    torch.set_num_threads(threads)


def _cluster():
    from kube_batch_tpu.api.pod import GROUP_NAME_ANNOTATION, Pod, PodGroup
    from kube_batch_tpu.api.types import PodPhase
    from kube_batch_tpu.testing.synthetic import synthetic_overcommit_cluster

    cache = synthetic_overcommit_cluster(n_running=400, n_pending=64, n_nodes=200,
                                         gang_size=4, seed=2)
    running = [k for k in sorted(cache.pods) if cache.pods[k].node_name]
    for i, key in enumerate(running):
        if i % 4 == 0:
            cache.update_pod(dataclasses.replace(cache.pods[key], deleting=True))
        elif i % 64 == 1:
            cache.delete_pod(cache.pods[key])
    for j in range(8):
        cache.add_pod_group(PodGroup(name=f"high{j}", namespace="bench", min_member=4,
                                     queue="q0", creation_index=10**6 + j))
        for k in range(4):
            cache.add_pod(Pod(name=f"high{j}-{k}", namespace="bench",
                              requests={"cpu": 2000.0, "memory": 2 * GiB},
                              annotations={GROUP_NAME_ANNOTATION: f"high{j}"},
                              phase=PodPhase.PENDING, priority=100,
                              creation_index=10**6 + 4 * j + k))
    return cache


@pytest.fixture(scope="module")
def session():
    """(JAX numpy snapshot, JAX AllocateConfig, {mode: JAX EvictConfig})."""
    from kube_batch_tpu.actions.allocate import build_session_snapshot, session_allocate_config
    from kube_batch_tpu.framework.conf import load_scheduler_conf
    from kube_batch_tpu.framework.session import close_session, open_session
    from kube_batch_tpu_torch.framework.conf import shipped_conf_path

    conf = load_scheduler_conf(shipped_conf_path())
    ssn = open_session(_cluster(), conf.tiers)
    ssn.action_names = list(conf.actions)
    try:
        snap, _meta = build_session_snapshot(ssn)
        config = session_allocate_config(ssn)
        evict = {m: JaxEvict(mode=m, weights=config.weights) for m in ("reclaim", "preempt")}
    finally:
        close_session(ssn)
    snap = jax.tree.map(np.asarray, snap)
    assert snap.task_req.shape[0] == 512 and snap.node_idle.shape[0] == 256
    return snap, config, evict


@pytest.fixture(scope="module")
def meshes():
    from kube_batch_tpu.parallel.mesh import make_mesh

    return {"1d": (make_mesh(), pm.make_mesh(["cpu"] * 8)),
            "2x4": (make_mesh(task_shards=2), pm.make_mesh(["cpu"] * 8, task_shards=2))}


def _np(res):
    return result_to_numpy(res) if isinstance(res[0], torch.Tensor) else jax.device_get(res)


def _assert_equal(got, want, skip=()):
    got, want = _np(got), _np(want)
    for name in want._fields:
        if name in skip:
            continue
        w, g = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


def _pend_rows(snap, bucket=128):
    rows = np.flatnonzero(np.asarray(snap.task_pending))
    assert 0 < rows.size <= bucket
    out = np.full(bucket, -1, np.int32)
    out[: rows.size] = rows.astype(np.int32)
    return out


@pytest.mark.parametrize("mesh_name", ["1d", "2x4"])
def test_full_solve_matches_jax_and_single(session, meshes, mesh_name):
    from kube_batch_tpu.parallel.mesh import sharded_allocate_solve as jax_sharded

    snap, config, _ = session
    jmesh, mesh = meshes[mesh_name]
    # without the gang gate pipelined placements commit, so the releasing
    # budget's winners (chose-idle off) reach the result
    config = config._replace(gang=False)
    want = jax_sharded(snap, config, jmesh)
    port = snapshot_from_numpy(snap, "cpu")
    cfg = config_from_fields(config)
    got = pm.sharded_allocate_solve(port, cfg, mesh)
    _assert_equal(got, want)
    _assert_equal(got, asg.allocate_solve(port, cfg))
    assert (want.assigned >= 0).any() and np.asarray(want.pipelined).any()
    # the oracle ("pjit": the single-device program over the gathered
    # snapshot) decides alike
    _assert_equal(pm.sharded_allocate_solve(port, cfg, mesh, impl="pjit"), want)


def test_full_solve_matches_jax_pallas_head(session, meshes):
    """JAX with the Pallas round head (interpret mode): its sharded solve
    does not trace with ``use_pallas`` (module docstring), so the reference
    is its single-device Pallas solve."""
    from kube_batch_tpu.ops.assignment import allocate_solve as jax_solve

    snap, config, _ = session
    want = jax_solve(snap, config._replace(use_pallas=True))
    got = pm.sharded_allocate_solve(snapshot_from_numpy(snap, "cpu"),
                                    config_from_fields(config), meshes["1d"][1])
    _assert_equal(got, want)


def test_compacted_solve_matches_jax_and_single(session, meshes):
    from kube_batch_tpu.parallel.mesh import sharded_allocate_topk_solve as jax_topk

    snap, config, _ = session
    jmesh, mesh = meshes["1d"]
    rows = _pend_rows(snap)
    config = config._replace(topk=TOPK)
    want = jax_topk(snap, rows, config, jmesh)
    port = snapshot_from_numpy(snap, "cpu")
    cfg = config_from_fields(config)
    got = pm.sharded_allocate_topk_solve(port, torch.from_numpy(rows), cfg, mesh)
    _assert_equal(got, want)
    _assert_equal(got, asg.allocate_topk_solve(port, torch.from_numpy(rows), cfg))
    with pytest.raises(ValueError, match="1-D"):
        pm.sharded_allocate_topk_solve(port, torch.from_numpy(rows), cfg, meshes["2x4"][1])


def _warm_plans(snap, W):
    """A cold plan (empty table, every live row re-ranked) and, for the
    second solve, a warm one: the same bucket, 8 changed nodes, 3 rows
    re-ranked."""
    from kube_batch_tpu.api.resident import warm_rerank_rungs

    rows = _pend_rows(snap)
    P = rows.size
    M = P
    I32_MIN = np.int32(-(2**31))
    table = (np.zeros((P, W), np.int32), np.full((P, W), I32_MIN, np.int32),
             np.full((P, W), -1, np.int32), np.ones(P, bool))
    cold = (np.full(M, -1, np.int32), np.full(64, -1, np.int32), rows.copy(),
            np.arange(P, dtype=np.int32))
    changed = np.full(64, -1, np.int32)
    changed[:8] = np.arange(8, dtype=np.int32) * 29
    # the cold plan's re-rank rung (P), so both solves share one program
    rr = warm_rerank_rungs(P)[-1]
    rerank_rows = np.full(rr, -1, np.int32)
    rerank_slots = np.full(rr, -1, np.int32)
    rerank_rows[:3] = rows[:3]
    rerank_slots[:3] = np.arange(3, dtype=np.int32)
    warm = (np.arange(M, dtype=np.int32), changed, rerank_rows, rerank_slots)
    return rows, table, cold, warm


def test_warm_solve_matches_jax_and_single(session, meshes):
    """A cold build then a warm merge over moved node ledgers: results, the
    refreshed tables and the erosion flags all equal."""
    from kube_batch_tpu.parallel.mesh import sharded_warm_allocate_solve as jax_warm

    snap, config, _ = session
    jmesh, mesh = meshes["1d"]
    W = TOPK + 16
    config = config._replace(topk=W)
    cfg = config_from_fields(config)
    rows, table, cold, warm = _warm_plans(snap, W)
    k_min = 4
    # the second snapshot: the changed nodes' idle moved
    idle2 = np.asarray(snap.node_idle).copy()
    idle2[warm[1][:8]] *= 0.5
    snap2 = snap._replace(node_idle=idle2)
    jt = table
    pt = tuple(torch.from_numpy(a) for a in table)
    st = pt
    for s, plan in ((snap, cold), (snap2, warm)):
        want, jt, jer = jax_warm(s, rows, jt, plan, config, k_min, jmesh)
        port = snapshot_from_numpy(s, "cpu")
        tplan = tuple(torch.from_numpy(a) for a in plan)
        got, pt, per = pm.sharded_warm_allocate_solve(port, torch.from_numpy(rows), pt,
                                                      tplan, cfg, k_min, mesh)
        one, st, ser = asg.warm_allocate_solve(port, torch.from_numpy(rows), st, tplan,
                                               cfg, k_min)
        _assert_equal(got, want)
        _assert_equal(got, one)
        for g, w, o in zip(pt, jt, st):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), o.numpy())
        np.testing.assert_array_equal(per.numpy(), np.asarray(jer))


@pytest.mark.parametrize("mode", ["reclaim", "preempt"])
def test_evict_solve_matches_jax_and_single(session, meshes, mode):
    from kube_batch_tpu.parallel.mesh import sharded_evict_solve as jax_evict

    snap, _config, evict = session
    jmesh, mesh = meshes["1d"]
    want = jax_evict(snap, evict[mode], jmesh)
    port = snapshot_from_numpy(snap, "cpu")
    cfg = EvictConfig(**evict[mode]._asdict())
    got, rounds = pm.sharded_evict_solve(port, cfg, mesh)
    one, one_rounds = evict_solve(port, cfg)
    _assert_equal(got, want)
    _assert_equal(got, one)
    assert rounds == one_rounds
    assert (np.asarray(want.claim_node) >= 0).any()


def test_evict_solve_2x4_matches_single(session, meshes):
    """The eviction bids on the task-sharded grid, reclaim with the idle
    gate (its per-shard any-fit sum and the task-block gathers)."""
    snap, _config, evict = session
    port = snapshot_from_numpy(snap, "cpu")
    cfg = EvictConfig(**evict["reclaim"]._asdict())._replace(idle_gate=True)
    got, _ = pm.sharded_evict_solve(port, cfg, meshes["2x4"][1])
    _assert_equal(got, evict_solve(port, cfg)[0])


def test_histograms_match_jax_and_single(session, meshes):
    from kube_batch_tpu.parallel.mesh import (
        sharded_failure_histogram as jax_hist,
        sharded_failure_histogram_bucket as jax_hist_bucket,
    )

    snap, _config, _ = session
    jmesh, mesh = meshes["1d"]
    port = snapshot_from_numpy(snap, "cpu")
    rows = _pend_rows(snap)
    want = np.asarray(jax_hist(snap, jmesh))
    got = pm.sharded_failure_histogram(port, mesh).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, asg.failure_histogram_solve(port).numpy())
    np.testing.assert_array_equal(
        pm.sharded_failure_histogram(port, meshes["2x4"][1]).numpy(), want)
    want_b = np.asarray(jax_hist_bucket(snap, rows, jmesh))
    got_b = pm.sharded_failure_histogram_bucket(port, torch.from_numpy(rows), mesh).numpy()
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(
        got_b, asg.failure_histogram_bucket_solve(port, torch.from_numpy(rows)).numpy())


def test_probe_matches_jax_and_single(session, meshes):
    from kube_batch_tpu.parallel.mesh import sharded_probe_solve as jax_probe
    from kube_batch_tpu_torch.ops.probe import probe_batch_from_numpy, probe_solve
    from test_torch_probe import probe_batch

    snap, config, _ = session
    jmesh, mesh = meshes["1d"]
    batch, rows = probe_batch(snap, seed=3)
    # gang 0 asks more cpu than any node has idle (16 000 of 32 000): the
    # eviction probe claims nodes from queue q0's running pods, whose gangs
    # the gang gate would protect
    batch.req[0, :, 0] = np.where(batch.valid[0], 24000.0, 0.0)
    jev = JaxEvict(mode="preempt", victim_gang=False)
    want = jax.device_get(jax_probe(snap, batch, rows, jmesh, config, jev, True))
    port = snapshot_from_numpy(snap, "cpu")
    pb = probe_batch_from_numpy(batch, "cpu")
    cfg, ev = config_from_fields(config), EvictConfig(mode="preempt", victim_gang=False)
    got = pm.sharded_probe_solve(port, pb, torch.from_numpy(rows), mesh, cfg, ev, True)
    one = probe_solve(port, pb, torch.from_numpy(rows), cfg, ev, True)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(getattr(got, name).numpy(), w, err_msg=name)
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(one, name).numpy(), err_msg=name)
    assert np.asarray(want.feasible).any()
    assert np.asarray(want.victims).any()


def test_gate_matches_jax_and_single(meshes):
    from kube_batch_tpu.parallel.mesh import dispatch_enqueue_gate as jax_gate
    from kube_batch_tpu_torch.ops.admission import enqueue_gate

    rng = np.random.default_rng(11)
    minr = rng.uniform(0, 4, (64, 3)).astype(np.float32)
    cand = rng.random(64) < 0.6
    idle0 = np.asarray([40.0, 30.0, 20.0], np.float32)
    quanta = np.full(3, 1e-3, np.float32)
    want = np.asarray(jax.device_get(jax_gate(minr, cand, idle0, quanta, n_nodes_padded=512)))
    args = [torch.from_numpy(a) for a in (minr, cand, idle0, quanta)]
    got = pm.dispatch_enqueue_gate(*args, n_nodes_padded=512, mesh=meshes["1d"][1]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, enqueue_gate(*args).numpy())
    assert 0 < got.sum() < cand.sum()


def test_homogeneous_nodes_ties_cross_shards(meshes):
    """Identical nodes: every pending row's score ties across all eight
    shards, so the tie hash at each shard's global origin decides, and a
    wrong origin would flip picks on shards after the first."""
    from kube_batch_tpu.parallel.mesh import sharded_allocate_solve as jax_sharded
    from kube_batch_tpu.testing.synthetic import synthetic_device_snapshot

    snap, _meta = synthetic_device_snapshot(n_tasks=500, n_nodes=256, gang_size=4,
                                            n_queues=3, seed=5)
    snap = jax.tree.map(np.asarray, snap)
    jmesh, mesh = meshes["1d"]
    config = JaxConfig()
    want = jax_sharded(snap, config, jmesh)
    got = pm.sharded_allocate_solve(snapshot_from_numpy(snap, "cpu"),
                                    config_from_fields(config), mesh)
    _assert_equal(got, want)
    picked = np.asarray(want.assigned)
    assert (picked >= 128).any() and ((picked >= 0) & (picked < 32)).any()


def test_combine_best_ties_cross_shards():
    """(value, hash) ties between shards: the lowest global index wins, as
    ``argmax`` over the concatenated node axis picks the first; the extra
    rides the winning shard."""
    mesh = pm.make_mesh(["cpu"] * 4)
    acct = shard_solve.Collectives(mesh, "test")
    T, n_loc = 6, 3
    rng = np.random.default_rng(0)
    val = rng.choice([-3.0e38, 0.0, 1.5, 2.5], (T, 4 * n_loc)).astype(np.float32)
    hsh = rng.choice([7, 9], (T, 4 * n_loc)).astype(np.int32)
    val[0] = 2.5           # row 0: every cell ties on (value, hash)
    hsh[0] = 9
    payload = {}
    for j in range(4):
        blk = torch.from_numpy(val[:, j * n_loc:(j + 1) * n_loc])
        tie = torch.from_numpy(hsh[:, j * n_loc:(j + 1) * n_loc])
        lval, lkey, lidx, _pick = shard_solve._local_best(blk, tie, j * n_loc)
        payload[(0, j)] = (lval, lkey, lidx, torch.full((T,), j, dtype=torch.int32))
    vmax, best, extra = shard_solve._combine_best(acct, payload, torch.device("cpu"))
    key = np.where(val >= val.max(axis=1, keepdims=True), hsh, -1)
    want = key.argmax(axis=1)
    np.testing.assert_array_equal(best.numpy(), want)
    np.testing.assert_array_equal(vmax.numpy(), val.max(axis=1))
    np.testing.assert_array_equal(extra.numpy(), want // n_loc)
    assert best[0] == 0


@pytest.mark.parametrize("mesh_name,topk", [("1d", False), ("2x4", False), ("1d", True)])
def test_collective_bytes_match_jax(session, meshes, mesh_name, topk):
    """``collective_stats`` equals the JAX package's at the same mesh and
    buckets, and what a solve moved equals it: per round (each round's
    sites) and per solve; the compacted program's per-round bytes are 0."""
    from kube_batch_tpu.analysis.jaxpr_audit import abstract_snapshot
    from kube_batch_tpu.parallel.mesh import collective_stats as jax_stats

    snap, config, _ = session
    jmesh, mesh = meshes[mesh_name]
    T, R = snap.task_req.shape
    N, W, K = snap.node_idle.shape[0], snap.node_label_bits.shape[1], snap.task_aff_mask.shape[0]
    pend = 128 if topk else None
    cfg = config._replace(topk=TOPK if topk else 0)
    want = jax_stats(jmesh, cfg, abstract_snapshot(T=T, N=N, R=R, W=W, K=K), pend_bucket=pend)
    port = snapshot_from_numpy(snap, "cpu")
    got = pm.collective_stats(mesh, config_from_fields(cfg), port, pend_bucket=pend)
    assert got == want
    if topk:
        assert got["per_round_bytes"] == 0
        pm.sharded_allocate_topk_solve(port, torch.from_numpy(_pend_rows(snap)),
                                       config_from_fields(cfg), mesh)
        moved = shard_solve.last_collectives["topk"].summary()
        assert moved["per_round_bytes_total"] == 0
    else:
        pm.sharded_allocate_solve(port, config_from_fields(cfg), mesh)
        moved = shard_solve.last_collectives["allocate"].summary()
        assert moved["rounds"] > 1
        assert moved["per_round_bytes_total"] == moved["rounds"] * want["per_round_bytes"]
    assert moved["per_solve_bytes"] == want["per_solve_bytes"]


def test_default_mesh_and_should_shard(monkeypatch):
    """No mesh on the CPU or with one card; the gate follows
    SHARD_MIN_NODES and KB_SHARD; a CUDA mesh without a card raises."""
    assert pm.default_mesh("cpu") is None
    mesh = pm.make_mesh(["cpu"] * 8)
    assert pm.should_shard(256, mesh) and not pm.should_shard(128, mesh)
    assert not pm.should_shard(512, None)
    monkeypatch.setenv("KB_SHARD", "0")
    assert not pm.should_shard(512, mesh)
    assert mesh == pm.make_mesh(["cpu"] * 8) and hash(mesh) == hash(pm.make_mesh(["cpu"] * 8))
    assert mesh.shape == {"nodes": 8}
    assert pm.make_mesh(["cpu"] * 8, task_shards=2).shape == {"tasks": 2, "nodes": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pm.make_mesh(["cuda:0"] * 4)
        with pytest.raises(RuntimeError):
            pm.make_mesh()


def test_placement_copies_never_alias(session):
    """Each position's node tensors are its own, and no placed tensor is a
    view of the source snapshot's."""
    snap, _config, _ = session
    port = snapshot_from_numpy(snap, "cpu")
    ss = pm.place_snapshot(port, pm.make_mesh(["cpu"] * 4))
    ptrs = [s.node_idle.data_ptr() for s in ss.shards]
    assert len(set(ptrs)) == 4
    assert ss.shards[0].task_req.data_ptr() != port.task_req.data_ptr()
    g = ss.gathered()
    for f in pm.NODE_FIELDS:
        assert torch.equal(getattr(g, f), getattr(port, f)), f


def test_jax_side_shards_at_this_size(session):
    """The JAX package's own default takes its sharded path at these
    buckets on the tests' 8-device mesh (the comparison is like for like)."""
    from kube_batch_tpu.parallel.mesh import should_shard

    assert should_shard(session[0].node_idle.shape[0])
