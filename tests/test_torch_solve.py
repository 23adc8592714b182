"""The port's allocate solve against the JAX package's, end to end on the
same snapshots: the full solve (JAX with the Pallas round head off and on,
in interpret mode), the compacted top-K solve including the
forced-exhaustion fixture, the dispatch's plan, and the bind list.
Every AllocateResult field is compared exactly — int and bool fields bit
for bit, the f32 ledgers and ``deserved`` for equality."""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu import actions as _actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _plugins  # noqa: F401 — registers
from kube_batch_tpu.actions.allocate import (
    build_session_snapshot,
    session_allocate_config,
)
from kube_batch_tpu.actions.allocate import dispatch_allocate_solve as jax_dispatch
from kube_batch_tpu.actions.allocate import plan_topk_bucket as jax_plan
from kube_batch_tpu.framework.conf import load_scheduler_conf
from kube_batch_tpu.framework.session import close_session, open_session
from kube_batch_tpu.ops.assignment import allocate_solve as jax_allocate_solve
from kube_batch_tpu.ops.assignment import (
    allocate_topk_solve as jax_allocate_topk_solve,
)
from kube_batch_tpu.testing.synthetic import (
    synthetic_cluster,
    synthetic_device_snapshot,
    synthetic_overcommit_cluster,
)
from kube_batch_tpu_torch.actions.allocate import (
    dispatch_allocate_solve,
    plan_topk_bucket,
    result_binds,
)
from kube_batch_tpu_torch.api.convert import (
    config_from_fields,
    result_to_numpy,
    snapshot_from_numpy,
)
from kube_batch_tpu_torch.api.snapshot import SnapshotMeta
from kube_batch_tpu_torch.ops.assignment import (
    allocate_solve,
    allocate_topk_solve,
)
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


def _session_snapshot(cache):
    conf = load_scheduler_conf(None)
    ssn = open_session(cache, conf.tiers)
    try:
        snap, meta = build_session_snapshot(ssn)
        config = session_allocate_config(ssn)
    finally:
        close_session(ssn)
    return snap, meta, config


@functools.lru_cache(maxsize=None)
def _fixture(name):
    """(JAX numpy snapshot, meta, JAX AllocateConfig) per named fixture."""
    from kube_batch_tpu.ops.assignment import AllocateConfig

    if name.startswith("synthetic"):
        frac = 0.3 if name.endswith("gpu") else 0.0
        snap, meta = synthetic_device_snapshot(
            n_tasks=480, n_nodes=60, gang_size=4, n_queues=3,
            gpu_task_frac=frac, seed=1)
        return snap, meta, AllocateConfig()
    if name == "session":
        # the tests/test_topk.py recipe: gangs of 2 over 2 queues
        return _session_snapshot(synthetic_cluster(
            n_tasks=300, n_nodes=70, gang_size=2, n_queues=2, seed=3))
    if name == "exhaustion":
        return _session_snapshot(synthetic_cluster(
            n_tasks=240, n_nodes=8, gang_size=2, n_queues=2, seed=3))
    if name.startswith("overcommit"):
        # queue q0's running gangs fill every node; a quarter of them are
        # being deleted (Releasing capacity) and a quarter are gone (Idle
        # capacity), so q1's pending gangs allocate and pipeline
        cache = synthetic_overcommit_cluster(
            n_running=200, n_pending=160, n_nodes=25, gang_size=4, seed=0)
        running = [k for k in sorted(cache.pods) if cache.pods[k].node_name]
        for i, key in enumerate(running):
            if i % 4 == 0:
                cache.update_pod(dataclasses.replace(cache.pods[key],
                                                     deleting=True))
            elif i % 4 == 1:
                cache.delete_pod(cache.pods[key])
        snap, meta, config = _session_snapshot(cache)
        if name.endswith("nogang"):
            # without the gang gate, pipelined placements commit
            config = config._replace(gang=False)
        return snap, meta, config
    raise KeyError(name)


def _port_meta(meta) -> SnapshotMeta:
    return SnapshotMeta(
        spec=None, task_keys=list(meta.task_keys),
        node_names=list(meta.node_names), job_uids=list(meta.job_uids),
        queue_names=list(meta.queue_names), label_pair_bit={}, taint_bit={},
        n_tasks=meta.n_tasks, n_nodes=meta.n_nodes, n_jobs=meta.n_jobs,
        n_queues=meta.n_queues)


def _assert_results_equal(got, want, skip_topk=False):
    for name in want._fields:
        if skip_topk and name.startswith("topk_"):
            continue
        w = np.asarray(getattr(want, name))
        g = np.asarray(getattr(got, name))
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


def _pend_rows(snap, bucket):
    rows = np.flatnonzero(np.asarray(snap.task_pending))
    assert 0 < rows.size <= bucket
    out = np.full(bucket, -1, np.int32)
    out[: rows.size] = rows.astype(np.int32)
    return out


FULL_FIXTURES = ["synthetic", "synthetic-gpu", "session", "overcommit",
                 "overcommit-nogang"]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", FULL_FIXTURES)
def test_allocate_solve_matches_jax(name, use_pallas):
    snap, _meta, config = _fixture(name)
    config = config._replace(use_pallas=use_pallas)
    want = jax.device_get(jax_allocate_solve(snap, config))
    got = result_to_numpy(allocate_solve(snapshot_from_numpy(snap, "cpu"),
                                         config_from_fields(config)))
    _assert_results_equal(got, want)
    assert (want.assigned >= 0).any()


def test_overcommit_fixture_pipelines_onto_releasing():
    """The fixture really exercises the releasing budget: the gang-free
    config pipelines tasks and the port agrees on which."""
    snap, _meta, config = _fixture("overcommit-nogang")
    assert np.asarray(snap.node_releasing).any()
    got = allocate_solve(snapshot_from_numpy(snap, "cpu"),
                         config_from_fields(config))
    assert got.pipelined.any() and (got.assigned >= 0).sum() > got.pipelined.sum()


def test_forced_exhaustion_topk_matches_jax():
    """240 pending tasks bidding for 8 nodes with K=2: candidate lists run
    out mid-solve and the full head re-enters.  The port equals JAX on
    every field, counters included, and equals its own full solve.  (The
    JAX package's K2 needs at least one 64-node block, so its reference
    here is the XLA build; the Pallas build is compared below.)"""
    snap, _meta, config = _fixture("exhaustion")
    rows = _pend_rows(snap, 256)
    config = config._replace(topk=2)
    want = jax.device_get(jax_allocate_topk_solve(snap, rows, config))
    port_snap = snapshot_from_numpy(snap, "cpu")
    got = result_to_numpy(allocate_topk_solve(
        port_snap, torch.from_numpy(rows), config_from_fields(config)))
    _assert_results_equal(got, want)
    assert int(got.topk_exhausted) > 0 and int(got.topk_reentries) > 0
    full = result_to_numpy(allocate_solve(port_snap, config_from_fields(config)))
    _assert_results_equal(got, full, skip_topk=True)


@pytest.mark.parametrize("k,use_pallas", [(3, False), (3, True), (8, True)])
def test_topk_solve_matches_jax(k, use_pallas):
    snap, _meta, config = _fixture("session")
    rows = _pend_rows(snap, 512)
    config = config._replace(topk=k, use_pallas=use_pallas)
    want = jax.device_get(jax_allocate_topk_solve(snap, rows, config))
    got = result_to_numpy(allocate_topk_solve(
        snapshot_from_numpy(snap, "cpu"), torch.from_numpy(rows),
        config_from_fields(config)))
    _assert_results_equal(got, want)


def _mostly_bound_snapshot():
    """A 1024-row task bucket with 150 rows still pending: the dispatch's
    compaction bucket (256) holds them, so the compacted solve runs."""
    snap, meta = synthetic_device_snapshot(
        n_tasks=1000, n_nodes=60, gang_size=2, n_queues=2, seed=4)
    pending = np.asarray(snap.task_pending).copy()
    pending[150:] = False
    return snap._replace(task_pending=pending), meta


@pytest.mark.parametrize("case", ["compacted", "full"])
def test_dispatch_matches_jax(case, monkeypatch):
    from kube_batch_tpu.ops.assignment import AllocateConfig

    monkeypatch.delenv("KB_TOPK", raising=False)
    if case == "compacted":
        snap, meta = _mostly_bound_snapshot()
    else:
        snap, meta, _ = _fixture("synthetic")
    config = AllocateConfig()
    want, want_mode, want_info, _g = jax_dispatch(snap, config)
    want = jax.device_get(want)
    port_snap = snapshot_from_numpy(snap, "cpu")
    got, mode, info, _g = dispatch_allocate_solve(port_snap,
                                                  config_from_fields(config))
    assert (mode, info) == (want_mode, want_info)
    assert (info is None) == (case == "full")
    _assert_results_equal(result_to_numpy(got), want)
    # the bind list: the committed, non-pipelined placements
    binds = result_binds(got, _port_meta(meta))
    rows = np.flatnonzero((want.assigned[: meta.n_tasks] >= 0)
                          & ~want.pipelined[: meta.n_tasks])
    assert binds == [(meta.task_keys[t], meta.node_names[want.assigned[t]])
                     for t in rows]
    assert len(binds) > 0


def test_result_binds_skip_pipelined_rows():
    snap, meta, config = _fixture("overcommit-nogang")
    res = allocate_solve(snapshot_from_numpy(snap, "cpu"),
                         config_from_fields(config))
    binds = result_binds(res, _port_meta(meta))
    placed = int((res.assigned[: meta.n_tasks] >= 0).sum())
    n_pipe = int(res.pipelined[: meta.n_tasks].sum())
    assert n_pipe > 0 and len(binds) == placed - n_pipe
    assert len({t for t, _ in binds}) == len(binds)


@pytest.mark.parametrize("k", [0, 32, 64, 2])
@pytest.mark.parametrize("name", ["mostly-bound", "synthetic", "exhaustion"])
def test_plan_topk_bucket_matches_jax(name, k):
    if name == "mostly-bound":
        snap, _meta = _mostly_bound_snapshot()
    else:
        snap = _fixture(name)[0]
    want_rows, want_k = jax_plan(snap, None, k)
    rows, got_k = plan_topk_bucket(snapshot_from_numpy(snap, "cpu"), k)
    assert got_k == want_k
    if want_rows is None:
        assert rows is None
    else:
        assert rows.dtype == want_rows.dtype
        np.testing.assert_array_equal(rows, want_rows)
