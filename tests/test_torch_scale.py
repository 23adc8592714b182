"""Decisions at the headline scale against the JAX package, on the CPU
(``slow``: each case solves 50 000 pods × 5 000 nodes on both packages,
tens of seconds and several GiB apiece).

- The full allocate solve of ``synthetic_device_snapshot(50_000, 5_000,
  gang_size=4, n_queues=3, seed=0)`` at the default ``AllocateConfig``.
- The dispatch of the same snapshot with 5 000 rows left pending, which
  both packages send down the compacted program (bucket 8 192, K 32).
- Reclaim's and preempt's ``evict_solve`` on the session snapshot of
  ``synthetic_overcommit_cluster(40_000, 20_000, 5_000, seed=0)``.

Every result field must be equal, bit for bit.  f32 segment sums run in
each package's own order; a flip here is a fault (ROADMAP Queue 3), never
a tolerance.  The JAX side runs single-device (``KB_SHARD=0``): the port
has no sharded solve.
"""

from __future__ import annotations

import numpy as np
import pytest
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

pytestmark = pytest.mark.slow

N_TASKS, N_NODES, GANG, N_QUEUES = 50_000, 5_000, 4, 3
PENDING_LEFT = 5_000


def _assert_equal(got, want, skip=()):
    for name in want._fields:
        if name in skip:
            continue
        w = np.asarray(getattr(want, name))
        g = np.asarray(getattr(got, name))
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def headline():
    from kube_batch_tpu.testing.synthetic import synthetic_device_snapshot

    snap, meta = synthetic_device_snapshot(n_tasks=N_TASKS, n_nodes=N_NODES,
                                           gang_size=GANG, n_queues=N_QUEUES, seed=0)
    return snap, meta


def test_full_solve_at_50k_matches_jax(headline):
    import jax

    from kube_batch_tpu.ops.assignment import AllocateConfig as JaxConfig
    from kube_batch_tpu.ops.assignment import allocate_solve as jax_solve
    from kube_batch_tpu_torch.api.convert import (
        config_from_fields,
        result_to_numpy,
        snapshot_from_numpy,
    )
    from kube_batch_tpu_torch.ops.assignment import allocate_solve

    snap, _meta = headline
    config = JaxConfig()
    want = jax.device_get(jax_solve(snap, config))
    got = result_to_numpy(allocate_solve(snapshot_from_numpy(snap, "cpu"),
                                         config_from_fields(config)))
    _assert_equal(got, want)
    assert int((want.assigned >= 0).sum()) == N_TASKS


def test_compacted_dispatch_at_50k_matches_jax(headline, monkeypatch):
    import jax

    from kube_batch_tpu.actions.allocate import dispatch_allocate_solve as jax_dispatch
    from kube_batch_tpu.ops.assignment import AllocateConfig as JaxConfig
    from kube_batch_tpu_torch.actions.allocate import dispatch_allocate_solve
    from kube_batch_tpu_torch.api.convert import (
        config_from_fields,
        result_to_numpy,
        snapshot_from_numpy,
    )

    monkeypatch.setenv("KB_SHARD", "0")
    monkeypatch.delenv("KB_TOPK", raising=False)
    snap, _meta = headline
    pending = np.asarray(snap.task_pending).copy()
    pending[np.flatnonzero(pending)[PENDING_LEFT:]] = False
    snap = snap._replace(task_pending=pending)
    config = JaxConfig()
    want, want_mode, want_info, _g = jax_dispatch(snap, config)
    want = jax.device_get(want)
    got, mode, info, _g = dispatch_allocate_solve(snapshot_from_numpy(snap, "cpu"),
                                                  config_from_fields(config))
    assert (mode, info) == (want_mode, want_info)
    assert info is not None, "the dispatch did not take the compacted program"
    _assert_equal(result_to_numpy(got), want)
    assert int((want.assigned >= 0).sum()) > 0


@pytest.fixture(scope="module")
def overcommit():
    from kube_batch_tpu import actions as _actions  # noqa: F401 — registers
    from kube_batch_tpu import plugins as _plugins  # noqa: F401 — registers
    from kube_batch_tpu.framework.conf import load_scheduler_conf
    from kube_batch_tpu.framework.session import close_session, open_session
    from kube_batch_tpu.testing.synthetic import synthetic_overcommit_cluster

    cache = synthetic_overcommit_cluster(n_running=40_000, n_pending=20_000,
                                         n_nodes=N_NODES, seed=0)
    ssn = open_session(cache, load_scheduler_conf(None).tiers)
    try:
        snap, _meta = cache.columns.device_snapshot(ssn)
    finally:
        close_session(ssn)
        cache.stop()
    return snap


@pytest.mark.parametrize("mode", ["reclaim", "preempt"])
def test_evict_solve_at_50k_matches_jax(overcommit, mode):
    from kube_batch_tpu.ops.eviction import EvictConfig as JaxEvictConfig
    from kube_batch_tpu.ops.eviction import evict_solve as jax_evict_solve
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
    from kube_batch_tpu_torch.ops.eviction import EvictConfig, evict_solve

    want = jax_evict_solve(overcommit, JaxEvictConfig(mode=mode))
    got, rounds = evict_solve(snapshot_from_numpy(overcommit, "cpu"), EvictConfig(mode=mode))
    for field in ("claim_node", "evicted", "victim_claimant"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert 1 <= rounds <= EvictConfig().rounds
    if mode == "reclaim":
        assert int(got.evicted.sum()) > 0
