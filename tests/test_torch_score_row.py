"""The custom score-row seam (``ScoreWeights.extra_rows``,
``Session.add_score_row``), the port against the JAX package.

Each row is written twice, once in ``jax.numpy`` and once in ``torch``,
operation for operation.  The score plane with the rows equals the JAX
package's (f32, every element); the full solve (K1's path) and the
compacted solve (K2's path) with the rows equal the JAX package's on the
``tests/test_torch_solve.py`` fixtures, every result field; a row that
emits −0.0 keys like +0.0 through both kernels' plain versions; a row
registered on a session steers a real allocate in both packages alike;
and a custom row defers the warm carry to the cold build and the
columnar host placement to the object scan, on both ``KB_WARM`` legs, as
the JAX package does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
from kube_batch_tpu.framework.conf import load_scheduler_conf as jax_load_conf
from kube_batch_tpu.framework.interface import get_action as jax_get_action
from kube_batch_tpu.framework.session import close_session as jax_close
from kube_batch_tpu.framework.session import open_session as jax_open
from kube_batch_tpu.ops import scoring as jscore
from kube_batch_tpu.ops.assignment import allocate_solve as jax_allocate_solve
from kube_batch_tpu.ops.assignment import allocate_topk_solve as jax_allocate_topk_solve
from kube_batch_tpu.testing import synthetic as jax_synth
from kube_batch_tpu_torch.actions.allocate import AllocateAction
from kube_batch_tpu_torch.api.convert import config_from_fields, result_to_numpy, snapshot_from_numpy
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.conf import load_scheduler_conf
from kube_batch_tpu_torch.framework.interface import get_action
from kube_batch_tpu_torch.framework.session import close_session, open_session
from kube_batch_tpu_torch.ops import scoring
from kube_batch_tpu_torch.ops.assignment import allocate_solve, allocate_topk_solve
from kube_batch_tpu_torch.ops.kernels import (
    NEG,
    f32_sort_key,
    masked_best_node_raw,
    masked_topk_blocks,
)
from kube_batch_tpu_torch.testing import synthetic as port_synth
from test_torch_cycle import observed
from test_torch_ops import _jnp, _rich_snapshot
from test_torch_solve import FULL_FIXTURES, _assert_results_equal, _fixture, _pend_rows
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


# --------------------------------------------------------------------------
# the rows, once per package (module level: the JAX row set keys its jit)
# --------------------------------------------------------------------------


def prefer_last_jnp(snap):
    """The JAX package's test row: strongly prefer the highest live node."""
    N = snap.node_alloc.shape[0]
    col = jnp.where(snap.node_valid, jnp.arange(N, dtype=jnp.float32), 0.0)
    return jnp.broadcast_to(col[None, :], (snap.task_req.shape[0], N)) * 100.0


def prefer_last_torch(snap):
    N = snap.node_alloc.shape[0]
    col = torch.where(snap.node_valid, torch.arange(N, dtype=torch.float32,
                                                    device=snap.node_alloc.device), 0.0)
    return col[None, :].expand(snap.task_req.shape[0], N) * 100.0


def memory_fit_jnp(snap):
    """A data-dependent row: the node's memory headroom after the task, in
    GiB, per core the task asks for (subtractions and divisions only, so
    no compiler may fuse or reassociate them)."""
    head = (snap.node_alloc[None, :, 1] - snap.node_used[None, :, 1]
            - snap.task_req[:, 1, None]) / jnp.float32(2.0 ** 30)
    return head / jnp.maximum(snap.task_req[:, 0, None], jnp.float32(1.0))


def memory_fit_torch(snap):
    head = (snap.node_alloc[None, :, 1] - snap.node_used[None, :, 1]
            - snap.task_req[:, 1, None]) / (2.0 ** 30)
    return head / torch.clamp(snap.task_req[:, 0, None], min=1.0)


def negative_zero_jnp(snap):
    """−0.0 everywhere."""
    return jnp.full((snap.task_req.shape[0], snap.node_alloc.shape[0]), -0.0, jnp.float32)


def negative_zero_torch(snap):
    return torch.full((snap.task_req.shape[0], snap.node_alloc.shape[0]), -0.0,
                      dtype=torch.float32, device=snap.node_alloc.device)


ROWS = {
    "prefer_last": ((("prefer-last", prefer_last_jnp, 1.0),),
                    (("prefer-last", prefer_last_torch, 1.0),)),
    "memory_fit": ((("memory-fit", memory_fit_jnp, 0.5),),
                   (("memory-fit", memory_fit_torch, 0.5),)),
    "two_rows": ((("memory-fit", memory_fit_jnp, 2.0), ("neg-zero", negative_zero_jnp, 1.0)),
                 (("memory-fit", memory_fit_torch, 2.0), ("neg-zero", negative_zero_torch, 1.0))),
}


def configs(config, rows: str):
    """(JAX config, port config) of ``config`` with ``rows`` as extra rows."""
    jrows, prows = ROWS[rows]
    jconfig = config._replace(weights=config.weights._replace(extra_rows=jrows))
    pconfig = config_from_fields(config)
    return jconfig, pconfig._replace(weights=pconfig.weights._replace(extra_rows=prows))


# --------------------------------------------------------------------------
# the score plane
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("seed", [0, 1])
def test_score_matrix_with_rows_matches_jax(rows, seed):
    snap = _rich_snapshot(seed)
    jrows, prows = ROWS[rows]
    jweights = jscore.ScoreWeights(binpack=0.5, extra_rows=jrows)
    # the JAX function op by op: XLA's fusion of the whole plane moves the
    # last bit of some built-in entries once a data-dependent row joins it
    # (ROADMAP.md Queue 3), while each op alone is the IEEE operation
    with jax.disable_jit():
        want = np.asarray(jscore.score_matrix(_jnp(snap), jweights))
    got = scoring.score_matrix(snapshot_from_numpy(snap, "cpu"),
                               scoring.ScoreWeights(binpack=0.5, extra_rows=prows)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)

    # the zero weight drops a row, as in the JAX package
    zero = tuple((n, f, 0.0) for n, f, _w in prows)
    assert torch.equal(
        scoring.score_matrix(snapshot_from_numpy(snap, "cpu"),
                             scoring.ScoreWeights(binpack=0.5, extra_rows=zero)),
        scoring.score_matrix(snapshot_from_numpy(snap, "cpu"),
                             scoring.ScoreWeights(binpack=0.5)))


# --------------------------------------------------------------------------
# the full (K1) and compacted (K2) solves
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rows", ["prefer_last", "two_rows"])
@pytest.mark.parametrize("name", FULL_FIXTURES)
def test_full_solve_with_rows_matches_jax(name, rows):
    snap, _meta, config = _fixture(name)
    jconfig, pconfig = configs(config, rows)
    want = jax.device_get(jax_allocate_solve(snap, jconfig))
    got = result_to_numpy(allocate_solve(snapshot_from_numpy(snap, "cpu"), pconfig))
    _assert_results_equal(got, want)
    assert (want.assigned >= 0).any()


@pytest.mark.parametrize("k,use_pallas", [(3, False), (8, True)])
@pytest.mark.parametrize("rows", ["prefer_last", "memory_fit"])
def test_topk_solve_with_rows_matches_jax(rows, k, use_pallas):
    snap, _meta, config = _fixture("session")
    pend = _pend_rows(snap, 512)
    jconfig, pconfig = configs(config._replace(topk=k, use_pallas=use_pallas), rows)
    want = jax.device_get(jax_allocate_topk_solve(snap, pend, jconfig))
    port_snap = snapshot_from_numpy(snap, "cpu")
    got = result_to_numpy(allocate_topk_solve(port_snap, torch.from_numpy(pend), pconfig))
    _assert_results_equal(got, want)
    # and the compacted solve equals the full one, the row included
    full = result_to_numpy(allocate_solve(port_snap, pconfig))
    _assert_results_equal(got, full, skip_topk=True)


def test_prefer_last_row_steers_the_solve():
    """The JAX package's ``test_custom_row_changes_placement``, on the
    port: the row outweighs the bounded built-ins."""
    snap, meta, config = _fixture("synthetic")
    _jconfig, pconfig = configs(config, "prefer_last")
    port_snap = snapshot_from_numpy(snap, "cpu")
    base = allocate_solve(port_snap, config_from_fields(config)).assigned.numpy()
    custom = allocate_solve(port_snap, pconfig).assigned.numpy()[: meta.n_tasks]
    base = base[: meta.n_tasks]
    last = meta.n_nodes - 1
    # the last node fills first, and placements shift to high indices
    assert (custom == last).sum() > (base == last).sum()
    assert custom[custom >= 0].mean() > base[base >= 0].mean()


def test_negative_zero_row_keys_like_positive_zero():
    """A row of −0.0 leaves the plane's bits as they were, and a plane
    holding −0.0 gives K1's and K2's plain versions the keys and picks of
    +0.0."""
    snap = snapshot_from_numpy(_rich_snapshot(0), "cpu")
    base = scoring.score_matrix(snap, scoring.ScoreWeights())
    with_row = scoring.score_matrix(snap, scoring.ScoreWeights(
        extra_rows=(("neg-zero", negative_zero_torch, 1.0),)))
    assert torch.equal(base.view(torch.int32), with_row.view(torch.int32))
    assert int(f32_sort_key(torch.tensor([-0.0]))[0]) == int(f32_sort_key(torch.tensor([0.0]))[0])
    T, N = base.shape
    pos = torch.zeros((T, N))
    neg = torch.full((T, N), -0.0)
    neg[:, ::3] = NEG
    pos[:, ::3] = NEG
    static_ok = torch.ones((T, N), dtype=torch.bool)
    pending = snap.task_pending
    rows = torch.arange(T, dtype=torch.int32)
    k1 = [masked_best_node_raw(s, static_ok, snap.task_req, snap.node_idle,
                               snap.node_releasing, pending, snap.quanta) for s in (pos, neg)]
    for a, b in zip(*k1):
        assert torch.equal(a, b)
    k2 = [masked_topk_blocks(s, snap.task_req, snap.node_idle, snap.node_releasing, rows,
                             snap.quanta) for s in (pos, neg)]
    for a, b in zip(*k2):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the session seam
# --------------------------------------------------------------------------


def test_session_level_registration_matches_jax():
    """``Session.add_score_row`` steers a real allocate
    (``tests/test_allocate_solve.py``'s registration test) in both
    packages alike."""
    jcache = jax_synth.synthetic_cluster(n_tasks=16, n_nodes=4, gang_size=1, n_queues=1)
    pcache = port_synth.synthetic_cluster(n_tasks=16, n_nodes=4, gang_size=1, n_queues=1)
    jssn = jax_open(jcache, jax_load_conf(None).tiers)
    jssn.add_score_row("prefer-last", prefer_last_jnp, weight=1.0)
    jax_get_action("allocate").execute(jssn)
    jax_close(jssn)
    jcache.flush_binds()
    pssn = open_session(pcache, load_scheduler_conf(None).tiers, "cpu")
    pssn.add_score_row("prefer-last", prefer_last_torch, weight=1.0)
    assert pssn.score_weights.extra_rows == (("prefer-last", prefer_last_torch, 1.0),)
    get_action("allocate").execute(pssn)
    close_session(pssn)
    assert set(pcache.binder.binds.values()) == {"n3"}
    assert pcache.binder.binds == jcache.binder.binds


def _compacting_pair():
    """A JAX and a port cache whose allocate compacts: the axes reserved
    to 1 024 task rows (a 256-row pending bucket) and 64 node rows."""
    caches = (jax_synth.synthetic_cluster(n_tasks=192, n_nodes=24, gang_size=4, n_queues=2,
                                          seed=5),
              port_synth.synthetic_cluster(n_tasks=192, n_nodes=24, gang_size=4, n_queues=2,
                                           seed=5))
    for cache in caches:
        cache.columns.reserve(n_tasks=1024, n_nodes=64, n_jobs=256)
    return caches


@pytest.mark.parametrize("warm", ["1", "0"])
@pytest.mark.parametrize("with_row", [True, False])
def test_custom_row_defers_the_warm_carry(monkeypatch, warm, with_row):
    monkeypatch.setenv("KB_WARM", warm)
    jcache, pcache = _compacting_pair()
    jssn = jax_open(jcache, jax_load_conf(None).tiers)
    pssn = open_session(pcache, load_scheduler_conf(None).tiers, "cpu")
    if with_row:
        jssn.add_score_row("memory-fit", memory_fit_jnp, 0.5)
        pssn.add_score_row("memory-fit", memory_fit_torch, 0.5)
    jaction, paction = jax_get_action("allocate"), get_action("allocate")
    jaction.execute(jssn)
    paction.execute(pssn)
    jax_close(jssn)
    close_session(pssn)
    jcache.flush_binds()
    # compacted on both, warm only without a row and with KB_WARM on
    assert paction.last_topk is not None and jaction.last_topk is not None
    assert (paction.last_warm is not None) == (warm == "1" and not with_row)
    assert (jaction.last_warm is not None) == (paction.last_warm is not None)
    want, got = observed(jcache), observed(pcache)
    assert got["binds"] == want["binds"] and got["tasks"] == want["tasks"]
    assert got["binds"]


def test_custom_row_defers_the_columnar_host_placement():
    """With a custom row the host placement of a ported task takes the
    object scan (which consults the session's scorers), not the columns'
    built-in scoring."""
    cache = port_synth.synthetic_cluster(n_tasks=32, n_nodes=8, gang_size=1, n_queues=1,
                                         host_ports_frac=0.5, seed=2)
    ssn = open_session(cache, load_scheduler_conf(None).tiers, "cpu")
    try:
        task = next(t for j in ssn.jobs.values() for t in j.tasks.values()
                    if t.pod.host_ports and t.status == TaskStatus.PENDING)
        action = AllocateAction()
        stmt = ssn.statement()
        assert action._host_place_columns(ssn, stmt, task) in (True, False)
        stmt.discard()
        ssn.add_score_row("prefer-last", prefer_last_torch, 1.0)
        stmt = ssn.statement()
        assert action._host_place_columns(ssn, stmt, task) is None
        stmt.discard()
    finally:
        close_session(ssn)
    assert cache.columns.check_consistency(cache) == []
