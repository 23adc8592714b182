"""Each op module of the port against its JAX counterpart on the same
numpy inputs.  Tolerance: none — masks, ranks, keys and tables are
bit-exact and f32 outputs equal.  Resource values are multiples of their
quanta (as every snapshot's are), so prefix sums are exact in any order;
``proportion_deserved`` also runs on arbitrary f32 inputs, where the
summation order of its [Q]-sized sums is part of what is compared."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.ops import fairness as jfair
from kube_batch_tpu.ops import feasibility as jfeas
from kube_batch_tpu.ops import ordering as jord
from kube_batch_tpu.ops import scoring as jscore
from kube_batch_tpu.ops.assignment import NEG
from kube_batch_tpu.ops.assignment import f32_sort_key as jax_sort_key
from kube_batch_tpu.ops.assignment import lex_topk as jax_lex_topk
from kube_batch_tpu.testing.synthetic import synthetic_device_snapshot
from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
from kube_batch_tpu_torch.ops import fairness, feasibility, ordering, scoring
from kube_batch_tpu_torch.ops.assignment import f32_sort_key, lex_topk
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


def _t(a):
    return torch.from_numpy(np.array(a))


def _jnp(snap):
    """The JAX snapshot as device arrays, so the reference runs through
    XLA (numpy inputs would route some ops through numpy)."""
    return type(snap)(*map(jnp.asarray, snap))


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _rich_snapshot(seed: int):
    """A synthetic snapshot with random selector/taint bits, unhealthy
    nodes, impossible selectors, affinity and preference rows (padding
    included), some zero allocatable and nonzero used ledgers."""
    rng = np.random.default_rng(seed)
    snap, _ = synthetic_device_snapshot(n_tasks=200, n_nodes=40,
                                        gpu_task_frac=0.3, seed=seed)
    T, N = snap.task_req.shape[0], snap.node_alloc.shape[0]
    W = 2
    bits = lambda shape, p: np.where(  # noqa: E731
        rng.random(shape) < p, rng.integers(0, 2**32, shape, dtype=np.uint64),
        0).astype(np.uint32)
    node_label = bits((N, W), 0.9) | np.uint32(0x80000000)
    sel = bits((T, W), 0.2) & node_label[rng.integers(0, N, T)]
    sel[::7] |= np.uint32(0x40000000)  # some selectors no node satisfies
    node_alloc = np.asarray(snap.node_alloc).copy()
    node_alloc[3, 0] = 0.0   # a node without cpu
    node_alloc[5, 1] = 0.0   # a node without memory
    used = np.round(node_alloc * rng.random(node_alloc.shape) / 250) * 250
    used[:, 1] = rng.integers(0, 64, N) * 2.0**30
    aff_idx = np.asarray([-1, 0, 9, -1, 33, 150], np.int32)
    aff_mask = rng.random((6, N)) < 0.6
    pref_idx = np.asarray([4, -1, 0, 77], np.int32)
    return snap._replace(
        task_sel_bits=sel,
        task_sel_impossible=rng.random(T) < 0.05,
        task_tol_bits=bits((T, W), 0.5),
        node_label_bits=node_label,
        node_taint_bits=bits((N, W), 0.3) & bits((N, W), 0.5),
        node_valid=np.asarray(snap.node_valid) & (rng.random(N) < 0.9),
        node_sched=rng.random(N) < 0.9,
        node_alloc=node_alloc.astype(np.float32),
        node_used=used.astype(np.float32),
        task_aff_idx=aff_idx,
        task_aff_mask=aff_mask,
        task_pref_idx=pref_idx,
        task_pref_node=(rng.integers(0, 11, (4, N)) * 0.5).astype(np.float32),
        task_pref_pod=rng.uniform(-3, 3, (4, N)).astype(np.float32),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_fits_matches_jax(seed):
    rng = np.random.default_rng(seed)
    quanta = np.asarray([10.0, 10 * 2**20, 0.1, 10.0], np.float32)
    req = (rng.integers(0, 40, (60, 4)) * quanta * 0.5).astype(np.float32)
    budget = (rng.integers(0, 40, (33, 4)) * quanta * 0.5).astype(np.float32)
    budget[::5] = req[0] + quanta * 0.999  # within a quantum: still fits
    _eq(feasibility.fits(_t(req), _t(budget), _t(quanta)),
        jax.jit(jfeas.fits)(req, budget, quanta))


@pytest.mark.parametrize("seed", [0, 1])
def test_static_predicates_matches_jax(seed):
    snap = _rich_snapshot(seed)
    want = np.asarray(jax.jit(jfeas.static_predicates)(_jnp(snap)))
    got = feasibility.static_predicates(snapshot_from_numpy(snap, "cpu"))
    _eq(got, want)
    # the real row-0 affinity update survives the padding rows clipped
    # onto row 0
    assert not want[0].all()


@pytest.mark.parametrize("weights", [
    dict(),
    dict(binpack=0.5, least_requested=2.0, balanced_resource=0.0,
         node_affinity=1.5, pod_affinity=0.25),
])
def test_score_matrix_matches_jax(weights):
    snap = _rich_snapshot(2)
    want = jax.jit(jscore.score_matrix, static_argnums=1)(
        _jnp(snap), jscore.ScoreWeights(**weights))
    got = scoring.score_matrix(snapshot_from_numpy(snap, "cpu"),
                               scoring.ScoreWeights(**weights))
    _eq(got, want)


def test_score_matrix_rejects_custom_rows():
    """Custom rows are summed into the plane; a row that does not
    broadcast to [T, N] is rejected."""
    snap = snapshot_from_numpy(_rich_snapshot(0), "cpu")
    T, N = snap.task_req.shape[0], snap.node_alloc.shape[0]
    base = scoring.score_matrix(snap, scoring.ScoreWeights())
    row = torch.arange(N, dtype=torch.float32).expand(T, N)
    w = scoring.ScoreWeights(extra_rows=(("x", lambda s: row, 2.0),))
    assert torch.equal(scoring.score_matrix(snap, w), base + 2.0 * row)
    bad = scoring.ScoreWeights(extra_rows=(("bad", lambda s: torch.zeros(T + 1, N), 1.0),))
    with pytest.raises(RuntimeError):
        scoring.score_matrix(snap, bad)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fairness_matches_jax(seed):
    rng = np.random.default_rng(seed)
    Q, R = 8, 4
    total = rng.uniform(1e3, 1e6, R).astype(np.float32)
    total[3] = 0.0 if seed % 2 else total[3]
    weight = rng.integers(1, 5, Q).astype(np.float32)
    request = (rng.uniform(0, 0.5, (Q, R)) * total).astype(np.float32)
    valid = rng.random(Q) < 0.8
    want = np.asarray(jax.jit(jfair.proportion_deserved)(
        total, weight, request, valid))
    got = fairness.proportion_deserved(_t(total), _t(weight), _t(request),
                                       _t(valid))
    _eq(got, want)
    alloc = (rng.uniform(0, 0.3, (Q, R)) * total).astype(np.float32)
    quanta = np.asarray([10.0, 1.0, 0.1, 10.0], np.float32)
    _eq(fairness.dominant_share(_t(alloc), _t(total)),
        jax.jit(jfair.dominant_share)(alloc, total))
    _eq(fairness.queue_share(_t(alloc), _t(want)),
        jax.jit(jfair.queue_share)(alloc, want))
    _eq(fairness.overused(_t(want), _t(alloc), _t(quanta)),
        jax.jit(jfair.overused)(want, alloc, quanta))


def test_segmented_prefix_matches_jax():
    rng = np.random.default_rng(0)
    vals = (rng.integers(0, 17, (500, 3)) * 250.0).astype(np.float32)
    starts = rng.random(500) < 0.1
    starts[0] = True
    _eq(ordering.segmented_prefix(_t(vals), _t(starts)),
        jax.jit(jord.segmented_prefix)(vals, starts))


@pytest.mark.parametrize("T,n_segments", [(300, 9), (4096, 2**20)])
def test_sort_by_segment_then_rank_both_branches(T, n_segments):
    """(300, 9) packs one int32 key; (4096, 2^20) overflows the packing
    and takes the chained stable argsorts."""
    rng = np.random.default_rng(T)
    seg = rng.integers(0, min(n_segments, 40), T).astype(np.int32)
    rank = rng.permutation(T).astype(np.int32)
    got = ordering.sort_by_segment_then_rank(_t(seg), _t(rank), n_segments)
    want = jord.sort_by_segment_then_rank(jnp.asarray(seg), jnp.asarray(rank),
                                          n_segments)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_multisort_ranks_and_subranks_match_jax():
    rng = np.random.default_rng(4)
    keys = [rng.integers(0, 3, 400).astype(np.int32),
            rng.integers(-2, 2, 400).astype(np.int32),
            rng.integers(0, 5, 400).astype(np.int32)]
    _eq(ordering.multisort_ranks([_t(k) for k in keys]),
        jord.multisort_ranks([jnp.asarray(k) for k in keys]))
    prio, creation = keys[1], keys[2]
    _eq(ordering.task_subranks(_t(prio), _t(creation)),
        jord.task_subranks(jnp.asarray(prio), jnp.asarray(creation)))


@pytest.mark.parametrize("flags", [
    (True, True, True), (True, False, True), (False, True, False),
])
def test_virtual_task_ranks_matches_jax(flags):
    gang, drf, prop = flags
    rng = np.random.default_rng(7)
    T, J, Q, R = 512, 96, 4, 4
    task_job = np.sort(rng.integers(0, J, T)).astype(np.int32)
    job_queue = rng.integers(0, Q, J).astype(np.int32)
    resreq = np.stack([rng.choice([250.0, 500.0, 4000.0], T),
                       rng.choice([1.0, 2.0, 8.0], T) * 2**30,
                       np.ones(T), np.zeros(T)], 1).astype(np.float32)
    total = np.asarray([64e4, 2560 * 2.0**30, 2200, 0], np.float32)
    args = dict(
        pending=rng.random(T) < 0.8,
        resreq=resreq,
        task_job=task_job,
        task_queue=job_queue[task_job],
        subrank=rng.permutation(T).astype(np.int32),
        job_prio=np.where(rng.random(J) < 0.1, 100, 0).astype(np.int32),
        job_ready_now=rng.random(J) < 0.3,
        job_creation=rng.permutation(J).astype(np.int32),
        job_alloc=(rng.integers(0, 8, (J, R)) * np.asarray(
            [1000, 2**30, 1, 0])).astype(np.float32),
        queue_alloc=(rng.integers(0, 50, (Q, R)) * np.asarray(
            [1000, 2**30, 1, 0])).astype(np.float32),
        deserved=(rng.integers(1, 200, (Q, R)) * np.asarray(
            [1000, 2**30, 1, 0])).astype(np.float32),
        total=total,
        job_need=rng.integers(0, 4, J).astype(np.int32),
    )
    want = jax.jit(jord.virtual_task_ranks, static_argnames=(
        "gang_enabled", "drf_enabled", "proportion_enabled"))(
        **{k: jnp.asarray(v) for k, v in args.items()},
        gang_enabled=gang, drf_enabled=drf, proportion_enabled=prop)
    got = ordering.virtual_task_ranks(
        **{k: _t(v) for k, v in args.items()},
        gang_enabled=gang, drf_enabled=drf, proportion_enabled=prop)
    _eq(got, want)


def test_round_to_i32_saturates_like_xla():
    x = np.asarray([1e10, -1e10, np.inf, -np.inf, 2147483520.0, 2.5, -3.5,
                    0.5, 1.5], np.float32)
    want = np.asarray(jnp.round(jnp.asarray(x)).astype(jnp.int32))
    _eq(ordering.round_to_i32(_t(x)), want)


def test_f32_sort_key_matches_jax():
    vals = np.asarray([NEG, -1.0e10, -1.5, -1.0, -1e-30, -0.0, 0.0, 1e-30,
                       1.0, 2.5, 3.0e38], np.float32)
    got = f32_sort_key(_t(vals))
    _eq(got, jax_sort_key(jnp.asarray(vals)))
    assert got[5] == got[6]  # -0.0 and +0.0 share one key
    assert (np.diff(np.delete(got.numpy(), 5)) > 0).all()


@pytest.mark.parametrize("P,M,K,block", [(40, 150, 12, 32), (16, 256, 8, 64)])
def test_lex_topk_matches_jax(P, M, K, block):
    """Heavy score and hash ties; M=150 is not a multiple of the block, so
    the padding path runs too."""
    rng = np.random.default_rng(5)
    score = np.round(rng.uniform(0, 3, (P, M)) * 4).astype(np.float32) / 4
    score[rng.random((P, M)) < 0.35] = NEG
    hashes = rng.integers(0, 5, (P, M)).astype(np.int32)
    skey = np.asarray(jax_sort_key(jnp.asarray(score)))
    idx0 = (np.broadcast_to(np.arange(M, dtype=np.int32), (P, M)) + 7).copy()
    want = jax_lex_topk(jnp.asarray(skey), jnp.asarray(hashes),
                        jnp.asarray(idx0), K, block)
    got = lex_topk(_t(skey), _t(hashes), _t(idx0), K, block)
    for g, w in zip(got, want):
        _eq(g, w)
