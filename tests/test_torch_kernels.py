"""The two kernels' plain versions against the JAX package's Pallas
kernels (interpret mode on the CPU), and — on a card — each CUDA kernel
against its plain version.  Every output is compared bit-exactly: the
picks, the f32 values and hashes, the sort keys and K2's block triples.

JAX is imported inside the tests that use it, so the ``cuda`` tests run
on a machine that has PyTorch and no JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.ops import kernels
from kube_batch_tpu_torch.ops.kernels import (
    NEG,
    masked_best_node_raw,
    masked_best_node_raw_plain,
    masked_topk_blocks,
    masked_topk_blocks_plain,
)
from kube_batch_tpu_torch.testing.kernel_bench import offset_copy

QUANTA = np.asarray([10.0, 10 * 2**20, 0.1, 10.0], np.float32)


def k1_inputs(T, N, seed=0):
    """Round-head inputs with forced score ties, infeasible and
    non-pending rows, and releasing budgets that fit where idle does not."""
    rng = np.random.default_rng(seed)
    score = (np.round(rng.uniform(0, 3, (T, N)) * 2) / 2).astype(np.float32)
    static_ok = rng.random((T, N)) < 0.7
    static_ok[::11] = False                       # rows with nothing feasible
    unit = np.asarray([250.0, 2.0**30, 1.0, 1000.0], np.float32)
    task_req = (rng.integers(1, 9, (T, 4)) * unit).astype(np.float32)
    task_req[:, 3] *= rng.random(T) < 0.3
    idle = (rng.integers(0, 12, (N, 4)) * unit).astype(np.float32)
    releasing = np.where(rng.random((N, 1)) < 0.4,
                         rng.integers(0, 12, (N, 4)) * unit, 0.0
                         ).astype(np.float32)
    pending = rng.random(T) < 0.85
    return dict(score=score, static_ok=static_ok, task_req=task_req,
                idle=idle, releasing=releasing, pending=pending,
                quanta=QUANTA)


def k2_inputs(P, N, seed=0, neg_zero=False):
    """Candidate-build inputs; ``neg_zero`` turns some zero scores into
    -0.0, which must key exactly like +0.0."""
    rng = np.random.default_rng(seed)
    k1 = k1_inputs(P, N, seed)
    score_static = np.where(k1["static_ok"], k1["score"], NEG).astype(np.float32)
    score_static[rng.random((P, N)) < 0.05] = -0.0 if neg_zero else 0.0
    rows = rng.choice(60_000, P, replace=False).astype(np.int32)
    return dict(score_static=score_static, task_req=k1["task_req"],
                idle=k1["idle"], releasing=k1["releasing"], rows=rows,
                quanta=QUANTA)


def np_tie_hash(ti, ni):
    """The tie hash in numpy uint32 arithmetic, [len(ti), len(ni)] i32."""
    ti = np.asarray(ti, np.int64).astype(np.uint32)
    ni = np.asarray(ni, np.int64).astype(np.uint32)
    h = ti[:, None] * np.uint32(0x9E3779B1) + ni[None, :] * np.uint32(0x85EBCA77)
    h = (h ^ (h >> np.uint32(15))) * np.uint32(0xCA87C3EB)
    return (h >> np.uint32(16)).astype(np.int32)


def tie_rows(n_rows, cols, start=0):
    """The first ``n_rows`` global task rows from ``start`` on whose highest
    tie hash over the global columns ``cols`` occurs more than once — rows
    where a constant score leaves the pick to the node index."""
    found = []
    t = start
    while len(found) < n_rows:
        ti = np.arange(t, t + 4096)
        h = np_tie_hash(ti, cols)
        dup = (h == h.max(axis=1, keepdims=True)).sum(axis=1) >= 2
        found.extend(ti[dup].tolist())
        t += 4096
    return np.asarray(found[:n_rows], np.int64)


def k1_tie_inputs(T, N):
    """Every cell feasible at the same score: each pick is the first
    column of the row's highest hash."""
    inp = k1_inputs(T, N, seed=7)
    inp["score"] = np.full((T, N), 1.5, np.float32)
    inp["static_ok"] = np.ones((T, N), bool)
    inp["pending"] = np.ones(T, bool)
    inp["idle"] = np.full_like(inp["idle"], 1e30)
    return inp


def k1_tie_block(T, N):
    """(t0, n0) of a block of K1's tie fixture that holds at least one
    row decided by the node index."""
    n0 = 64
    t = int(tie_rows(1, np.arange(n0, n0 + N))[0])
    return max(0, t - T // 2), n0


def k2_tie_inputs(P, N, n0=0):
    """Constant static scores that all fit, over bucket rows chosen so that
    the first 64-column block of some rows is decided by the column."""
    inp = k2_inputs(P, N, seed=5)
    inp["score_static"] = np.full((P, N), 2.0, np.float32)
    inp["idle"] = np.full_like(inp["idle"], 1e30)
    ties = tie_rows(min(P, 4), np.arange(n0, n0 + 64))
    rows = np.unique(np.concatenate([ties, 100_000 + np.arange(P)]))[:P]
    inp["rows"] = np.sort(rows).astype(np.int32)
    inp["rows"][: len(ties)] = ties
    return inp


def first_max_hash_col(rows, cols):
    """[len(rows)] local column of the first highest hash, and whether
    that highest hash occurs more than once."""
    h = np_tie_hash(rows, cols)
    top = h.max(axis=1, keepdims=True)
    return h.argmax(axis=1), (h == top).sum(axis=1) >= 2


def _widen(inp, R):
    """The resource axis of ``inp`` tiled (or cut) to ``R`` columns."""
    out = dict(inp)
    for k in ("task_req", "idle", "releasing"):
        out[k] = np.ascontiguousarray(np.concatenate([inp[k]] * 2, 1)[:, :R])
    out["quanta"] = np.ascontiguousarray(np.concatenate([inp["quanta"]] * 2)[:R])
    return out


def _torch(inputs, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in inputs.items()}


def _assert_same(got, want, names):
    for name, g, w in zip(names, got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


K1_OUT = ("best", "val", "hash", "chose_idle")
K2_OUT = ("skey", "bval", "bhash", "bcol")


@pytest.mark.parametrize("T,N,t0,n0", [(256, 1024, 0, 0), (256, 1024, 768, 4096)])
def test_k1_plain_matches_pallas(T, N, t0, n0):
    """N=1024 is two Pallas node tiles, so the cross-tile merge runs."""
    from kube_batch_tpu.ops.pallas_kernels import (
        masked_best_node_raw as pallas_k1,
    )

    inp = k1_inputs(T, N, seed=T + n0)
    want = pallas_k1(**inp, t0=t0, n0=n0, interpret=True)
    got = masked_best_node_raw_plain(**_torch(inp), t0=t0, n0=n0)
    _assert_same(got, want, K1_OUT)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = dict(kernels.launches)
    _assert_same(masked_best_node_raw(**_torch(inp), t0=t0, n0=n0), want, K1_OUT)
    assert kernels.launches == before
    has = np.asarray(want[1]) > NEG
    assert has.any() and not has.all()


@pytest.mark.parametrize("P,N,n0", [(256, 1024, 0), (256, 512, 1536)])
def test_k2_plain_matches_pallas(P, N, n0):
    """K2's first behavioural test: the key plane AND the per-64-column
    winner triples."""
    from kube_batch_tpu.ops.pallas_kernels import (
        masked_topk_blocks as pallas_k2,
    )

    inp = k2_inputs(P, N, seed=N + n0)
    want = pallas_k2(**inp, n0=n0, interpret=True)
    got = masked_topk_blocks_plain(**_torch(inp), n0=n0)
    _assert_same(got, want, K2_OUT)
    before = dict(kernels.launches)
    _assert_same(masked_topk_blocks(**_torch(inp), n0=n0), want, K2_OUT)
    assert kernels.launches == before


def test_k2_keys_negative_zero_as_positive_zero():
    """``+ 0.0`` canonicalises -0.0, so both zeros share one key, as the
    float compare of the full-matrix head treats them.  (The Pallas kernel
    compiled by XLA loses this: its simplifier folds ``x + 0.0`` — a fault
    of the reference recorded in ROADMAP.md's queue of port faults, which
    is why the Pallas parity inputs above carry +0.0 only.)"""
    from kube_batch_tpu.ops.assignment import f32_sort_key as jax_sort_key

    inp = k2_inputs(64, 192, seed=4, neg_zero=True)
    pos = {**inp, "score_static": inp["score_static"] + np.float32(0.0)}
    assert (np.signbit(inp["score_static"]) & (inp["score_static"] == 0)).any()
    got = masked_topk_blocks_plain(**_torch(inp))
    _assert_same(got, masked_topk_blocks_plain(**_torch(pos)), K2_OUT)
    # the JAX package's sort key, run op by op, agrees
    np.testing.assert_array_equal(
        kernels.f32_sort_key(torch.tensor([-0.0, 0.0])).numpy(),
        np.asarray(jax_sort_key(np.asarray([-0.0, 0.0], np.float32))))


def test_k2_triples_are_the_block_lexicographic_winners():
    """The triple is (max key, max hash among key ties, first column among
    full ties) of each 64-column block, checked against a brute force."""
    inp = k2_inputs(8, 192, seed=3)
    skey, bval, bhash, bcol = masked_topk_blocks_plain(**_torch(inp))
    hashes = kernels.tie_break_hash_rows(torch.from_numpy(inp["rows"]),
                                         torch.arange(192, dtype=torch.int32))
    for p in range(8):
        for b in range(3):
            cols = range(b * 64, (b + 1) * 64)
            top = min(cols, key=lambda c: (-int(skey[p, c]), -int(hashes[p, c]), c))
            assert int(bval[p, b]) == int(skey[p, top])
            assert int(bhash[p, b]) == int(hashes[p, top])
            assert int(bcol[p, b]) == top - b * 64


def test_k1_tie_fixture_is_decided_by_the_node_index():
    """Constant scores, all feasible: the plain version and the Pallas
    kernel both pick the first column of each row's highest hash, and the
    fixture holds rows where that hash occurs twice."""
    from kube_batch_tpu.ops.pallas_kernels import (
        masked_best_node_raw as pallas_k1,
    )

    T, N = 256, 1024
    t0, n0 = k1_tie_block(T, N)
    inp = k1_tie_inputs(T, N)
    want = pallas_k1(**inp, t0=t0, n0=n0, interpret=True)
    got = masked_best_node_raw_plain(**_torch(inp), t0=t0, n0=n0)
    _assert_same(got, want, K1_OUT)
    col, tied = first_max_hash_col(np.arange(t0, t0 + T), np.arange(n0, n0 + N))
    assert tied.any()
    np.testing.assert_array_equal(got[0].numpy(), col)
    np.testing.assert_array_equal(got[1].numpy(), np.float32(1.5))


def test_k2_tie_fixture_is_decided_by_the_column():
    """Constant keys: each block's triple is the first column of its
    highest hash; the fixture's first rows tie on that hash in block 0."""
    from kube_batch_tpu.ops.pallas_kernels import (
        masked_topk_blocks as pallas_k2,
    )

    P, N = 256, 512
    inp = k2_tie_inputs(P, N)
    want = pallas_k2(**inp, n0=0, interpret=True)
    got = masked_topk_blocks_plain(**_torch(inp))
    _assert_same(got, want, K2_OUT)
    col, tied = first_max_hash_col(inp["rows"], np.arange(64))
    assert tied[:4].all()
    np.testing.assert_array_equal(got[3][:, 0].numpy(), col)


def test_tie_rows_hold_a_repeated_highest_hash():
    rows = tie_rows(3, np.arange(100, 164))
    assert len(set(rows.tolist())) == 3
    h = np_tie_hash(rows, np.arange(100, 164))
    assert ((h == h.max(axis=1, keepdims=True)).sum(axis=1) >= 2).all()
    # the numpy hash is the port's
    np.testing.assert_array_equal(
        h, kernels.tie_break_hash_rows(torch.from_numpy(rows),
                                       torch.arange(100, 164)).numpy())


def test_offset_copy_is_contiguous_and_unaligned():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    y = offset_copy(x, 1)
    assert y.is_contiguous() and torch.equal(x, y)
    assert y.data_ptr() % 16 == 4


PTXAS_OUT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__ca5a8309_12_best_node_cu_cbed304423masked_best_node_kernelILi4ELi4ELi1024EEEvPKfPKhS2_S2_S2_S4_S2_iiiiPiPfS6_Ph' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__ca5a8309_12_best_node_cu_cbed304423masked_best_node_kernelILi4ELi4ELi1024EEEvPKfPKhS2_S2_S2_S4_S2_iiiiPiPfS6_Ph
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 32768 bytes smem
ptxas info    : Compiling entry function '_Z6legacyPf' for 'sm_90a'
ptxas info    : Function properties for _Z6legacyPf
    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers
"""


def test_ptxas_summary_gives_each_kernel_its_figures():
    from kube_batch_tpu_torch.ops._build import ptxas_summary

    assert ptxas_summary(PTXAS_OUT) == [
        "masked_best_node_kernel<4, 4, 1024>: Used 128 registers, used 1 "
        "barriers, 32768 bytes smem; 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads",
        "_Z6legacyPf: Used 64 registers; 8 bytes stack frame, 12 bytes spill "
        "stores, 12 bytes spill loads",
    ]
    assert ptxas_summary("") == []


def _bench_case(T=96, N=200, seed=3):
    inp = _torch(k1_inputs(T, N, seed=seed))
    return dict(inp, t0=5, n0=7)


def test_late_round_keeps_the_first_tenth_of_the_pending_rows():
    from kube_batch_tpu_torch.testing.kernel_bench import late_round

    inp = _bench_case()
    late = late_round(inp)
    rows = torch.nonzero(inp["pending"]).flatten()
    want = torch.zeros_like(inp["pending"])
    want[rows[: int(rows.numel() * 0.1)]] = True
    assert torch.equal(late["pending"], want) and want.any()
    assert late["score"] is inp["score"]
    none = dict(inp, pending=torch.zeros_like(inp["pending"]))
    assert not late_round(none)["pending"].any()


def test_k1_bound_counts_only_the_pending_rows_bytes():
    from kube_batch_tpu_torch.testing.kernel_bench import (
        HBM_BYTES_PER_S, k1_bound,
    )

    T, N = 2048, 5120
    inp = dict(score=torch.zeros(T, N), static_ok=torch.zeros(T, N, dtype=torch.bool),
               task_req=torch.zeros(T, 4), idle=torch.zeros(N, 4),
               releasing=torch.zeros(N, 4),
               pending=torch.arange(T) < 1900, quanta=torch.zeros(4))
    ms, by = k1_bound(inp)
    small = T * 4 * 4 + 2 * N * 4 * 4 + T + 16 + T * 13
    assert by == "bytes"
    assert ms == pytest.approx((1900 * N * 5 + small) / HBM_BYTES_PER_S * 1e3)
    # a late round with 100 pending rows needs far fewer bytes
    assert k1_bound(dict(inp, pending=torch.arange(T) < 100))[0] < ms / 3


def test_index_decided_rows_counts_the_tie_fixture():
    from kube_batch_tpu_torch.testing.kernel_bench import index_decided_rows

    T, N = 256, 1024
    t0, n0 = k1_tie_block(T, N)
    inp = dict(_torch(k1_tie_inputs(T, N)), t0=t0, n0=n0)
    _, tied = first_max_hash_col(np.arange(t0, t0 + T), np.arange(n0, n0 + N))
    assert index_decided_rows(inp) == int(tied.sum()) > 0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,t0,n0", [(256, 1024, 0, 0), (301, 777, 5, 9000),
                                       (1, 31, 0, 0)])
def test_k1_kernel_matches_plain(cuda_device, T, N, t0, n0):
    """Ragged shapes (no multiple of a warp or a tile) included."""
    inp = _torch(k1_inputs(T, N, seed=T), cuda_device)
    want = masked_best_node_raw_plain(**inp, t0=t0, n0=n0)
    before = kernels.launches["masked_best_node_raw"]
    got = masked_best_node_raw(**inp, t0=t0, n0=n0)
    torch.cuda.synchronize()
    assert kernels.launches["masked_best_node_raw"] == before + 1
    _assert_same(got, want, K1_OUT)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,n0", [(256, 1024, 0), (130, 300, 77), (3, 40, 0)])
def test_k2_kernel_matches_plain(cuda_device, P, N, n0):
    """N=300 and N=40 end in a partial 64-column block (keys, no triple)."""
    inp = _torch(k2_inputs(P, N, seed=P, neg_zero=True), cuda_device)
    want = masked_topk_blocks_plain(**inp, n0=n0)
    before = kernels.launches["masked_topk_blocks"]
    got = masked_topk_blocks(**inp, n0=n0)
    torch.cuda.synchronize()
    assert kernels.launches["masked_topk_blocks"] == before + 1
    _assert_same(got, want, K2_OUT)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    inp = _torch(k1_inputs(32, 64), cuda_device)
    with pytest.raises(TypeError):
        masked_best_node_raw(**{**inp, "static_ok": inp["static_ok"].float()})
    with pytest.raises(ValueError):
        masked_best_node_raw(**{**inp, "score": inp["score"].t().contiguous().t()})
    with pytest.raises(ValueError):
        masked_best_node_raw(**{**inp, "pending": inp["pending"].cpu()})


def _k1_on_card(inp, t0, n0):
    want = masked_best_node_raw_plain(**inp, t0=t0, n0=n0)
    before = kernels.launches["masked_best_node_raw"]
    got = masked_best_node_raw(**inp, t0=t0, n0=n0)
    torch.cuda.synchronize()
    assert kernels.launches["masked_best_node_raw"] == before + 1
    _assert_same(got, want, K1_OUT)
    return got


def _k2_on_card(inp, n0):
    want = masked_topk_blocks_plain(**inp, n0=n0)
    before = kernels.launches["masked_topk_blocks"]
    got = masked_topk_blocks(**inp, n0=n0)
    torch.cuda.synchronize()
    assert kernels.launches["masked_topk_blocks"] == before + 1
    _assert_same(got, want, K2_OUT)
    return got


# (T or P, N, t0, n0, storage offset of the [*, N] planes, R): a warp sweeps
# 4 rows (2 above R = 4) in 16 B steps over 1 024-column chunks (512 above
# R = 4), so these cover odd N above the vector width, unaligned row
# starts, rows past the last full warp, several chunks and both widths
KERNEL_CORNERS = [
    pytest.param(37, 2051, 3, 11, 1, 4, id="odd-n-unaligned-start"),
    pytest.param(33, 4100, 0, 7, 0, 4, id="several-chunks"),
    pytest.param(70, 640, 1000, 0, 0, 4, id="rows-past-full-warps"),
    pytest.param(45, 1300, 0, 3, 2, 1, id="r1"),
    pytest.param(45, 1300, 9, 0, 0, 8, id="r8-several-chunks"),
    pytest.param(1, 2500, 0, 5, 0, 4, id="one-row"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,t0,n0,off,R", KERNEL_CORNERS)
def test_k1_kernel_corners(cuda_device, T, N, t0, n0, off, R):
    inp = _torch(_widen(k1_inputs(T, N, seed=N), R), cuda_device)
    inp["score"] = offset_copy(inp["score"], off)
    inp["static_ok"] = offset_copy(inp["static_ok"], off)
    _k1_on_card(inp, t0, n0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all-non-pending", "all-infeasible"])
def test_k1_kernel_rows_without_candidates(cuda_device, case):
    """Each pick is the first column of highest hash, val NEG."""
    inp = _torch(k1_inputs(45, 1500, seed=2), cuda_device)
    if case == "all-non-pending":
        inp["pending"][:] = False
    else:
        inp["static_ok"][:] = False
    got = _k1_on_card(inp, 17, 5)
    assert (got[1] == NEG).all()


@pytest.mark.cuda
def test_k1_kernel_forced_ties(cuda_device):
    T, N = 256, 5117
    t0, n0 = k1_tie_block(T, N)
    inp = _torch(k1_tie_inputs(T, N), cuda_device)
    got = _k1_on_card(inp, t0, n0)
    col, tied = first_max_hash_col(np.arange(t0, t0 + T), np.arange(n0, n0 + N))
    assert tied.any()
    np.testing.assert_array_equal(got[0].cpu().numpy(), col)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,t0,n0,off,R", KERNEL_CORNERS)
def test_k2_kernel_corners(cuda_device, P, N, t0, n0, off, R):
    inp = _torch(_widen(k2_inputs(P, N, seed=N, neg_zero=True), R), cuda_device)
    inp["score_static"] = offset_copy(inp["score_static"], off)
    _k2_on_card(inp, n0 + t0)


@pytest.mark.cuda
def test_k2_kernel_forced_ties(cuda_device):
    inp = _torch(k2_tie_inputs(64, 1000), cuda_device)
    got = _k2_on_card(inp, 0)
    col, tied = first_max_hash_col(inp["rows"].cpu().numpy(), np.arange(64))
    assert tied[:4].all()
    np.testing.assert_array_equal(got[3][:, 0].cpu().numpy(), col)
