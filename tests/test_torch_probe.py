"""The port's what-if probe against the JAX package's, on the same inputs.

``ops/probe.probe_solve`` of both packages runs on the same numpy session
snapshot and the same seeded ``ProbeBatch`` (B = 4 gangs of up to G = 8
members), at probe rows with gaps and rows beyond the snapshot's task
axis, with the eviction probe off and on (two victim-gate sets).  Every
``ProbeResult`` field is compared bit for bit.  The gang view itself is
compared field by field, and K1's plain version at explicit rows is held
against the full-matrix ``_best_node`` over ``tie_break_hash_rows`` (the
JAX probe's head); on a card, K1 at explicit rows against its plain
version.  The snapshots' resource sums are exact multiples of their
quanta, so any order of the f32 sums gives the same value."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.ops import kernels
from kube_batch_tpu_torch.ops.kernels import masked_best_node_raw, masked_best_node_raw_plain
from test_torch_kernels import K1_OUT, _assert_same, _torch, k1_inputs, k1_tie_inputs
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

B, G = 4, 8
GiB = float(2**30)


def _full_cluster():
    """12 nodes filled by queue "busy": elastic single-pod jobs (victims),
    two-pod gangs at MinAvailable (protected by the gang gate unless it is
    off) and kube-system pods (protected by conformance); queue "idle"
    runs nothing."""
    from kube_batch_tpu.api.pod import PodGroup, Queue
    from kube_batch_tpu.api.types import PodPhase
    from fixtures import build_cache, build_node, build_pod

    nodes = [build_node(f"n{i}", cpu=8000, mem=16 * GiB) for i in range(12)]
    pgs, pods = [], []
    for i in range(12):
        # per node: three elastic 2000-cpu pods and one 2 × 1000-cpu gang
        for k in range(4):
            j = 4 * i + k
            gang = k == 3
            pgs.append(PodGroup(name=f"low{j}", namespace="c1", queue="busy",
                                min_member=2 if gang else 1))
            ns = "kube-system" if j % 7 == 0 and not gang else "c1"
            for m in range(2 if gang else 1):
                pods.append(build_pod(ns, f"low{j}-{m}", f"n{i}", PodPhase.RUNNING,
                                      {"cpu": 1000.0 if gang else 2000.0, "memory": GiB},
                                      group_name=f"low{j}"))
    return build_cache(nodes=nodes, pods=pods, pod_groups=pgs,
                       queues=[Queue(name="busy", weight=1), Queue(name="idle", weight=3)])


def _snapshots():
    from test_torch_eviction import _snapshot
    from test_torch_solve import _fixture

    return {
        # full nodes of one busy queue (the eviction probe's victims)
        "full": lambda: _snapshot(_full_cluster()),
        # gangs of 2 over 2 queues with idle room
        "session": lambda: _fixture("session")[0],
    }


_CACHE: dict = {}


def snapshot(name):
    if name not in _CACHE:
        _CACHE[name] = _snapshots()[name]()
    return _CACHE[name]


def probe_batch(snap, seed=0):
    """B seeded gangs over the snapshot's queues: the first in queue 0 with
    requests the busy cluster's victims can cover, one in an unknown
    queue, one with a selector bit no node carries (bit 31: a negative i32
    view), one asking for MinResources, one with min_available above its
    count."""
    from kube_batch_tpu.ops.probe import ProbeBatch

    rng = np.random.default_rng(seed)
    T, R = snap.task_req.shape
    W = snap.task_sel_bits.shape[1]
    Wt = snap.task_tol_bits.shape[1]
    req = np.zeros((B, G, R), np.float32)
    valid = np.zeros((B, G), bool)
    counts = []
    for b in range(B):
        n = int(rng.integers(1, G + 1 if b else 5))
        counts.append(n)
        valid[b, :n] = True
        req[b, :n, 0] = rng.choice([3000.0, 4000.0] if b == 0
                                   else [250.0, 1000.0, 3000.0, 7500.0], n)
        req[b, :n, 1] = GiB
        req[b, :n, 2] = 1.0  # the pods dimension
    sel_bits = np.zeros((B, W), np.uint32)
    sel_bits[2, 0] = np.uint32(1 << 31)
    min_res = np.zeros((B, R), np.float32)
    min_res[1, 0] = 4000.0
    has_min_res = np.zeros(B, bool)
    has_min_res[1] = True
    min_avail = np.asarray(counts, np.int32)
    min_avail[3] += 1
    batch = ProbeBatch(
        req=req, valid=valid, min_avail=min_avail,
        queue=np.asarray([0, 1, 0, -1], np.int32),
        prio=np.asarray([100, 0, 50, 100], np.int32),
        sel_bits=sel_bits, sel_impossible=np.asarray([False, False, False, True]),
        tol_bits=np.zeros((B, Wt), np.uint32), min_res=min_res,
        has_min_res=has_min_res,
    )
    # rows with gaps, some beyond the task axis (a grown row)
    rows = rng.choice(T + 64, G, replace=False).astype(np.int32)
    rows[0] = T + 3
    return batch, rows


EVICT = {
    "default_gates": dict(mode="preempt"),
    "no_gang_gate": dict(mode="preempt", victim_gang=False),
}
CASES = [("full", False, "default_gates"), ("full", True, "default_gates"),
         ("full", True, "no_gang_gate"), ("session", False, "default_gates"),
         ("session", True, "default_gates")]


@pytest.mark.parametrize("name,with_evictions,gates", CASES)
def test_probe_solve_matches_jax(name, with_evictions, gates):
    from kube_batch_tpu.ops.assignment import AllocateConfig as JaxConfig
    from kube_batch_tpu.ops.eviction import EvictConfig as JaxEvict
    from kube_batch_tpu.ops.probe import probe_solve as jax_probe
    from kube_batch_tpu_torch.api.convert import config_from_fields, snapshot_from_numpy
    from kube_batch_tpu_torch.ops.eviction import EvictConfig
    from kube_batch_tpu_torch.ops.probe import probe_batch_from_numpy, probe_solve

    snap = snapshot(name)
    batch, rows = probe_batch(snap, seed=len(name))
    jcfg = JaxConfig()
    jevc = JaxEvict(**EVICT[gates])
    want = jax_probe(snap, batch, rows, jcfg, jevc, with_evictions)
    got = probe_solve(snapshot_from_numpy(snap, "cpu"), probe_batch_from_numpy(batch, "cpu"),
                      torch.from_numpy(rows), config_from_fields(jcfg),
                      EvictConfig(**EVICT[gates]), with_evictions)
    for field in want._fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (field, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=field)
    if with_evictions and name == "full":
        assert got.victims.any(), "the fixture must exercise the eviction probe"
    if name == "session":
        assert got.feasible.any(), "the fixture must place a gang"


def test_gang_view_matches_jax():
    """Every field of one gang's view (the task axis replaced by the
    gang's rows, the job appended, the queue request bumped)."""
    import jax

    from kube_batch_tpu.ops.probe import _gang_view
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy, snapshot_to_numpy
    from kube_batch_tpu_torch.ops.probe import _gang_view as port_view
    from kube_batch_tpu_torch.ops.probe import probe_batch_from_numpy

    jax_view = jax.jit(_gang_view)
    snap = snapshot("full")
    batch, _rows = probe_batch(snap, seed=3)
    pb = probe_batch_from_numpy(batch, "cpu")
    for b in range(B):
        want = jax_view(snap, *(np.asarray(getattr(batch, f)[b]) for f in (
            "req", "valid", "min_avail", "queue", "prio", "sel_bits", "sel_impossible",
            "tol_bits")))
        got = snapshot_to_numpy(port_view(
            snapshot_from_numpy(snap, "cpu"), pb.req[b], pb.valid[b], pb.min_avail[b],
            pb.queue[b], pb.prio[b], pb.sel_bits[b], pb.sel_impossible[b], pb.tol_bits[b]))
        for field in want._fields:
            w = np.asarray(getattr(want, field))
            g = np.asarray(getattr(got, field))
            assert g.dtype == w.dtype and g.shape == w.shape, (field, b, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{field} gang {b}")


def _gap_rows(T, seed):
    rng = np.random.default_rng(seed)
    rows = rng.choice(3 * T + 100, T, replace=False).astype(np.int32)
    rows[-1] = 2**31 - 7  # the row part wraps in int32
    return rows


@pytest.mark.parametrize("T,N,seed", [(64, 512, 0), (37, 301, 1), (8, 5, 2)])
def test_k1_plain_at_rows_matches_full_matrix_best_node(T, N, seed):
    """K1's plain version at explicit rows is the JAX probe's head: the
    masked plane's ``_best_node`` over ``tie_break_hash_rows(rows, n)``."""
    from kube_batch_tpu.ops.assignment import _best_node as jax_best_node
    from kube_batch_tpu.ops.assignment import tie_break_hash_rows as jax_hash_rows
    from kube_batch_tpu.ops.feasibility import fits as jax_fits

    inp = k1_inputs(T, N, seed)
    rows = _gap_rows(T, seed)
    fit_idle = np.asarray(jax_fits(inp["task_req"], inp["idle"], inp["quanta"]))
    fit_rel = np.asarray(jax_fits(inp["task_req"], inp["releasing"], inp["quanta"]))
    masked = np.where(inp["static_ok"] & inp["pending"][:, None] & (fit_idle | fit_rel),
                      inp["score"], kernels.NEG).astype(np.float32)
    want_best, want_has = jax_best_node(masked, jax_hash_rows(rows, np.arange(N, dtype=np.int32)))
    best, val, _hash, chose = masked_best_node_raw_plain(
        **_torch(inp, "cpu"), rows=torch.from_numpy(rows))
    np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
    np.testing.assert_array_equal((val > kernels.NEG).numpy(), np.asarray(want_has))
    np.testing.assert_array_equal(val.numpy(), masked.max(axis=1))
    np.testing.assert_array_equal(chose.numpy(),
                                  fit_idle[np.arange(T), np.asarray(want_best)])


def test_k1_plain_contiguous_rows_equal_t0():
    """Rows t0 + arange(T) give exactly the ``t0`` path."""
    inp = _torch(k1_inputs(40, 200, seed=4), "cpu")
    t0 = 1234
    a = masked_best_node_raw_plain(**inp, t0=t0, n0=9)
    b = masked_best_node_raw_plain(**inp, n0=9, rows=torch.arange(40, dtype=torch.int32) + t0)
    _assert_same(a, b, K1_OUT)


def test_k1_wrapper_on_cpu_takes_plain_with_rows():
    """On CPU tensors the wrapper is the plain version (no launch)."""
    inp = _torch(k1_inputs(16, 64, seed=5), "cpu")
    rows = torch.from_numpy(_gap_rows(16, 5))
    before = dict(kernels.launches)
    _assert_same(masked_best_node_raw(**inp, rows=rows),
                 masked_best_node_raw_plain(**inp, rows=rows), K1_OUT)
    assert kernels.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,seed", [(64, 5120, 0), (37, 301, 1), (1, 31, 2)])
def test_k1_kernel_at_rows_matches_plain(cuda_device, T, N, seed):
    """Rows with gaps and beyond any task axis, on ordinary inputs and on
    the tie fixture (every pick decided by the hash or the node index)."""
    rows = torch.from_numpy(_gap_rows(T, seed))
    for inp in (k1_inputs(T, N, seed), k1_tie_inputs(T, N)):
        dev_inp = _torch(inp, cuda_device)
        want = masked_best_node_raw_plain(**dev_inp, rows=rows.to(cuda_device))
        before = kernels.launches["masked_best_node_raw"]
        got = masked_best_node_raw(**dev_inp, rows=rows.to(cuda_device))
        torch.cuda.synchronize()
        assert kernels.launches["masked_best_node_raw"] == before + 1
        _assert_same(got, want, K1_OUT)


@pytest.mark.cuda
def test_probe_solve_card_matches_cpu(cuda_device):
    """The whole probe on the card (K1 at the probe's rows) equals the CPU's
    (the plain version), every field."""
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig
    from kube_batch_tpu_torch.ops.eviction import EvictConfig
    from kube_batch_tpu_torch.ops.probe import probe_batch_from_numpy, probe_solve

    snap = snapshot("full")
    batch, rows = probe_batch(snap, seed=9)
    out = {}
    for dev in ("cpu", cuda_device):
        out[str(dev)] = probe_solve(
            snapshot_from_numpy(snap, dev), probe_batch_from_numpy(batch, dev),
            torch.from_numpy(rows).to(dev), AllocateConfig(),
            EvictConfig(mode="preempt", victim_gang=False), True)
    for field, a, b in zip(out["cpu"]._fields, out["cpu"], out[str(cuda_device)]):
        np.testing.assert_array_equal(a.numpy(), b.cpu().numpy(), err_msg=field)
