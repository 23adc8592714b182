"""The port's Go-loop denominator (``testing/go_baseline.py``,
``testing/go_pass_bench.py``, ``native/go_pass.c``) against the JAX
package's numpy loop, on the CPU: the workload arrays, the numpy loop's
placements (with gangs rolled back), the port's compiled C legs (one
thread and a pool), the micro-benchmark's pick, and the loader's refusal of
a source that does not compile.  The JAX package's C legs are never run
here: its loader rebuilds a library tracked in its own tree."""

from __future__ import annotations

import numpy as np
import pytest

from kube_batch_tpu.testing import go_baseline as jax_go
from kube_batch_tpu_torch import native
from kube_batch_tpu_torch.testing import go_baseline, go_pass_bench
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

#: (tasks, nodes): the JAX test size, and nodes few enough that gangs
#: run out of room and roll back
SIZES = [(256, 64), (256, 8), (600, 12)]


@pytest.mark.parametrize("size", SIZES)
def test_workload_matches_jax(size):
    got = go_baseline._workload(*size, 4, 3)
    want = jax_go._workload(*size, 4, 3)
    assert len(got) == len(want) == 8
    for g, w in zip(got[:6], want[:6]):
        assert isinstance(g, np.ndarray) and g.flags.c_contiguous
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[6:] == want[6:]


def _counting_pass(monkeypatch):
    """Counts the numpy passes that found a node (placements before any
    rollback)."""
    found = [0]
    inner = go_baseline.numpy_inner_pass

    def counted(*a):
        best = inner(*a)
        found[0] += best >= 0
        return best
    monkeypatch.setattr(go_baseline, "numpy_inner_pass", counted)
    return found


@pytest.mark.parametrize("size", SIZES)
def test_numpy_loop_matches_jax(size, monkeypatch):
    req, job, jmin, idle, alloc, quanta, nt, nn = go_baseline._workload(*size, 4, 3)
    found = _counting_pass(monkeypatch)
    got_idle = idle.copy()
    got, gstats = go_baseline.go_loop_allocate(req, job, jmin, got_idle, alloc, quanta)
    want_idle = idle.copy()
    want, wstats = jax_go.go_loop_allocate(req, job, jmin, want_idle, alloc, quanta)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_idle, want_idle)
    assert gstats["placed"] == wstats["placed"] == int((got >= 0).sum())
    if nn < 64:
        # some gang placed members and was rolled back
        assert found[0] > gstats["placed"] and gstats["placed"] < nt


@pytest.mark.parametrize("pooled", [False, True], ids=["single", "pooled"])
@pytest.mark.parametrize("size", SIZES)
def test_native_legs_match_numpy(size, pooled):
    req, job, jmin, idle, alloc, quanta, _nt, _nn = go_baseline._workload(*size, 4, 3)
    want_idle = idle.copy()
    want, wstats = jax_go.go_loop_allocate(req, job, jmin, want_idle, alloc, quanta)
    got_idle = idle.copy()
    got, gstats = go_baseline.go_loop_allocate_native(
        req, job, jmin, got_idle, alloc, quanta, pooled=pooled, threads=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_idle, want_idle)
    assert gstats["placed"] == wstats["placed"]


def test_run_go_baseline_reports_three_agreeing_legs():
    stats = go_baseline.run_go_baseline(256, 8)
    assert not [k for k in stats if k.endswith("_divergence")]
    assert stats["placed"] == stats["native_single_placed"] == stats["native_pooled_placed"]
    assert (stats["n_tasks"], stats["n_nodes"]) == (256, 8)
    assert stats["native_single_ms"] >= 0 and stats["native_pooled_ms"] >= 0


def test_run_go_baseline_reports_divergence_instead_of_a_time(monkeypatch):
    real = go_baseline.go_loop_allocate_native

    def off_by_one(*a, **kw):
        assigned, stats = real(*a, **kw)
        assigned = assigned.copy()
        assigned[0] = -2
        return assigned, stats
    monkeypatch.setattr(go_baseline, "go_loop_allocate_native", off_by_one)
    stats = go_baseline.run_go_baseline(64, 16)
    assert stats["native_single_divergence"] == stats["native_pooled_divergence"] == 1
    assert "native_single_ms" not in stats and "native_pooled_ms" not in stats


def test_measure_picks_what_the_numpy_pass_picks():
    reps = 10
    r = go_pass_bench.measure(256, reps=reps, threads=4)
    assert (r["nodes"], r["reps"], r["threads"]) == (256, reps, 4)
    assert r["numpy_us"] > 0 and r["c_single_us"] > 0 and r["c_pooled_us"] > 0
    assert isinstance(r["floor_holds"], bool)
    # the final rep's request, through the JAX package's numpy pass
    from kube_batch_tpu.testing.synthetic import synthetic_device_snapshot

    snap, meta = synthetic_device_snapshot(n_tasks=64, n_nodes=256, gang_size=4,
                                           n_queues=3, seed=0)
    nn = meta.n_nodes
    idle = np.asarray(snap.node_idle, np.float64)[:nn]
    alloc = np.asarray(snap.node_alloc, np.float64)[:nn]
    req = np.asarray(snap.task_req, np.float64)[(reps - 1) % 64]
    want = jax_go.numpy_inner_pass(req, idle, alloc, np.asarray(snap.quanta, np.float64),
                                   np.maximum(alloc[:, 0], 1.0), np.maximum(alloc[:, 1], 1.0))
    assert r["agreement"] == want
    assert go_pass_bench._numpy_pass is go_baseline.numpy_inner_pass


def test_loader_builds_into_the_build_dir():
    lib = native.load()
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name == native.LIB_NAME
    assert (native.BUILD_DIR / (native.LIB_NAME + ".sha256")).read_text() == \
        native.source_hash()
    assert lib is native.load()
    assert not (native.SRC.parent / native.LIB_NAME).exists()
    assert "-ffp-contract=off" in native.CFLAGS


def test_loader_raises_on_a_broken_source(tmp_path):
    bad = tmp_path / "go_pass.c"
    bad.write_text(native.SRC.read_text() + "\nint broken( { return 0; }\n")
    with pytest.raises(RuntimeError, match="C build failed") as err:
        native.load(src=bad, build_dir=tmp_path / "build")
    assert "error" in str(err.value)
    assert not (tmp_path / "build" / native.LIB_NAME).exists()


def test_loader_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="C build failed"):
        native.load(src=native.SRC, build_dir=tmp_path / "build")


def test_pool_refuses_a_second_init():
    lib = native.load()
    with native.POOL_LOCK:
        native.pool_init(lib, 2)
        try:
            with pytest.raises(RuntimeError, match="pool_init"):
                native.pool_init(lib, 2)
        finally:
            lib.go_pass_pool_shutdown()
