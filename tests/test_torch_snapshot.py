"""The port's snapshot against the JAX package's: the synthetic generator
field by field, the numpy ↔ tensor conversion, the import boundary (the
port loads neither jax nor kube_batch_tpu), and the no-fallback device
rule.  Every comparison is bit-exact."""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from kube_batch_tpu.ops.assignment import AllocateConfig as JaxAllocateConfig
from kube_batch_tpu.ops.scoring import ScoreWeights as JaxScoreWeights
from kube_batch_tpu.testing.synthetic import (
    synthetic_device_snapshot as jax_synthetic_device_snapshot,
)
from kube_batch_tpu_torch.api.convert import (
    config_from_fields,
    snapshot_from_numpy,
    snapshot_to_numpy,
)
from kube_batch_tpu_torch.api.snapshot import BITSET_FIELDS, DeviceSnapshot, bucket
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.ops.assignment import AllocateConfig
from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("kw", [
    dict(n_tasks=300, n_nodes=40, seed=0),
    dict(n_tasks=300, n_nodes=40, seed=5),
    dict(n_tasks=500, n_nodes=70, n_queues=3, gpu_task_frac=0.3, seed=2),
])
def test_synthetic_snapshot_matches_jax(kw):
    ref, ref_meta = jax_synthetic_device_snapshot(**kw)
    snap, meta = synthetic_device_snapshot(**kw, device="cpu")
    assert DeviceSnapshot._fields == type(ref)._fields
    for name in DeviceSnapshot._fields:
        want = np.asarray(getattr(ref, name))
        got = getattr(snap, name).numpy()
        if name in BITSET_FIELDS:
            assert want.dtype == np.uint32 and got.dtype == np.int32, name
            want = want.view(np.int32)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert meta.shape == ref_meta.shape
    assert meta.task_keys == ref_meta.task_keys
    assert meta.node_names == ref_meta.node_names


def test_bucket_matches_jax():
    from kube_batch_tpu.api.snapshot import bucket as jax_bucket

    for n in (0, 1, 7, 8, 9, 100, 4096, 4097, 5000, 50_000, 123_457):
        assert bucket(n) == jax_bucket(n)


def test_snapshot_from_numpy_round_trips():
    ref, _ = jax_synthetic_device_snapshot(n_tasks=64, n_nodes=16,
                                           gpu_task_frac=0.5, seed=3)
    # high bits set in the u32 bitsets: the int32 view must carry them
    ref = ref._replace(
        task_sel_bits=np.full_like(ref.task_sel_bits, 0x80000001),
        node_label_bits=np.full_like(ref.node_label_bits, 0xFFFFFFFF),
        node_taint_bits=np.full_like(ref.node_taint_bits, 0x80000000),
    )
    snap = snapshot_from_numpy(ref, "cpu")
    assert snap.task_sel_bits.dtype == torch.int32
    assert int(snap.task_sel_bits[0, 0]) == -(2**31) + 1
    assert snap.task_valid.dtype == torch.bool
    back = snapshot_to_numpy(snap)
    for name in DeviceSnapshot._fields:
        want = np.asarray(getattr(ref, name))
        got = getattr(back, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # a mapping converts like the NamedTuple
    snap2 = snapshot_from_numpy(ref._asdict(), "cpu")
    for a, b in zip(snap, snap2):
        assert torch.equal(a, b)


def test_config_from_fields_drops_use_pallas():
    jcfg = JaxAllocateConfig(rounds=4, outer=2, drf=False, use_pallas=True,
                             topk=8, weights=JaxScoreWeights(binpack=2.0))
    cfg = config_from_fields(jcfg)
    assert isinstance(cfg, AllocateConfig)
    assert cfg.rounds == 4 and cfg.outer == 2 and not cfg.drf and cfg.topk == 8
    assert cfg.weights.binpack == 2.0
    assert not hasattr(cfg, "use_pallas")
    assert config_from_fields(JaxAllocateConfig()) == AllocateConfig()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every port module, running a CPU solve and two five-action
    cycles under the shipped conf (reclaim evicting; the second open a
    delta, its device programs reading resident tensors; the guard on),
    then starting and stopping a pipelined ``run_forever`` that binds an
    arrival, then the feature paths — a PV ledger, PDB gangs and a custom
    score row through the feature drive's exclusive and isolated cycles,
    and ``build_snapshot`` of a ``cache.snapshot()`` — then the read plane
    (a query plane whose batcher thread answers one what-if request,
    evictions on, after one cycle published its lease), then a follower
    that applies a leader's replication frames and answers a probe from
    them leaves no jax, no
    kube_batch_tpu and no yaml module loaded (kube_batch_tpu_torch itself
    shares the prefix, so the match is exact on the package name)."""
    code = textwrap.dedent("""
        import sys
        import threading
        import kube_batch_tpu_torch.actions.allocate as A
        import kube_batch_tpu_torch.api.resident
        import kube_batch_tpu_torch.cache.dirty
        import kube_batch_tpu_torch.cache.resync
        import kube_batch_tpu_torch.k8s.transport
        import kube_batch_tpu_torch.replicate.stream
        import kube_batch_tpu_torch.utils.worker
        import kube_batch_tpu_torch.guard.bundle
        import kube_batch_tpu_torch.ops.invariants
        import kube_batch_tpu_torch.ops.kernels
        import kube_batch_tpu_torch.ops._build
        import kube_batch_tpu_torch.testing.cycle_drive
        import kube_batch_tpu_torch.testing.kernel_bench
        from kube_batch_tpu_torch.framework.conf import (
            load_scheduler_conf, shipped_conf_path)
        from kube_batch_tpu_torch.ops.assignment import AllocateConfig
        from kube_batch_tpu_torch.scheduler import Scheduler
        from kube_batch_tpu_torch.testing.synthetic import (
            synthetic_cluster, synthetic_device_snapshot, synthetic_overcommit_cluster)
        snap, meta = synthetic_device_snapshot(64, 8, device="cpu")
        res, mode, info, _g = A.dispatch_allocate_solve(snap, AllocateConfig())
        assert len(A.result_binds(res, meta)) > 0
        cache = synthetic_overcommit_cluster(n_running=64, n_pending=32, n_nodes=8)
        sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()),
                          device="cpu")
        assert [a.name for a in sched.actions] == [
            "enqueue", "reclaim", "allocate", "backfill", "preempt"]
        sched.run_once()
        assert len(cache.evictor.evicts) > 0
        for key in list(cache.evictor.evicts):
            cache.delete_pod(cache.pods[key])
        sched.run_once()
        assert cache.last_open_path == "delta"
        assert cache.columns.resident_counters()["single"]["version"] > 0
        assert cache.guard_plane.enabled and cache.guard_plane.trips_total == 0
        loop_cache = synthetic_cluster(64, 8)
        loop = Scheduler(loop_cache, conf=load_scheduler_conf(shipped_conf_path()),
                         schedule_period=0.05, device="cpu")
        assert loop.pipelined
        t = threading.Thread(target=loop.run_forever, daemon=True)
        t.start()
        try:
            assert loop_cache.binder.event.wait(30)
        finally:
            loop.stop()
            t.join(30)
        assert not t.is_alive() and loop._wb_future is None
        assert loop_cache._ingest_staged == [] and loop.wake_reasons["floor"] >= 0
        import kube_batch_tpu_torch.cache.volume
        from kube_batch_tpu_torch.api.snapshot import build_snapshot
        from kube_batch_tpu_torch.testing.cycle_drive import drive_features
        r = drive_features(256, 32, 16, 2, pdb_gang_frac=0.2, device="cpu",
                           hold_first=True)
        assert [c["session"] for c in r["cycles"]] == ["exclusive", "exclusive", "isolated"]
        assert r["cycles"][0]["checks"]["bound_pods_with_claims"] > 0
        assert r["cycles"][-1]["clone_ms"] > 0 and r["held"]["K1"]["max_abs_err"] == 0.0
        assert r["cycles"][-1]["new_binds"] > 0
        fsnap, fmeta = build_snapshot(synthetic_cluster(64, 8).snapshot())
        assert fmeta.n_tasks == 64 and fsnap.task_pending.sum() == 64
        import kube_batch_tpu_torch.ops.probe
        import kube_batch_tpu_torch.serve.batcher
        import kube_batch_tpu_torch.serve.lease
        from kube_batch_tpu_torch.serve import QueryPlane
        wcache = synthetic_cluster(64, 8)
        qp = QueryPlane(wcache, max_batch=4, window_s=0.001, prewarm=True)
        try:
            wsched = Scheduler(wcache, conf=load_scheduler_conf(shipped_conf_path()),
                               device="cpu")
            wsched.run_once()
            resp = qp.submit({"queue": "q0", "count": 2, "evictions": True,
                              "requests": {"cpu": 250, "memory": 2**30}}).result(60)
            assert resp["feasible"] and resp["snapshot_version"] > 0
            assert qp.dispatches == 1 and qp.requests_served == 1
        finally:
            qp.close()
        from kube_batch_tpu_torch.replicate import (
            FollowerCache, ReplicationFollower, ReplicationPublisher)
        rcache = synthetic_cluster(64, 8)
        rqp = QueryPlane(rcache, start_thread=False)
        rcache.replication = pub = ReplicationPublisher()
        rsched = Scheduler(rcache, conf=load_scheduler_conf(shipped_conf_path()),
                           device="cpu")

        class Loopback:
            def get_bytes(self, path, timeout=60):
                return pub.record_for(int(path.rsplit("since=", 1)[1]))

        fcache = FollowerCache()
        fqp = QueryPlane(fcache, start_thread=False)
        try:
            rsched.run_once()
            rsched.drain_pipeline()
            follower = ReplicationFollower("http://unused", cache=fcache, query_plane=fqp,
                                           transport=Loopback(), device="cpu")
            assert follower.run_once() == "applied"
            fut = fqp.submit({"queue": "q0", "count": 2, "evictions": True,
                              "requests": {"cpu": 250, "memory": 2**30}})
            fqp.batcher.tick(now=fqp.batcher.clock.monotonic() + 1e6)
            fresp = fut.result(60)
            assert fresp["staleness"]["seq"] == follower.applier.applied_seq > 0
            assert fqp.dispatches == 1
        finally:
            rsched.close()
            pub.close()
            fqp.close()
            rqp.close()
        bad = sorted(n for n in sys.modules
                     if n in ("jax", "jaxlib", "yaml") or n.startswith(("jax.", "jaxlib.", "yaml."))
                     or n == "kube_batch_tpu" or n.startswith("kube_batch_tpu."))
        print("LOADED", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_device_snapshot(16, 8)
    ref, _ = jax_synthetic_device_snapshot(n_tasks=16, n_nodes=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snapshot_from_numpy(ref)
    assert resolve_device("cpu") == torch.device("cpu")
