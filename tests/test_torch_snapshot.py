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
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

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
    them, then a traced cycle read through the tracer, the Chrome export,
    the alert evaluator and the Prometheus text, then the standalone
    server (every ingest kind, every GET endpoint once, a what-if and a
    sweep over HTTP, its state file saved and loaded), a ``run_follower``
    pulling it over loopback HTTP, and both CLIs against it, then the
    Kubernetes front end (the CRDs applied from their JSON, a ``--master``
    server seeded by the watch from the port's stub apiserver holding its
    Lease while it binds a gang over HTTP, the chip drive's writers), then
    the simulator (the fault preset's node crash, the CLI's smoke run),
    then the multi-device solve (``parallel/``: a sharded solve on a
    4-shard CPU mesh and the dryrun), then the device-program audits
    (``analysis/``: both tiers over the single-device registry on the CPU),
    then ``python -m kube_batch_tpu_torch.analysis --races`` (tiers A and
    D over the package) and the lock checker installed with its
    guarded-access corroborator over a cache two threads touch, then the
    benchmark matrix (a device case) and the Go-loop denominator (its
    numpy and compiled C legs, the per-pass micro-benchmark),
    leaves no jax, no kube_batch_tpu and no yaml module loaded
    (kube_batch_tpu_torch itself shares the prefix, so the match is exact
    on the package name)."""
    code = textwrap.dedent("""
        import sys
        import threading
        import time
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
        from kube_batch_tpu_torch.cache.cache import SchedulerCache
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
        import kube_batch_tpu_torch.metrics as M
        import kube_batch_tpu_torch.obs as O
        from kube_batch_tpu_torch.obs.trace import chrome_trace, validate_chrome_trace
        tcache = synthetic_cluster(64, 8)
        tsched = Scheduler(tcache, conf=load_scheduler_conf(shipped_conf_path()),
                           device="cpu")
        tsched.run_once()
        assert isinstance(tcache.tracer, O.Tracer) and tcache.tracer.enabled
        records = tcache.flight_recorder.records()
        names = [s.name for s in records[-1].spans]
        assert "session_open" in names and "action:allocate" in names
        assert validate_chrome_trace(chrome_trace(records)) == []
        O.alerts_of(tcache).evaluate(tcache.guard_plane)
        assert "volcano_e2e_scheduling_latency_milliseconds_count" in M.render_prometheus()
        import json, urllib.request, urllib.error
        import kube_batch_tpu_torch.cmd.main
        import kube_batch_tpu_torch.testing.replication_smoke
        import kube_batch_tpu_torch.testing.whatif_smoke
        from kube_batch_tpu_torch.cache.persistence import load_state, save_state
        from kube_batch_tpu_torch.cli import queue as queue_cli, whatif as whatif_cli
        from kube_batch_tpu_torch.cmd import options, server as srv
        from kube_batch_tpu_torch.cmd.leader_election import LeaderElector
        from kube_batch_tpu_torch.replicate import follower as fmod
        import tempfile
        tmp = tempfile.mkdtemp()

        def call(port, method, path, body=None):
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                         method=method)
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        leader = srv.StandaloneServer(options.parse(
            ["--listen-address", "127.0.0.1:0", "--state-file", tmp + "/state.json"]),
            device="cpu")
        started = []
        real_start = fmod.ReplicationFollower.start
        fmod.ReplicationFollower.start = lambda self: (started.append(self), real_start(self))
        port = leader.admin.port
        ft = threading.Thread(target=srv.run_follower, args=(options.parse(
            ["--listen-address", "127.0.0.1:0", "--follower", f"http://127.0.0.1:{port}"]),),
            kwargs={"device": "cpu"}, daemon=True)
        try:
            assert call(port, "POST", "/v1/queues", [{"name": "default"}])[0] == 200
            assert call(port, "POST", "/v1/nodes", {"name": "n0", "allocatable": {
                "cpu": 4000.0, "memory": 2.0**33, "pods": 10.0}})[0] == 200
            assert call(port, "POST", "/v1/pods", [{"name": "p0", "namespace": "c1",
                "requests": {"cpu": 500.0}, "phase": "Pending"}])[0] == 200
            for kind, body in (("priorityclasses", {"name": "hi", "value": 5}),
                               ("poddisruptionbudgets", {"name": "b", "owner": "o"}),
                               ("persistentvolumes", {"name": "pv0"}),
                               ("podgroups", {"name": "g", "min_member": 1})):
                assert call(port, "POST", f"/v1/{kind}", body)[0] == 200
            assert call(port, "POST", "/v1/sync", {})[0] == 200
            leader.sched.run_once()
            leader.sched.drain_pipeline()
            for path in ("/metrics", "/healthz", "/version", "/debug/stacks",
                         "/debug/pprof?seconds=0.05", "/v1/queues", "/v1/jobs",
                         "/v1/bindings", "/v1/guard", "/v1/trace", "/v1/trace/dumps",
                         "/v1/trace/dumps/x/meta.json", "/v1/replicate?since=0",
                         "/v1/alerts"):
                assert call(port, "GET", path)[0] in (200, 404), path
            assert call(port, "POST", "/v1/whatif", {"count": 1,
                        "requests": {"cpu": 100}})[0] == 200
            assert call(port, "POST", "/v1/whatif/sweep", {"max_count": 4,
                        "requests": {"cpu": 100}})[0] == 200
            assert call(port, "DELETE", "/v1/persistentvolumes", {"name": "pv0"})[0] == 200
            ft.start()
            head = leader.cache.replication.counters()["head_seq"]
            deadline = time.monotonic() + 60
            while not (started and started[0].applier.applied_seq >= head):
                assert time.monotonic() < deadline, "the follower never caught up"
                time.sleep(0.01)
            url = f"http://127.0.0.1:{port}"
            assert queue_cli.main(["--server", url, "create", "--name", "q9"]) == 0
            assert queue_cli.main(["--server", url, "list"]) == 0
            assert whatif_cli.main(["--server", url, "--count", "1", "--cpu", "100",
                                    "--expect", "feasible"]) == 0
            save_state(leader.cache, tmp + "/copy.json")
            assert load_state(SchedulerCache(), tmp + "/copy.json")
            LeaderElector(tmp, identity="x").release()
        finally:
            if started:
                started[0].stop()
            ft.join(30)
            leader.close()
        assert not ft.is_alive()
        from kube_batch_tpu_torch.testing import e2e, k8s_drive
        from kube_batch_tpu_torch.k8s import pod_from_k8s
        stub = e2e.StubApiServer()
        master = stub.start()
        try:
            kc = e2e.Cluster(master)
            kc.apply_crds()
            with e2e.scheduler_thread(master, device="cpu", extra_args=[
                    "--leader-elect", "--lock-object-namespace", "kube-system"]) as ks:
                kc.ensure_namespace("e2e-gang")
                e2e.scenario_gang(kc, "e2e-gang")
        finally:
            stub.stop()
        assert ks.watcher.join(10)
        p0 = loop_cache.pods[sorted(loop_cache.pods)[0]]
        assert pod_from_k8s(k8s_drive.pod_to_k8s(p0)) == p0
        import contextlib, io
        import kube_batch_tpu_torch.testing.sim_drive
        from kube_batch_tpu_torch.sim import run_preset
        from kube_batch_tpu_torch.sim.__main__ import main as sim_main
        srep = run_preset("fault", seed=0, cycles=12, device="cpu")
        assert srep["fault_recovery"]["displaced_jobs"] and srep["binds"] > 0
        with contextlib.redirect_stdout(io.StringIO()) as sim_out:
            assert sim_main(["--preset", "smoke", "--cycles", "6",
                             "--no-fairness-series"], device="cpu") == 0
        assert '"metric": "sim_smoke_makespan_vt"' in sim_out.getvalue()
        import kube_batch_tpu_torch.parallel.distributed
        from kube_batch_tpu_torch.parallel.mesh import make_mesh, sharded_allocate_solve
        from kube_batch_tpu_torch.testing import dryrun
        mesh = make_mesh(["cpu"] * 4)
        sres = sharded_allocate_solve(synthetic_device_snapshot(
            300, 256, seed=1, device="cpu")[0], AllocateConfig(), mesh)
        assert (sres.assigned >= 0).any()
        assert dryrun.run(4, "cpu")["bucket_5120_equal"]
        from kube_batch_tpu_torch.analysis import memory_audit, program_audit
        runs = {}
        assert program_audit.run_audit(program_audit.REGISTRY, "cpu", runs=runs) == []
        assert memory_audit.run_memory_audit(program_audit.REGISTRY, device="cpu",
                                             runs=runs) == []
        import runpy
        from kube_batch_tpu_torch.analysis import lockdep, races
        sys.argv = ["python -m kube_batch_tpu_torch.analysis", "--races"]
        with contextlib.redirect_stdout(io.StringIO()) as lint_out:
            try:
                runpy.run_module("kube_batch_tpu_torch.analysis", run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, lint_out.getvalue()
        assert "kbt-check: clean" in lint_out.getvalue()
        state = lockdep.install()
        guarded = lockdep.install_guarded_access(
            races.runtime_domain_specs(lockdep.HOT_STRUCTURES), state=state)
        checked = SchedulerCache()
        checked.enable_ingest_staging()
        t = threading.Thread(target=checked.drain_staged_ingest)
        t.start()
        t.join()
        checked.drain_staged_ingest()
        checked.stop()
        guarded.uninstall()
        lockdep.uninstall()
        assert isinstance(checked._lock, lockdep.TrackedLock) and state.violations == []
        import kube_batch_tpu_torch.native
        from kube_batch_tpu_torch.testing import benchmark, go_baseline, go_pass_bench
        assert [c.name for c in benchmark.build_cases("cpu")][0] == "gang_allocate_kubemark"
        assert benchmark._device_case("tiny", 64, 16, device="cpu").run(1)["placed"] > 0
        gb = go_baseline.run_go_baseline(64, 16)
        assert gb["placed"] == gb["native_single_placed"] == gb["native_pooled_placed"]
        assert go_pass_bench.measure(64, reps=4, threads=2)["agreement"] >= 0
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
