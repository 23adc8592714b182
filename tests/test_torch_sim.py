"""The port's virtual-time simulator (``kube_batch_tpu_torch/sim``) on the
CPU: each test of ``tests/test_sim.py`` on the port, with
``device="cpu"`` — the determinism contract (same seed ⇒ byte-identical
trace), fault convergence, the resync path, the chaos presets, the guard
plane's corruption preset end to end, trace replay and the CLI — plus the
no-fallback rule of the port's entry points (``device=None`` means CUDA
and raises without a card)."""

from __future__ import annotations

import json

import pytest
import torch

from kube_batch_tpu_torch.sim import SimConfig, SimRunner, preset, run_preset
from kube_batch_tpu_torch.sim.workload import trace_arrivals
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

CPU = "cpu"


class TestSimSmoke:
    def test_smoke_deterministic_and_complete(self, tmp_path):
        """`--seed 7 --preset smoke` twice: byte-identical traces, full
        workload drain, longitudinal percentiles, clean invariants."""
        a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
        r1 = run_preset("smoke", seed=7, trace_path=a, device=CPU)
        r2 = run_preset("smoke", seed=7, trace_path=b, device=CPU)
        assert r1["trace_sha256"] == r2["trace_sha256"]
        assert (tmp_path / "a.jsonl").read_bytes() == (
            tmp_path / "b.jsonl").read_bytes()
        # a different seed is a different run
        assert run_preset("smoke", seed=8, cycles=12, device=CPU)[
            "trace_sha256"] != r1["trace_sha256"]
        # full drain + the longitudinal report
        assert r1["jobs"]["submitted"] > 0
        assert r1["jobs"]["completed"] == r1["jobs"]["submitted"]
        assert r1["jct_vt"]["p50"] > 0 and r1["jct_vt"]["p99"] >= r1["jct_vt"]["p50"]
        assert r1["wait_vt"]["n"] == r1["jobs"]["submitted"]
        assert r1["makespan_vt"] and r1["binds"] > 0
        assert r1["invariants"]["errors"] == []
        # per-queue fairness series: every cycle carries share + entitlement
        series = r1["fairness_series"]
        assert len(series) == r1["cycles_run"]
        for q, rec in series[-1]["queues"].items():
            assert 0.0 <= rec["share"] <= 1.0
            assert 0.0 < rec["entitlement"] < 1.0
        # ... and the same samples are surfaced live through the port's
        # registry as volcano_queue_* gauges (the last cycle's window)
        from kube_batch_tpu_torch.metrics import metrics as M

        rendered = M.render_prometheus()
        for q, rec in series[-1]["queues"].items():
            assert f'volcano_queue_dominant_share{{queue="{q}"}}' in rendered
            assert f'volcano_queue_share_entitlement{{queue="{q}"}}' in rendered
            assert 0.0 <= M.QUEUE_SHARE._values[(q,)] <= 1.0
            assert M.QUEUE_ENTITLEMENT._values[(q,)] == rec["entitlement"]

    def test_trace_replay_reproduces_run(self, tmp_path):
        """A recorded trace's JOB_ARRIVAL events re-drive an identical run."""
        path = str(tmp_path / "rec.jsonl")
        original = run_preset("smoke", seed=7, trace_path=path, device=CPU)
        cfg = preset("smoke", seed=7)
        cfg.arrivals = trace_arrivals(path)
        replay = SimRunner(cfg, device=CPU).run()
        assert replay["trace_sha256"] == original["trace_sha256"]

    def test_cli_emits_json_report(self, capsys):
        from kube_batch_tpu_torch.sim.__main__ import main

        rc = main(["--preset", "smoke", "--seed", "7", "--cycles", "25",
                   "--no-fairness-series"], device=CPU)
        assert rc == 0
        rep = json.loads(capsys.readouterr().out)
        assert rep["metric"] == "sim_smoke_makespan_vt"
        assert rep["unit"] == "virtual_seconds"
        assert "fairness_series" not in rep


class TestSimFaults:
    def test_node_crash_mid_gang_recovers(self):
        r = run_preset("fault", seed=3, device=CPU)
        rec = r["fault_recovery"]
        assert rec["displaced_jobs"], "crash displaced nothing — vacuous run"
        assert rec["recovered"], rec
        assert all(v in ("re-placed", "completed")
                   for v in rec["displaced_jobs"].values()), rec
        assert rec["nodes_still_down"] == []
        assert r["invariants"]["errors"] == []

    def test_reincarnated_pod_ignores_stale_lifecycle_events(self):
        """A crash-lost replica's queued POD_SUCCEEDED must not complete its
        reincarnation early."""
        from kube_batch_tpu_torch.sim.faults import node_crash_script
        from kube_batch_tpu_torch.sim.workload import fixed_gangs

        cfg = SimConfig(
            seed=0, n_nodes=2, node_cpu=8000.0, queues=(("q0", 1),),
            cycles=40, n_jobs=0,
            arrivals=fixed_gangs(t=0.5, n_gangs=1, gang_size=2, cpu=4000.0,
                                 mem=2**30, duration=10.0, queues=("q0",)),
            faults=tuple(node_crash_script(t=2.0, down_for=2.0,
                                           pod_fail_after=1.0)),
        )
        r = SimRunner(cfg, device=CPU).run()
        assert r["fault_recovery"]["recovered"], r["fault_recovery"]
        assert r["jobs"]["completed"] == 1
        assert r["jct_vt"]["p50"] > 12.0, r["jct_vt"]
        assert r["invariants"]["errors"] == []

    def test_injected_bind_failures_converge_via_resync(self):
        r = run_preset("churn", seed=1, device=CPU)
        assert r["bind_failures_injected"] > 0
        assert r["jobs"]["completed"] == r["jobs"]["submitted"]
        assert r["invariants"]["errors"] == []

    def test_preemption_frees_capacity_for_high_priority(self):
        from kube_batch_tpu_torch.sim.workload import fixed_gangs

        arrivals = fixed_gangs(t=0.5, n_gangs=1, gang_size=4, cpu=4000.0,
                               mem=2**30, duration=300.0, queues=("q0",),
                               name_prefix="low")
        arrivals[0].data["min_member"] = 2
        high = fixed_gangs(t=5.0, n_gangs=1, gang_size=1, cpu=4000.0,
                           mem=2**30, duration=5.0, queues=("q0",),
                           name_prefix="high")
        for e in high:
            for t in e.data["tasks"]:
                t["priority"] = 1000
        cfg = SimConfig(
            seed=0, n_nodes=1, node_cpu=16000.0, queues=(("q0", 1),),
            cycles=30, n_jobs=0, arrivals=arrivals + high,
        )
        r = SimRunner(cfg, device=CPU).run()
        assert r["evictions"] >= 1
        assert r["invariants"]["errors"] == []
        assert r["jobs"]["completed"] >= 1

    def test_apiserver_brownout_degrades_without_stalling(self):
        r = run_preset("brownout", seed=2, device=CPU)
        assert r["cycles_run"] >= 16, r["cycles_run"]
        assert r["jobs"]["completed"] == r["jobs"]["submitted"]
        trans = r["transport"]["breaker_transitions"]
        assert trans.get("open", 0) >= 1 and trans.get("half-open", 0) >= 1
        assert r["transport"]["breaker_state"] == "closed"
        assert r["resync"]["parked_by_reason"].get("breaker-open", 0) > 0
        assert r["resync"]["depth"] == 0
        assert r["resync"]["quarantined"] == 0
        assert r["bind_integrity"]["duplicate_binds"] == 0
        assert r["invariants"]["errors"] == []

    def test_bind_storm_no_lost_or_duplicate_binds(self):
        r = run_preset("bind-storm", seed=0, device=CPU)
        assert r["jobs"]["submitted"] == 120
        assert r["jobs"]["completed"] == r["jobs"]["submitted"]
        bi = r["bind_integrity"]
        assert bi["duplicate_binds"] == 0
        assert bi["acked_binds"] == bi["unique_pods_bound"]
        lat = r["pod_bind_latency_vt"]
        assert lat["n"] >= 280 and lat["p99"] < 20.0, lat
        assert r["transport"]["breaker_transitions"].get("open", 0) >= 1
        assert r["invariants"]["errors"] == []

    def test_leader_failover_warm_standby_keeps_resident_cache(self):
        r = run_preset("leader-failover", seed=5, device=CPU)
        assert r["jobs"]["completed"] == r["jobs"]["submitted"]
        fo = r["failover"]
        assert len(fo) == 1
        assert fo[0]["mode"] == "warm", fo
        assert fo[0]["resident_tokens"].get("single", 0) > 0
        assert fo[0]["recovery_cycles"] is not None
        assert fo[0]["recovery_cycles"] <= 20
        assert r["bind_integrity"]["duplicate_binds"] == 0
        assert r["invariants"]["errors"] == []

    def test_corruption_preset_guard_plane_end_to_end(self, tmp_path, monkeypatch):
        """Three resident-device-column corruptions (a zeroed capacity
        word, a NaN score input, a flipped pending bit on a RUNNING row)
        written into the port's resident tensors in place: every one trips
        the sentinel, nothing bad dispatches, the compacted path demotes and
        re-promotes, and the bundle replays on the CPU."""
        monkeypatch.setenv("KB_GUARD_DIR", str(tmp_path))
        r = run_preset("corruption", seed=0, device=CPU)
        g = r["guard"]
        assert g["corruptions_injected"] == 3
        assert g["trips_total"] >= 3
        assert g["failed_closed"] >= 3
        assert r["bind_integrity"]["duplicate_binds"] == 0
        assert r["invariants"]["errors"] == []
        topk = g["paths"]["topk"]
        assert topk["trips"] >= 1 and topk["promotions"] >= 1
        assert topk["state"] == "healthy"
        assert g["chaos_ok"] is True
        assert g["bundles"]
        from kube_batch_tpu_torch.guard.bundle import replay_bundle

        rep = replay_bundle(g["bundles"][0], CPU)
        assert rep["reproduced"] is True
        assert rep["original_report"]["verdict"] >= 1

    def test_chaos_presets_are_seed_deterministic(self):
        a = run_preset("brownout", seed=11, device=CPU)
        b = run_preset("brownout", seed=11, device=CPU)
        assert a["trace_sha256"] == b["trace_sha256"]

    def test_evict_recreates_controller_restores_pending_replica(self):
        from kube_batch_tpu_torch.sim.workload import fixed_gangs

        arrivals = fixed_gangs(t=0.5, n_gangs=1, gang_size=4, cpu=4000.0,
                               mem=2**30, duration=300.0, queues=("q0",),
                               name_prefix="low")
        arrivals[0].data["min_member"] = 2
        high = fixed_gangs(t=5.0, n_gangs=1, gang_size=1, cpu=4000.0,
                           mem=2**30, duration=300.0, queues=("q0",),
                           name_prefix="high")
        for e in high:
            for t in e.data["tasks"]:
                t["priority"] = 1000
        cfg = SimConfig(
            seed=0, n_nodes=1, node_cpu=16000.0, queues=(("q0", 1),),
            cycles=12, n_jobs=0, arrivals=arrivals + high,
            evict_recreates=True,
        )
        runner = SimRunner(cfg, device=CPU)
        r = runner.run()
        assert r["evictions"] >= 1
        assert r["invariants"]["errors"] == []
        low_keys = runner.job_tasks["sim/low000"]
        assert len(low_keys) == 4
        reincarnated = [k for k in low_keys
                        if k in runner.cache.pods
                        and not runner.cache.pods[k].uid.endswith("-r0")]
        assert reincarnated, "no evicted replica was recreated"


def test_entry_points_default_to_cuda(monkeypatch):
    """No silent CPU fallback: without a card, omitting ``device`` raises
    in the runner, the preset entry and the CLI."""
    from kube_batch_tpu_torch.sim.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimRunner(preset("smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_preset("smoke", cycles=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "smoke", "--cycles", "2"])


def test_unknown_preset_raises():
    with pytest.raises(KeyError, match="unknown preset"):
        preset("nope")
