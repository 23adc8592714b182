"""The 50k simulator drive's function (``testing/sim_drive.py``) rehearsed on
the CPU at a small width — 128 nodes, 400 gangs of 4 arriving over the
first 5 virtual seconds, 16 cycles — and held against the JAX package's
``SimRunner`` on the same ``SimConfig`` (single-device, ``KB_SHARD=0``):
the same binds in the same order (``bind_digest``) and the same trace
(``trace_sha256``).  The port's two legs, the defaults and
``KB_WARM=0``, must bind identically; the defaults leg runs compacted
cycles with the carried table.  At 200 nodes (padded past the shard
gate) the JAX package's default sharded run and the port's run on an
8-shard CPU mesh bind and trace alike, with equal ``solve_collectives``."""

from __future__ import annotations

import dataclasses

import pytest

from kube_batch_tpu.sim import SimConfig as JaxSimConfig
from kube_batch_tpu.sim import SimRunner as JaxSimRunner
from kube_batch_tpu_torch.testing.sim_drive import DriveRunner, drive_config, drive_sim
from test_torch_sim_parity import environ, fresh_jax_caches  # noqa: F401
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

NODES, GANGS, CYCLES = 128, 400, 16


def test_drive_matches_jax_and_its_legs_agree():
    out = drive_sim(NODES, GANGS, CYCLES, device="cpu")
    legs = out["legs"]
    defaults = legs["defaults"]["report"]
    assert defaults["bind_digest"] == legs["cold"]["report"]["bind_digest"]
    assert defaults["topk"]["compacted_cycles"] > 0
    assert defaults["warm"]["warm_cycles"] > defaults["warm"]["cold_builds"]
    assert legs["cold"]["report"]["warm"]["warm_cycles"] == 0
    assert defaults["jobs"]["started"] == GANGS
    cycles = legs["defaults"]["cycles"]
    assert len(cycles) == CYCLES
    assert [c["topk"] is not None for c in cycles].count(True) == \
        defaults["topk"]["compacted_cycles"]
    # the CPU path counts no launches (the plain versions run)
    assert all(v == 0 for v in legs["defaults"]["launches"].values())

    cfg = drive_config(NODES, GANGS, CYCLES)
    jcfg = JaxSimConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    with environ(KB_SHARD="0"):
        want = JaxSimRunner(jcfg).run()
    assert want["bind_digest"] == defaults["bind_digest"]
    assert want["trace_sha256"] == defaults["trace_sha256"]
    assert want["topk"] == defaults["topk"] and want["warm"] == defaults["warm"]
    assert want["wait_vt"] == defaults["wait_vt"]
    assert want["pod_bind_latency_vt"] == defaults["pod_bind_latency_vt"]


def test_drive_runner_records_every_cycle():
    cfg = drive_config(64, 60, 6)
    runner = DriveRunner(cfg, device="cpu")
    report = runner.run()
    assert [c["t"] for c in runner.cycle_log] == [float(i) for i in range(6)]
    assert sum(c["trace_lines"] for c in runner.cycle_log) + 64 + 3 == report["trace_events"]
    assert all(c["wall_ms"] >= c["scheduler_ms"] > 0 for c in runner.cycle_log)
    # the split covers the cycle: events applied, run_once, kubelet, sample
    split = ("apply_ms", "run_once_ms", "kubelet_ms", "sample_ms")
    for c in runner.cycle_log:
        assert all(c[k] >= 0 for k in split)
        assert c["run_once_ms"] >= c["scheduler_ms"]
        assert sum(c[k] for k in split) == pytest.approx(c["wall_ms"], rel=1e-6)
    assert sum(c["apply_ms"] for c in runner.cycle_log) > 0
    assert [(c["pending"], c["running"]) for c in runner.cycle_log] == [
        (rec["pending"], rec["running"]) for rec in report["fairness_series"]]


def test_sharded_drive_matches_jax():
    """The drive's scenario at 200 nodes (the node axis pads to 256, past
    the shard gate), the JAX package at its default (its sharded path on
    the 8-device CPU mesh) and the port's ``SimRunner(mesh=...)`` on an
    8-shard CPU mesh: the same binds, the same trace, and the report's
    ``solve_collectives`` equal."""
    from kube_batch_tpu_torch.parallel.mesh import make_mesh
    from kube_batch_tpu_torch.sim import SimRunner

    cfg = drive_config(200, 60, 3)
    report = SimRunner(cfg, device="cpu", mesh=make_mesh(["cpu"] * 8)).run()
    jcfg = JaxSimConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    want = JaxSimRunner(jcfg).run()
    assert "sharded" in want["resident_scatter"] and "sharded" in report["resident_scatter"]
    assert want["bind_digest"] == report["bind_digest"]
    assert want["trace_sha256"] == report["trace_sha256"]
    assert report["solve_collectives"] == want["solve_collectives"]
    assert report["solve_collectives"]["per_round_bytes"] > 0
