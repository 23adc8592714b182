"""The port's benchmark matrix (``testing/benchmark.py``) against the JAX
package's, on the CPU at the sizes of ``tests/test_benchmark.py``: the
percentiles, the case names in order, each device case's dict (timing keys
left out) and its solve field by field, the overcommit case's evictions and
binds, and the startup case's density sweep.  The Go-loop denominator's
modules are ``tests/test_torch_go_baseline.py``."""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu.ops.assignment import AllocateConfig as JaxAllocateConfig
from kube_batch_tpu.ops.assignment import allocate_solve as jax_allocate_solve
from kube_batch_tpu.ops.scoring import ScoreWeights as JaxScoreWeights
from kube_batch_tpu.testing import benchmark as jax_bench
from kube_batch_tpu.testing.synthetic import (
    synthetic_device_snapshot as jax_synthetic_device_snapshot,
)
from kube_batch_tpu_torch.api.convert import result_to_numpy, snapshot_from_numpy
from kube_batch_tpu_torch.ops import kernels
from kube_batch_tpu_torch.ops.assignment import allocate_solve
from kube_batch_tpu_torch.ops.scoring import ScoreWeights
from kube_batch_tpu_torch.testing import benchmark
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

#: keys a case's dict derives from its clock
TIMING_KEYS = ("p50_ms", "p90_ms", "p99_ms", "pods_per_sec")

#: the device cases' parameter sets at 64 × 16 (build_cases' three kinds)
DEVICE_PARAMS = {
    "plain": {},
    "binpack": {"weights": "binpack"},
    "gpu": {"gpu_task_frac": 0.2, "gpu_node_frac": 0.25},
}


def _untimed(r):
    return {k: v for k, v in r.items() if k not in TIMING_KEYS}


def _case_kw(params, jax_side):
    kw = dict(params)
    if kw.get("weights") == "binpack":
        kw["weights"] = (JaxScoreWeights if jax_side else ScoreWeights)(binpack=1.0)
    return kw


@pytest.mark.parametrize("ms", [
    [1.0, 2.0, 3.0, 4.0],
    [7.25],
    [0.5, 100.0, 3.3, 3.3, 12.0, 0.01, 999.9],
    list(np.linspace(0.1, 50.0, 101)),
])
def test_percentiles_match_jax(ms):
    assert benchmark._percentiles(ms) == jax_bench._percentiles(ms)


def test_build_cases_names_match_jax():
    names = [c.name for c in benchmark.build_cases("cpu")]
    assert names == [c.name for c in jax_bench.build_cases()]
    assert len(names) == 7


def test_target_matches_jax():
    assert benchmark.TARGET_MS == jax_bench.TARGET_MS


@pytest.mark.parametrize("kind", sorted(DEVICE_PARAMS))
def test_device_case_matches_jax(kind):
    params = DEVICE_PARAMS[kind]
    case = benchmark._device_case("tiny", 64, 16, device="cpu",
                                  **_case_kw(params, jax_side=False))
    got = case.run(1)
    want = jax_bench._device_case("tiny", 64, 16,
                                  **_case_kw(params, jax_side=True)).run(1)
    assert set(got) == set(want)
    assert _untimed(got) == _untimed(want)
    assert got["placed"] > 0 and got["p50_ms"] > 0

    # the case's own inputs: the JAX generator's snapshot, solved as the
    # JAX package solves it, every field bit for bit
    fields, meta, config = case.inputs()
    jsnap, jmeta = jax_synthetic_device_snapshot(
        n_tasks=64, n_nodes=16, gang_size=4, n_queues=3,
        gpu_task_frac=params.get("gpu_task_frac", 0.0),
        gpu_node_frac=params.get("gpu_node_frac", 0.25))
    assert (meta.n_tasks, meta.n_nodes) == (jmeta.n_tasks, jmeta.n_nodes)
    for name in jsnap._fields:
        np.testing.assert_array_equal(getattr(fields, name),
                                      np.asarray(getattr(jsnap, name)), err_msg=name)
    jcfg = JaxAllocateConfig(weights=_case_kw(params, jax_side=True).get(
        "weights", JaxScoreWeights()))
    want_res = jax.device_get(jax_allocate_solve(jsnap, jcfg))
    got_res = result_to_numpy(allocate_solve(snapshot_from_numpy(fields, "cpu"), config))
    for name in want_res._fields:
        w, g = np.asarray(getattr(want_res, name)), getattr(got_res, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int((got_res.assigned[: meta.n_tasks] >= 0).sum()) == want["placed"]


def test_overcommit_case_matches_jax():
    got = benchmark._overcommit_case("tiny", n_running=40, n_pending=16,
                                     n_nodes=8, device="cpu").run(1)
    want = jax_bench._overcommit_case("tiny", n_running=40, n_pending=16,
                                      n_nodes=8).run(1)
    assert _untimed(got) == _untimed(want)
    # q1's pending gangs must trigger cross-queue reclaim of q0's running pods
    assert got["evicted"] > 0 and got["p50_ms"] > 0


def test_startup_latency_case_tiny():
    r = benchmark._startup_latency_case(
        "tiny", n_latency_pods=30, n_nodes=4, batch=10, gang_size=4,
        period=0.02, device="cpu").run(1)
    assert r["scheduled"] == r["pods"] == 34
    assert r["nodes"] == 4 and r["p50_ms"] > 0


def test_cases_default_to_cuda(monkeypatch):
    """No case falls back to the CPU: without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for case in (benchmark._device_case("tiny", 64, 16),
                 benchmark._overcommit_case("tiny", 40, 16, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            case.run(1)


def test_main_prints_a_line_per_case_and_the_summary(monkeypatch, capsys):
    tiny = [benchmark._device_case("tiny", 64, 16, device="cpu"),
            benchmark._overcommit_case("oc", 40, 16, 8, device="cpu")]
    seen = []
    monkeypatch.setattr(benchmark, "build_cases",
                        lambda device: seen.append(device) or tiny)
    benchmark.main(["--cycles", "1", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert seen == ["cpu"]
    assert [ln.get("config") for ln in lines[:2]] == ["tiny", "oc"]
    assert lines[2]["summary"] == "baseline_config_matrix" and lines[2]["configs"] == 2


@pytest.mark.cuda
def test_device_case_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    kernels.reset_launches()
    r = benchmark._device_case("tiny", 64, 16, device="cuda").run(1)
    assert r["placed"] > 0
    assert kernels.launches["masked_best_node_raw"] > 0
    cpu = benchmark._device_case("tiny", 64, 16, device="cpu").run(1)
    assert _untimed(r) == _untimed(cpu)
