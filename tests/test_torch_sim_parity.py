"""The port's simulator against the JAX package's, on the CPU.

Each case runs one preset at one seed through both packages' ``run_preset``
(the JAX side single-device, ``KB_SHARD=0``; the port with
``device="cpu"``), each with its own guard-bundle and flight-dump
directory, and holds the two against each other: the same
``trace_sha256`` and ``bind_digest``, byte-identical JSONL traces, and
every other report field equal but for the differences ROADMAP Queue 3
lists:

- ``stage_attribution.retraces_attributed`` counts the JAX package's jit
  retraces; the port has no jit and reports 0;
- ``guard.verdicts_consumed`` is the port's count of sentinel verdicts
  read, a key the JAX report lacks;
- ``resident_scatter.single.bytes_shipped`` is the port's staged upload's
  own bytes, a key the JAX counters lack;
- the JAX package's resident cache re-swaps at every fit-error histogram
  dispatch (its ``resident_snap`` rebuilds the snapshot tuple, so the
  swap's identity memo never hits) where the port's memo returns the
  solve's tensors: its ``version`` is higher by exactly the
  ``fit_histogram_dispatch`` span count and its ``clean_hits`` by that
  many swaps of every per-cycle field, and its ``bytes_if_full`` and
  ``upload_reduction`` count those swaps too.  Every full upload and
  scatter, and the bytes they move, are equal.

Every file of these runs starts and ends with the JAX package's compile
caches cleared (:func:`fresh_jax_caches`): a simulator run compiles
thousands of executables, each holding memory maps, and one test worker
running several of these files would otherwise pass the kernel's map
limit (65 530), where the compiler crashes.

This file runs every preset of the non-chaos group at seed 0, smoke at
seed 7, and smoke at seed 3 through the pipelined cycle (the staged close
and the writeback worker, retired by ``Scheduler.close``), and compares the metric writes of the smoke run (every series,
the ``volcano_queue_*`` gauges the simulator feeds among them) as
``test_torch_metrics.py`` does: as writes, not as values.  The chaos
presets are ``test_torch_sim_parity_chaos.py``'s, the warm carry's
``test_torch_sim_parity_warm.py``'s.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os

import jax
import pytest

from kube_batch_tpu.sim import run_preset as jax_run_preset
from kube_batch_tpu_torch.api.resident import PER_CYCLE_FIELDS
from kube_batch_tpu_torch.sim import run_preset
from test_torch_metrics import recording
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """Clear the JAX package's compiled executables before and after the
    module (module docstring)."""
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block and restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_side(side: str, root, name: str, seed: int, **kw):
    """One package's run of ``name`` at ``seed``: its report and its trace
    bytes.  Bundles and flight dumps go under ``root/side``."""
    out = root / side
    out.mkdir(parents=True, exist_ok=True)
    trace = str(out / "trace.jsonl")
    with environ(KB_GUARD_DIR=str(out / "guard"), KB_TRACE_DIR=str(out / "flight"),
                 KB_SHARD="0"):
        if side == "jax":
            report = jax_run_preset(name, seed=seed, trace_path=trace, **kw)
        else:
            report = run_preset(name, seed=seed, trace_path=trace, device="cpu", **kw)
    with open(trace, "rb") as f:
        return report, f.read()


def relative(report: dict, root) -> dict:
    """``report`` with its run directory cut out of every path it holds."""
    text = json.dumps(report).replace(str(root), "<run>")
    return json.loads(text)


def comparable(jax_report: dict, port_report: dict):
    """The two reports with the Queue 3 differences checked and taken out
    (module docstring); what is left must be equal."""
    j, p = copy.deepcopy(jax_report), copy.deepcopy(port_report)
    for r in (j, p):
        r.pop("trace_path", None)
    assert p["stage_attribution"].pop("retraces_attributed") == 0
    j["stage_attribution"].pop("retraces_attributed")
    assert "verdicts_consumed" not in j["guard"]
    p["guard"].pop("verdicts_consumed")
    jr, pr = j["resident_scatter"]["single"], p["resident_scatter"]["single"]
    pr.pop("bytes_shipped")
    repeats = p["stage_attribution"]["stages"].get("fit_histogram_dispatch", 0)
    assert jr["version"] - pr["version"] == repeats, (jr, pr, repeats)
    assert jr["clean_hits"] - pr["clean_hits"] == repeats * len(PER_CYCLE_FIELDS)
    if repeats:
        assert jr["bytes_if_full"] > pr["bytes_if_full"]
    else:
        assert jr["bytes_if_full"] == pr["bytes_if_full"]
    for r in (jr, pr):
        for k in ("version", "clean_hits", "bytes_if_full", "upload_reduction"):
            r.pop(k, None)
    return j, p


def assert_same_run(root, name: str, seed: int, **kw):
    """Run ``name`` at ``seed`` on both packages and hold them together;
    returns both reports."""
    jrep, jtrace = run_side("jax", root, name, seed, **kw)
    prep, ptrace = run_side("port", root, name, seed, **kw)
    assert prep["trace_sha256"] == jrep["trace_sha256"]
    assert prep["bind_digest"] == jrep["bind_digest"]
    assert ptrace == jtrace
    assert prep["binds"] > 0
    j, p = comparable(relative(jrep, root / "jax"), relative(prep, root / "port"))
    keys = sorted(set(j) | set(p))
    diff = [k for k in keys if j.get(k) != p.get(k)]
    assert not diff, {k: (j.get(k), p.get(k)) for k in diff}
    return jrep, prep


@pytest.mark.parametrize("name,seed,kw", [
    ("fault", 0, {}), ("churn", 0, {}), ("brownout", 0, {}), ("leader-failover", 0, {}),
    ("smoke", 7, {}), ("smoke", 3, {"pipelined": True}),
], ids=["fault-0", "churn-0", "brownout-0", "leader-failover-0", "smoke-7",
        "smoke-3-pipelined"])
def test_preset_matches_jax(name, seed, kw, tmp_path):
    jrep, prep = assert_same_run(tmp_path, name, seed, **kw)
    assert prep["invariants"]["errors"] == []


def test_smoke_matches_jax_with_its_metric_writes(tmp_path):
    """smoke at seed 0, and every metric write of the two runs: the queue
    share and entitlement gauges the runner sets each cycle
    (``set_queue_shares``) are written alike, once a cycle per queue."""
    with recording() as logs:
        jrep, prep = assert_same_run(tmp_path, "smoke", 0)
    want, got = logs["jax"].summary(), logs["port"].summary()
    assert got == want
    queues = [q for q, _w in prep["config"]["queues"]]
    for gauge in ("volcano_queue_dominant_share", "volcano_queue_share_entitlement"):
        for q in queues:
            n, _last = got["sets"][(gauge, (q,))]
            assert n == prep["cycles_run"]


def test_cli_reports_match_jax(tmp_path, capsys):
    """The two CLIs print the same report, less the Queue 3 differences."""
    from kube_batch_tpu.sim.__main__ import main as jax_main
    from kube_batch_tpu_torch.sim.__main__ import main

    argv = ["--preset", "smoke", "--seed", "3", "--cycles", "12", "--no-fairness-series"]
    with environ(KB_SHARD="0", KB_GUARD_DIR=str(tmp_path / "jax")):
        assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    with environ(KB_GUARD_DIR=str(tmp_path / "port")):
        assert main(argv, device="cpu") == 0
    got = json.loads(capsys.readouterr().out)
    assert "fairness_series" not in got
    assert comparable(want, got)[0] == comparable(want, got)[1]
