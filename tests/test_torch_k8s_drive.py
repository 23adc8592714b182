"""``chip_smoke.py``'s k8s phase at a small size on the CPU
(``kube_batch_tpu_torch/testing/k8s_drive.py``): the stub apiserver in
its own process, preloaded with ``synthetic_cluster(2 048, 256)`` as
Kubernetes JSON; the ``--master`` server seeded by the watch binds cycle
1 as ``cycle_drive.drive`` does (the same digest), every Binding POST
lands, the echo lands, the headline arrivals created on the stub bind in
compacted cycles, the columns stay consistent,
and at close the watch threads join and the PV ledger's writer and timer
are gone."""

from __future__ import annotations

from kube_batch_tpu_torch.testing.cycle_drive import drive
from kube_batch_tpu_torch.testing.k8s_drive import drive_k8s
from kube_batch_tpu_torch.testing.server_drive import bindings_digest
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

TASKS, NODES, ARRIVALS = 2048, 256, 512


def test_k8s_drive_binds_cycle1_as_the_headline_drive():
    # cycle 1 comes before any arrival: the reference drive needs none
    ref = drive(TASKS, NODES, 0, device="cpu", keep_states=True)
    want = bindings_digest(ref["states"][0]["binds"])
    r = drive_k8s(TASKS, NODES, ARRIVALS, device="cpu")
    assert r["device"] == "cpu"
    assert r["cycle1_bindings_digest"] == want
    assert r["binds"]["posts"] == TASKS
    assert r["arrivals_bound"] == ARRIVALS  # every one fits at this size
    assert r["compacted_cycles"] > 0
    assert r["bound"] == {"cache": TASKS + ARRIVALS, "stub": TASKS + ARRIVALS}
    assert r["consistency"]["errors"] == [] and r["failed_cycles"] == 0
    assert r["watch_joined"] and r["ledger_closed"] and r["stub_exit"] == 0
    seed = r["seed"]["resources"]
    assert seed["pods"]["items"] == TASKS and seed["nodes"]["items"] == NODES
    assert seed["pods"]["bytes"] > 0 and r["seed"]["synced_ms"] > 0
    writes = r["status_writes"]["stub_requests"]
    assert writes["PATCH podgroups/status"] >= TASKS // 4
    assert r["arrivals_latency"]["p99_ms"] >= r["arrivals_latency"]["p50_ms"] > 0
