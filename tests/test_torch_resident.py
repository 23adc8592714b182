"""The port's device-resident snapshot (``api/resident.py`` and the column
store's feature cache), on the CPU.

After every churn cycle each resident tensor, per-cycle fields and
ingest-static features alike, must equal a fresh upload of the host
snapshot, and the scatter path must engage.  Fed the same events, every
swap must make the JAX package's decisions: the same full uploads,
scatters and clean hits, the same ``bytes_*`` counters and the same
changed rows.  A CPU resident tensor must be a copy, never the column
store's memory; axis growth must take a full upload; and the feature
versions must move with node labels, taints and new pods.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import kube_batch_tpu.api.resident as jax_resident
import kube_batch_tpu_torch.api.pod as ppod
from kube_batch_tpu.framework.conf import load_scheduler_conf as jax_load_conf
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.api.columns import ColumnStore, resident_snap
from kube_batch_tpu_torch.api.convert import host_field
from kube_batch_tpu_torch.api.resident import PER_CYCLE_FIELDS, scatter_summary
from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.framework.conf import (
    DEFAULT_CONF,
    load_scheduler_conf,
    parse_scheduler_conf,
    shipped_conf_path,
)
from kube_batch_tpu_torch.framework.session import close_session, open_session
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_cycle import apply
from test_torch_delta import (
    GiB,
    JAX,
    PORT,
    Churner,
    both_clusters,
    feed,
    port_cluster,
    run_actions,
)
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

CPU = torch.device("cpu")
#: realistic capacities: with tiny columns the cache rightly prefers whole
#: re-uploads to the smallest slot bucket, and no scatter would run; the
#: node axis stays at 128, below the JAX package's sharding threshold
RESERVE = dict(n_tasks=2048, n_nodes=128, n_jobs=512)


def assert_fresh(snap, out, where: str) -> None:
    """Every tensor of ``out`` equals a fresh upload of ``snap``'s field."""
    for name in DeviceSnapshot._fields:
        want = torch.from_numpy(host_field(name, getattr(snap, name)).copy())
        got = getattr(out, name)
        assert got.dtype == want.dtype and torch.equal(got, want), f"{where}: {name}"


def churned_cache(seed: int):
    cache = port_cluster()
    cache.columns.reserve(**RESERVE)
    churn = Churner(cache, np.random.default_rng(seed), PORT)
    for _ in range(3):
        feed(cache, churn.add_gang())
    return cache, churn


def test_resident_tensors_round_trip_under_churn():
    """(a) each cycle's swap equals a fresh upload, field by field, and the
    scatter path engaged."""
    cache, churn = churned_cache(5)
    conf = parse_scheduler_conf(DEFAULT_CONF)
    actions = Scheduler(cache, conf=conf, device="cpu").actions
    cols = cache.columns
    for cycle in range(8):
        feed(cache, churn.step())
        ssn = open_session(cache, conf.tiers, "cpu")
        try:
            snap, _ = cols.device_snapshot(ssn)
            assert_fresh(snap, resident_snap(cols, snap, "cpu"), f"cycle {cycle}")
            run_actions(actions, ssn)
        finally:
            close_session(ssn)
    counters = cols.resident_counters()["single"]
    assert counters["scatter_updates"] > 0, counters
    assert counters["clean_hits"] > 0, counters
    summary = scatter_summary(cols.resident_counters())["single"]
    assert 0.0 < summary["upload_reduction"] < 1.0
    assert counters["bytes_shipped"] < counters["bytes_if_full"]


@pytest.mark.parametrize("seed", [5, 9])
def test_swaps_decide_like_jax(seed, monkeypatch):
    """(b) every swap of a shipped-conf cycle, in both packages on the same
    events: equal counters and delta records."""
    jax_swaps, port_swaps = [], []
    jax_swap = jax_resident.PerCycleDeviceCache.swap

    def recording_swap(self, snap):
        before = self.version
        out = jax_swap(self, snap)
        if self.version != before:
            jax_swaps.append((self.counters(), dict(self.delta_record)))
        return out

    monkeypatch.setattr(jax_resident.PerCycleDeviceCache, "swap", recording_swap)
    jcache, pcache = both_clusters()
    jcache.columns.reserve(**RESERVE)
    pcache.columns.reserve(**RESERVE)
    jsched = JaxScheduler(jcache, conf=jax_load_conf(shipped_conf_path()))
    psched = Scheduler(pcache, conf=load_scheduler_conf(shipped_conf_path()), device="cpu")
    pcols = pcache.columns

    def on_swap(snap, out):
        pc = pcols._per_cycle_dev[CPU]
        port_swaps.append((pc.counters(), dict(pc.delta_record)))

    pcols.on_swap = on_swap
    churn = Churner(jcache, np.random.default_rng(seed), JAX)
    for _ in range(3):
        apply(jcache, pcache, churn.add_gang())
    for cycle in range(10):
        apply(jcache, pcache, churn.step())
        jsched.run_once()
        psched.run_once()
        assert len(port_swaps) == len(jax_swaps), f"cycle {cycle}: swap counts"
    assert len(port_swaps) >= 5
    for i, ((pc, prec), (jc, jrec)) in enumerate(zip(port_swaps, jax_swaps)):
        assert {k: pc[k] for k in jc} == jc, f"swap {i}: counters"
        assert prec.keys() == jrec.keys(), f"swap {i}: changed fields"
        for field, rows in jrec.items():
            assert (rows is None) == (prec[field] is None), f"swap {i}: {field}"
            if rows is not None:
                np.testing.assert_array_equal(prec[field], rows)
    assert port_swaps[-1][0]["scatter_updates"] > 0
    jcache.stop()


def test_cpu_resident_tensors_do_not_alias_the_columns():
    """(c) writing a host column after a swap leaves the resident tensor as
    it was until the next swap, and the mirror is a copy too."""
    cache, _churn = churned_cache(3)
    conf = parse_scheduler_conf(DEFAULT_CONF)
    cols = cache.columns
    ssn = open_session(cache, conf.tiers, "cpu")
    try:
        snap, _ = cols.device_snapshot(ssn)
        out = resident_snap(cols, snap, "cpu")
        row = int(np.flatnonzero(cols.t_valid)[0])
        status_before = int(out.task_status[row])
        req_before = out.task_req[row].clone()
        cols.t_status[row] = 77
        cols.t_init32[row] += 1.0
        assert int(out.task_status[row]) == status_before
        assert torch.equal(out.task_req[row], req_before)
        pc = cols._per_cycle_dev[CPU]
        assert not np.shares_memory(pc._mirror["task_status"], cols.t_status)
        assert not np.shares_memory(out.task_status.numpy(), cols.t_status)
        assert not np.shares_memory(out.task_req.numpy(), cols.t_init32)
        snap2, _ = cols.device_snapshot(ssn)
        out2 = resident_snap(cols, snap2, "cpu")
        assert int(out2.task_status[row]) == 77      # scattered in place
        assert out2.task_status is out.task_status
        assert pc.delta_record["task_status"].tolist() == [row]
    finally:
        cols.t_status[row] = status_before
        cols.t_init32[row] -= 1.0
        close_session(ssn)


def test_axis_growth_uploads_in_full_then_scatters_resume(monkeypatch):
    """(d) a grown task axis re-uploads its columns in full, the next swap
    scatters again; KB_DEVICE_CACHE=0 uploads the snapshot on every call
    and keeps no resident cache."""
    cache, churn = churned_cache(8)
    conf = parse_scheduler_conf(DEFAULT_CONF)
    cols = cache.columns

    def one_swap(events):
        feed(cache, events)
        ssn = open_session(cache, conf.tiers, "cpu")
        try:
            snap, _ = cols.device_snapshot(ssn)
            out = resident_snap(cols, snap, "cpu")
            assert_fresh(snap, out, "swap")
            return dict(cols._per_cycle_dev[CPU].delta_record), out
        finally:
            close_session(ssn)

    one_swap([])
    record, _ = one_swap(churn.add_gang(size=2))
    assert record and all(v is not None for v in record.values())
    cols.reserve(n_tasks=2 * cols.tasks.cap)
    record, _ = one_swap([])
    task_fields = [f for f in PER_CYCLE_FIELDS if f.startswith("task_")]
    assert all(record[f] is None for f in task_fields), record
    scatters = cols._per_cycle_dev[CPU].scatter_updates
    record, _ = one_swap(churn.add_gang(size=3))
    assert record["task_valid"].size == 3
    assert cols._per_cycle_dev[CPU].scatter_updates > scatters
    monkeypatch.setenv("KB_DEVICE_CACHE", "0")
    cols.drop_resident()
    ssn = open_session(cache, conf.tiers, "cpu")
    try:
        snap, _ = cols.device_snapshot(ssn)
        a, b = resident_snap(cols, snap, "cpu"), resident_snap(cols, snap, "cpu")
        assert a.task_status is not b.task_status
        assert_fresh(snap, a, "KB_DEVICE_CACHE=0")
        assert cols._per_cycle_dev == {} and cols._dev_cache == {}
    finally:
        close_session(ssn)


def test_feature_versions_track_labels_taints_and_new_pods():
    """(e) a node label change and a taint change re-upload the node
    features, a new pod the task features, each leaving the other axis's
    resident tensors in place."""
    cache, churn = churned_cache(2)
    conf = parse_scheduler_conf(DEFAULT_CONF)
    cols = cache.columns

    def swap():
        ssn = open_session(cache, conf.tiers, "cpu")
        try:
            snap, _ = cols.device_snapshot(ssn)
            out = resident_snap(cols, snap, "cpu")
            assert_fresh(snap, out, "swap")
            return out
        finally:
            close_session(ssn)

    def node(name, **kw):
        return ppod.Node(name=name, allocatable={"cpu": 16000.0, "memory": 64 * GiB,
                                                  "pods": 110.0}, **kw)

    taint = [ppod.Taint("dedicated", "gpu", "NoSchedule")]
    base = swap()
    assert swap().node_label_bits is base.node_label_bits   # nothing moved
    # a new label pair or taint is interned, which re-packs the task
    # bitsets too; n2 interns them, then n1 takes the same pair and taint
    cache.update_node(node("n2", labels={"zone": "z1"}, taints=taint))
    interned = swap()
    assert interned.task_sel_bits is not base.task_sel_bits
    version = cols.node_feature_version
    cache.update_node(node("n1", labels={"zone": "z1"}))
    labelled = swap()
    assert cols.node_feature_version > version
    assert labelled.node_label_bits is not interned.node_label_bits
    assert labelled.task_req is interned.task_req
    cache.update_node(node("n1", labels={"zone": "z1"}, taints=taint))
    tainted = swap()
    assert tainted.node_taint_bits is not labelled.node_taint_bits
    assert tainted.task_tol_bits is labelled.task_tol_bits
    assert int(tainted.node_taint_bits[:, 0].ne(0).sum()) == 2
    task_version = cols.task_feature_version
    feed(cache, churn.add_gang(size=2))
    arrived = swap()
    assert cols.task_feature_version > task_version
    assert arrived.task_req is not tainted.task_req
    assert arrived.node_label_bits is tainted.node_label_bits


def test_device_change_drops_the_other_residency():
    """A cache keeps one device's residency: asking for another device
    starts a fresh cache there (a full upload once)."""
    cols = ColumnStore(port_cluster().spec)
    first = cols.per_cycle_cache(CPU)
    assert cols.per_cycle_cache(CPU) is first
    cols._per_cycle_dev[torch.device("meta")] = object()
    fresh = cols.per_cycle_cache(CPU)
    assert fresh is first and len(cols._per_cycle_dev) == 2
    cols._per_cycle_dev.pop(CPU)
    assert cols.per_cycle_cache(CPU) is not first
    assert list(cols._per_cycle_dev) == [CPU]


def test_failed_swap_raises_and_drops_the_residency(monkeypatch):
    """A scatter that fails raises (no fallback to the host arrays), and the
    next swap starts cold: the mirrors that already recorded the failed
    swap are not trusted."""
    cache, churn = churned_cache(4)
    conf = parse_scheduler_conf(DEFAULT_CONF)
    cols = cache.columns

    def swap():
        ssn = open_session(cache, conf.tiers, "cpu")
        try:
            snap, _ = cols.device_snapshot(ssn)
            return snap, resident_snap(cols, snap, "cpu")
        finally:
            close_session(ssn)

    swap()
    feed(cache, churn.add_gang(size=2))

    def broken(self, *args):
        raise RuntimeError("scatter failed")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "index_copy_", broken)
        with pytest.raises(RuntimeError, match="scatter failed"):
            swap()
    assert cols._per_cycle_dev == {} and cols._dev_cache == {}
    snap, out = swap()
    assert_fresh(snap, out, "after a failed swap")
    assert cols._per_cycle_dev[CPU].full_uploads == len(PER_CYCLE_FIELDS)
