"""The port's mesh residency (``api/resident.ShardedPerCycleDeviceCache``
and ``api/columns.resident_snap`` on a mesh) against the JAX package's
``ShardedPerCycleDeviceCache``.

One seeded sequence of host snapshots — a cold upload, then node-ledger
and status deltas of growing and shrinking width, a delta too wide for the
live per-shard ladder, and a task-axis growth — is swapped through both
caches on 8-shard meshes.  After every swap the counters must be equal
(full uploads, scatters, clean hits, the ``bytes_*`` counts, the churn
EWMA, the live slot ladder and its retargets) and so must the changed-row
record; every placement must equal its slice of the host snapshot, and no
two placements may share memory.  Through the column store, a swap on a
mesh must hand each position tensors equal to a fresh placement and must
drop the single-device residency, and the single-device swap after it
must drop the mesh's."""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu_torch import plugins as _plugins  # noqa: F401 — registers
from kube_batch_tpu_torch.api.convert import host_field
from kube_batch_tpu_torch.api.resident import (
    PER_CYCLE_FIELDS,
    ShardedPerCycleDeviceCache,
    StagedUpload,
    adaptive_ladder,
    all_shard_buckets,
)
from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.parallel import mesh as pm
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """The JAX package's compile caches cleared before and after the module
    (``test_torch_sim_parity``'s docstring has why), and one torch thread
    for the module: the suite runs in several workers at once, and the
    shard loops' small ops gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()
    torch.set_num_threads(threads)


def _snapshots(seed: int = 0):
    """The host sequence: (label, numpy DeviceSnapshot) per swap."""
    from kube_batch_tpu.testing.synthetic import synthetic_device_snapshot

    snap, _ = synthetic_device_snapshot(n_tasks=900, n_nodes=600, gang_size=4,
                                        n_queues=3, seed=seed)
    snap = jax.tree.map(lambda a: np.array(a), snap)
    rng = np.random.default_rng(seed)
    N = snap.node_idle.shape[0]
    out = [("cold", snap)]

    def moved(prev, field, n, scale=0.5):
        arr = getattr(prev, field).copy()
        rows = rng.choice(N if field.startswith("node") else arr.shape[0], n, replace=False)
        if arr.dtype == bool:
            arr[rows] = ~arr[rows]
        elif field == "task_status":
            arr[rows] = (arr[rows] + 1) % 3
        else:
            arr[rows] = arr[rows] * scale + 1000.0
        return prev._replace(**{field: arr})

    cur = snap
    for label, field, n in (("clean", None, 0), ("narrow", "node_idle", 5),
                            ("wide", "node_used", 300), ("wider", "node_idle", 900),
                            ("wider2", "node_releasing", 800), ("status", "task_status", 40),
                            ("narrow2", "node_idle", 3), ("narrow3", "node_used", 3),
                            ("bools", "node_sched", 20)):
        cur = cur._replace() if field is None else moved(cur, field, n)
        out.append((label, cur))
    # an over-ladder per-shard delta: every node row of one ledger
    cur = cur._replace(node_idle=cur.node_idle + 8.0)
    out.append(("every_row", cur))
    # task-axis growth: every task-axis field re-uploads in full
    grown, _ = synthetic_device_snapshot(n_tasks=1500, n_nodes=600, gang_size=4,
                                         n_queues=3, seed=seed)
    grown = jax.tree.map(lambda a: np.array(a), grown)
    out.append(("grown", grown._replace(**{f: getattr(cur, f) for f in (
        "node_idle", "node_releasing", "node_used", "node_valid", "node_sched")})))
    return out


def _port_swap(cache, snap):
    uploads = {d: StagedUpload(d) for d in cache.devices}
    made = cache.stage(snap, uploads)
    for up in uploads.values():
        up.run()
    return {f: made[f]() for f in PER_CYCLE_FIELDS}


def test_sharded_cache_decides_like_jax():
    from kube_batch_tpu.api.resident import ShardedPerCycleDeviceCache as JaxCache
    from kube_batch_tpu.parallel.mesh import make_mesh

    jcache = JaxCache(make_mesh())
    mesh = pm.make_mesh(["cpu"] * 8)
    pcache = ShardedPerCycleDeviceCache(mesh)
    retargets = 0
    for label, snap in _snapshots():
        jcache.swap(snap)
        placed = _port_swap(pcache, snap)
        jc, pc = jcache.counters(), pcache.counters()
        assert {k: pc[k] for k in jc} == jc, f"{label}: {pc} != {jc}"
        assert pcache.delta_record.keys() == jcache.delta_record.keys(), label
        for field, rows in jcache.delta_record.items():
            if rows is None:
                assert pcache.delta_record[field] is None, (label, field)
            else:
                np.testing.assert_array_equal(pcache.delta_record[field], rows, err_msg=label)
        # every placement holds its slice of the host column, in its own memory
        ptrs = set()
        for field in PER_CYCLE_FIELDS:
            host = torch.from_numpy(host_field(field, getattr(snap, field)))
            for place, t in placed[field].items():
                want = (pm.node_slice(field, host, place[1], mesh.node_shards)
                        if isinstance(place, tuple) else host)
                assert torch.equal(t, want), (label, field, place)
                ptrs.add(t.data_ptr())
        assert len(ptrs) == sum(len(v) for v in placed.values()), label
        retargets = pc["ladder_retargets"]
    assert retargets >= 2 and pcache.scatter_updates > 0 and pcache.clean_hits > 0


def test_adaptive_ladder_and_bucket_set_match_jax():
    from kube_batch_tpu.api import resident as jr

    for ewma in (0.0, 3.0, 7.9, 8.0, 40.0, 300.0, 5000.0):
        assert adaptive_ladder(ewma, 1024) == jr.adaptive_ladder(ewma, 1024), ewma
    for cap in (16, 100, 1024):
        assert all_shard_buckets(cap) == jr.all_shard_buckets(cap)


def test_column_store_keys_the_residency_by_mesh():
    """``resident_snap`` on a mesh: each position's tensors equal a fresh
    placement; the mesh residency and the single-device one replace each
    other; the same mesh (an equal object) hits the same cache."""
    from kube_batch_tpu_torch.api.columns import resident_snap
    from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
    from kube_batch_tpu_torch.framework.session import close_session, open_session
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    cache = synthetic_cluster(n_tasks=400, n_nodes=200, seed=1)
    cache.columns.reserve(n_tasks=2048, n_nodes=256, n_jobs=512)
    cols = cache.columns
    conf = load_scheduler_conf(shipped_conf_path())
    ssn = open_session(cache, conf.tiers, "cpu")
    try:
        snap, _ = cols.device_snapshot(ssn)
        mesh = pm.make_mesh(["cpu"] * 8)
        out = resident_snap(cols, snap, mesh)
        fresh = pm.place_snapshot(snap, mesh)
        for a, b in zip(out.shards, fresh.shards):
            for f in DeviceSnapshot._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert resident_snap(cols, snap, pm.make_mesh(["cpu"] * 8)) is out
        assert set(cols.resident_counters()) == {"sharded"}
        single = resident_snap(cols, snap, "cpu")
        assert set(cols.resident_counters()) == {"single"}
        assert single.node_idle.data_ptr() not in {s.node_idle.data_ptr() for s in out.shards}
    finally:
        close_session(ssn)
