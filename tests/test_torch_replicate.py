"""The port's replication stream (``kube_batch_tpu_torch/replicate/``)
against the JAX package's (``kube_batch_tpu/replicate/``), on the CPU.

The KBR1 frame is the contract between the two packages: for the same
record both encode the same bytes, each decodes the other's, and a
follower of either package serves what-ifs from the other's frames with
the leader's answers.  A port follower that has applied the leader's
record for seq N answers every what-if and sweep exactly as the leader's
lease N does: frozen, along the delta chain under churn, across meta
growth, after a gap (resync), a ring fall-off, a reconnect and a warm
restart.

Under a conf whose only swapping action is allocate both packages publish
one record a cycle, and their frames are byte-identical.  Under the
shipped conf they do not publish alike: the port's lease retires at every
swap, the CPU included (ROADMAP Queue 3), so reclaim, allocate and
backfill (and preempt) each republish and each republish is a record,
while a JAX leader on the CPU publishes once per open version.  The
shipped-conf case therefore holds the port's follower against the port's
own lease at every record."""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from kube_batch_tpu.api.pod import PodGroup, Queue
from kube_batch_tpu.api.types import PodPhase
from kube_batch_tpu.replicate import stream as jstream
from kube_batch_tpu_torch.api.convert import snapshot_to_numpy
from kube_batch_tpu_torch.api.resident import PER_CYCLE_FIELDS
from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
from kube_batch_tpu_torch.replicate import stream
from kube_batch_tpu_torch.replicate.follower import (
    FollowerApplier,
    FollowerCache,
    ReplicationFollower,
)
from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.serve.plane import QueryPlane, WhatifError
from kube_batch_tpu_torch.testing.cycle_drive import Loopback, make_follower
from kube_batch_tpu_torch.testing.synthetic import (
    synthetic_device_snapshot,
    synthetic_overcommit_cluster,
)
from fixtures import GiB, build_cache, build_node, build_pod
from test_torch_cycle import mirror
from test_torch_whatif import _port_run, _probe, port_cache


def _tick(qp):
    qp.batcher.tick(now=qp.batcher.clock.monotonic() + 1e6)


def _sweep(qp, body: dict) -> dict:
    fut = qp.submit_sweep(body)
    _tick(qp)
    return fut.result(timeout=60)


def _canon(resp: dict) -> str:
    return json.dumps(resp, sort_keys=True)


BODY = {"queue": "default", "count": 2,
        "requests": {"cpu": 1500, "memory": 2 * GiB},
        "min_resources": {"cpu": 3000}}
SWEEP = {"queue": "default", "max_count": 16,
         "requests": {"cpu": 4000, "memory": 2 * GiB}}


def _leader_objects():
    """test_replication's leader: four nodes, one running pod."""
    return dict(
        queues=[Queue(name="default", weight=1)],
        pod_groups=[PodGroup(name="run0", namespace="c1", min_member=1, queue="default")],
        nodes=[build_node(f"n{i}", cpu=8000, mem=16 * GiB, pods=32) for i in range(4)],
        pods=[build_pod("c1", "r0", "n0", PodPhase.RUNNING,
                        {"cpu": 6000, "memory": 4 * GiB}, group_name="run0")],
    )


def _churn_objects(i: int):
    """One ingest step: a new single-member gang that will bind."""
    return (PodGroup(name=f"churn-{i}", namespace="c1", min_member=1, queue="default"),
            build_pod("c1", f"churn-{i}-0", None, PodPhase.PENDING,
                      {"cpu": 200, "memory": 256 << 20}, group_name=f"churn-{i}"))


def _churn(cache, i: int) -> None:
    pg, pod = _churn_objects(i)
    cache.add_pod_group(mirror(pg))
    cache.add_pod(mirror(pod))


class Leader:
    """A port leader: cache, plane (start_thread=False) and publisher,
    after its first allocate cycle."""

    def __init__(self, ring_size=None, objects=None):
        self.cache = port_cache(**(objects if objects is not None else _leader_objects()))
        self.qp = QueryPlane(self.cache, start_thread=False)
        self.cache.replication = self.pub = ReplicationPublisher(ring_size=ring_size)
        self.cycle()

    def cycle(self):
        _port_run(self.cache)
        self.pub.barrier()

    def close(self):
        self.pub.close()
        self.qp.close()
        self.cache.stop()


@pytest.fixture
def made():
    """Closes what a test made (publishers own a non-daemon worker)."""
    objs = []
    yield objs
    for o in reversed(objs):
        o.close()


def encode_at_capture(pub):
    """Join each encode as soon as its ``publish_cycle`` returns.  The JAX
    publisher reads the live columns on its worker, so without this its
    frame may carry the replay's binds (a tear, ROADMAP Queue 3;
    :func:`test_jax_publisher_tears_where_the_port_does_not`)."""
    publish_cycle = pub.publish_cycle

    def joined(*a, **kw):
        seq = publish_cycle(*a, **kw)
        pub.barrier()
        return seq

    pub.publish_cycle = joined
    return pub


def _leader(made, **kw) -> Leader:
    ld = Leader(**kw)
    made.append(ld)
    return ld


def _follower(made, pub, device="cpu"):
    f = make_follower(pub, device)
    made.append(f.qp)
    return f, f.qp


# ==========================================================================
# the KBR1 codec, against the JAX package's
# ==========================================================================


def _seeded_snapshot():
    snap, meta = synthetic_device_snapshot(64, 8, device="cpu", seed=3)
    return snapshot_to_numpy(snap)._asdict(), meta


def _record(mod, kind):
    """The same record built with ``mod`` (either package's stream): full,
    delta or heartbeat, from one seeded snapshot; the lease carries that
    package's own configuration wire."""
    if mod is jstream:
        from kube_batch_tpu.ops.assignment import AllocateConfig
        from kube_batch_tpu.ops.eviction import EvictConfig
    else:
        from kube_batch_tpu_torch.ops.assignment import AllocateConfig
        from kube_batch_tpu_torch.ops.eviction import EvictConfig
    fields, meta = _seeded_snapshot()
    tables = stream.meta_tables(meta)
    lease = {"config": mod.config_to_wire(AllocateConfig()),
             "evict_config": mod.config_to_wire(EvictConfig(mode="preempt")),
             "probe_rows": [64, 65], "queue_rows": {"q0": 0, "q1": 1},
             "unmodeled_gates": [], "scalar_names": ["nvidia.com/gpu"]}
    if kind == "full":
        return mod.ReplicationRecord(
            kind=mod.FULL, seq=1, version=7, prev_seq=-1, prev_version=-1,
            head_seq=1, head_version=7, full=fields, delta={}, meta=tables, lease=lease)
    if kind == "delta":
        rows = np.array([1, 5, 7], np.int32)
        grown = dict(tables, task_keys=tables["task_keys"] + ["ns/new"])
        return mod.ReplicationRecord(
            kind=mod.DELTA, seq=2, version=9, prev_seq=1, prev_version=7,
            head_seq=2, head_version=9, full={"total": fields["total"]},
            delta={f: (rows, fields[f][rows]) for f in ("task_status", "task_req", "node_idle")},
            meta=mod.meta_patch(tables, grown), lease=lease)
    return mod.ReplicationRecord(
        kind=mod.HEARTBEAT, seq=4, version=12, prev_seq=-1, prev_version=-1,
        head_seq=4, head_version=12, full={}, delta={}, meta={}, lease={})


def _same_record(a, b) -> None:
    assert (a.kind, a.seq, a.version, a.prev_seq, a.prev_version, a.head_seq,
            a.head_version) == (b.kind, b.seq, b.version, b.prev_seq, b.prev_version,
                                b.head_seq, b.head_version)
    assert a.meta == b.meta and a.lease == b.lease
    assert sorted(a.full) == sorted(b.full) and sorted(a.delta) == sorted(b.delta)
    for f in a.full:
        assert a.full[f].dtype == b.full[f].dtype
        np.testing.assert_array_equal(a.full[f], b.full[f])
    for f in a.delta:
        for x, y in zip(a.delta[f], b.delta[f]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


KINDS = ("full", "delta", "heartbeat")


@pytest.mark.parametrize("kind", KINDS)
def test_frames_are_byte_identical(kind):
    frame = stream.encode_record(_record(stream, kind))
    assert frame == jstream.encode_record(_record(jstream, kind))
    assert frame[:4] == b"KBR1"


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_decodes_the_others_frames(kind):
    port_frame = stream.encode_record(_record(stream, kind))
    jax_frame = jstream.encode_record(_record(jstream, kind))
    _same_record(stream.decode_record(jax_frame), jstream.decode_record(port_frame))
    _same_record(stream.decode_record(jax_frame), _record(stream, kind))
    out = stream.decode_record(jax_frame)
    for arr in out.full.values():
        assert arr.flags.writeable  # the applier scatters in place


def _malformed(frame: bytes):
    return {"magic": b"NOPE" + frame[4:], "header_length": frame[:6],
            "header": frame[:20], "payload": frame[:-4]}


@pytest.mark.parametrize("case", ["magic", "header_length", "header", "payload"])
def test_malformed_frames_rejected_alike(case):
    frame = stream.encode_record(_record(stream, "full"))
    bad = _malformed(frame)[case]
    errors = []
    for mod in (stream, jstream):
        with pytest.raises(ValueError) as e:
            mod.decode_record(bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _configs(pkg):
    if pkg == "jax":
        from kube_batch_tpu.ops.assignment import AllocateConfig
        from kube_batch_tpu.ops.eviction import EvictConfig
        from kube_batch_tpu.ops.scoring import ScoreWeights
    else:
        from kube_batch_tpu_torch.ops.assignment import AllocateConfig
        from kube_batch_tpu_torch.ops.eviction import EvictConfig
        from kube_batch_tpu_torch.ops.scoring import ScoreWeights
    w = ScoreWeights(binpack=2.0, node_affinity=0.5)
    return [AllocateConfig(), AllocateConfig(rounds=4, topk=32, drf=False, weights=w),
            EvictConfig(), EvictConfig(mode="preempt", victim_drf=True, weights=w), w]


def test_config_wire_matches_the_jax_package():
    """The port writes the JAX field order with ``use_pallas: false`` in its
    place (the JAX leader always writes it so) and drops it on read; each
    package reads the other's wire back to its own configuration."""
    for port_cfg, jax_cfg in zip(_configs("port"), _configs("jax")):
        wire = stream.config_to_wire(port_cfg)
        jwire = jstream.config_to_wire(jax_cfg)
        assert json.dumps(wire) == json.dumps(jwire)
        assert stream.config_from_wire(wire) == port_cfg
        assert stream.config_from_wire(jwire) == port_cfg
        assert jstream.config_from_wire(wire) == jax_cfg
    wire = stream.config_to_wire(_configs("port")[0])
    assert list(wire["fields"])[5:7] == ["use_pallas", "topk"]
    assert wire["fields"]["use_pallas"] is False
    with pytest.raises(TypeError):
        stream.config_to_wire(object())


def test_meta_patch_round_trip_matches_the_jax_package():
    prev = {"task_keys": ["a/0", "a/1", "b/0"], "node_names": ["n0", "n1"],
            "job_uids": ["j0"], "queue_names": ["default"],
            "label_pair_bit": [["zone", "a", 0]], "taint_bit": [], "counts": [3, 2, 1, 1]}
    cur = {"task_keys": ["a/0", "c/0", "b/0", "c/1"], "node_names": ["n0"],
           "job_uids": ["j0", "j1"], "queue_names": ["default"],
           "label_pair_bit": [["zone", "a", 0], ["zone", "b", 1]],
           "taint_bit": [["k", "v", "NoSchedule", 0]], "counts": [4, 1, 2, 1]}
    patch = stream.meta_patch(prev, cur)
    assert patch == jstream.meta_patch(prev, cur)
    assert stream.apply_meta_patch(prev, patch) == cur == jstream.apply_meta_patch(prev, patch)
    assert patch["queue_names"]["set"] == {}
    null = stream.meta_patch(cur, cur)
    assert "label_pair_bit" not in null and stream.apply_meta_patch(cur, null) == cur
    _, meta = _seeded_snapshot()
    tables = stream.meta_tables(meta)
    rebuilt = stream.build_snapshot_meta(tables, meta.spec)
    assert stream.meta_tables(rebuilt) == tables
    assert rebuilt.task_objs == [] and rebuilt.task_resreq64 is None


# ==========================================================================
# the publisher: a JAX leader and a port leader, frame for frame
# ==========================================================================


def test_publisher_frames_match_the_jax_leader(made):
    """Six churn cycles under the allocate-only conf: every record the two
    leaders publish is byte-identical, and so are the counters but two.

    ``hint_fields`` / ``diff_fields`` differ, with the same sum: the JAX
    package's ``resident_snap`` rebuilds the snapshot tuple
    (``resident_features``) before the per-cycle swap, so the swap's memo
    never hits, ``publish_session`` swaps a second time (every field
    clean), the swap version moves by 2 a cycle, and its publisher never
    takes the swap's delta record; the port's memo hits, its version moves
    by 1, and the per-cycle fields take the hint (ROADMAP Queue 3)."""
    from kube_batch_tpu.replicate.publisher import ReplicationPublisher as JaxPublisher
    from kube_batch_tpu.serve.plane import QueryPlane as JaxPlane
    from test_replication import _run as jax_run

    objects = _leader_objects()
    jcache = build_cache(**objects)
    jqp = JaxPlane(jcache, start_thread=False)
    jcache.replication = jpub = encode_at_capture(JaxPublisher())
    ld = _leader(made, objects=objects)
    try:
        jax_run(jcache)
        jpub.barrier()
        for i in range(6):
            pg, pod = _churn_objects(i)
            jcache.add_pod_group(pg)
            jcache.add_pod(pod)
            ld.cache.add_pod_group(mirror(pg))
            ld.cache.add_pod(mirror(pod))
            jax_run(jcache)
            jpub.barrier()
            ld.cycle()
        want, got = jpub.counters(), ld.pub.counters()
        assert got["head_seq"] == want["head_seq"] == 7
        for since in range(-1, 8):
            assert ld.pub.record_for(since) == jpub.record_for(since), since
        hint_diff = ("hint_fields", "diff_fields")
        assert {k: v for k, v in got.items() if k not in hint_diff} == \
            {k: v for k, v in want.items() if k not in hint_diff}
        assert got["hint_fields"] + got["diff_fields"] == \
            want["hint_fields"] + want["diff_fields"]
        assert want["hint_fields"] == 0
        assert got["hint_fields"] == len(PER_CYCLE_FIELDS) * 6
        assert got["records_delta"] == 6 and got["encode_errors"] == 0
    finally:
        jpub.close()
        jqp.close()
        jcache.stop()


# ==========================================================================
# a port follower against its port leader (test_replication's cases)
# ==========================================================================


class TestFollowerServing:
    def test_frozen_snapshot_bit_match(self, made):
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        assert f.applier.applied_seq == 1
        r_leader, r_follower = _probe(ld.qp, BODY), _probe(fqp, BODY)
        assert _canon(r_leader) == _canon(r_follower)
        assert r_follower["staleness"]["lag_cycles"] == 0
        assert r_follower["staleness"]["seq"] == 1
        assert _canon(_sweep(ld.qp, SWEEP)) == _canon(_sweep(fqp, SWEEP))

    def test_delta_chain_under_churn_stays_bit_identical(self, made):
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        lags = []
        for i in range(6):
            _churn(ld.cache, i)
            ld.cycle()
            rec = stream.decode_record(ld.pub.record_for(f.applier.applied_seq))
            lags.append(rec.head_seq - f.applier.applied_seq)
            assert f.run_once() == "applied"
            assert _canon(_probe(ld.qp, BODY)) == _canon(_probe(fqp, BODY))
        assert ld.pub.counters()["records_delta"] >= 5
        assert f.applier.applied_seq == 7
        assert float(np.percentile(lags, 99)) <= 1.0
        assert f.run_once() == "heartbeat"

    def test_meta_growth_crosses_the_wire(self, made):
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        f.run_once()
        for i in range(3):
            _churn(ld.cache, 100 + i)
            ld.cycle()
            assert f.run_once() == "applied"
        assert {f"c1/churn-{100 + i}-0" for i in range(3)} <= set(f.applier.tables["task_keys"])
        body = {"queue": "default", "count": 1, "requests": {"cpu": 500, "memory": GiB}}
        assert _canon(_probe(ld.qp, body)) == _canon(_probe(fqp, body))

    def test_follower_cache_rejects_ingest(self, made):
        """Every ingest mutator of the port's cache rejects, add_pod too
        (the JAX package's FollowerCache has no add_pod: ROADMAP Queue 3)."""
        ld = _leader(made)
        f, _ = _follower(made, ld.pub)
        with pytest.raises(ValueError, match="read-only replica"):
            f.cache.add_node(mirror(build_node("nx", cpu=1000, mem=GiB)))
        with pytest.raises(ValueError, match="read-only replica"):
            f.cache.ingest_batch([])
        for name in FollowerCache._INGEST:
            assert hasattr(ld.cache, name), name
            with pytest.raises(ValueError, match="read-only replica"):
                getattr(f.cache, name)(None)


class TestResyncAndRestart:
    def test_delta_gap_escalates_to_full_resync(self, made):
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        for i in range(2):
            _churn(ld.cache, i)
            ld.cycle()
        skipped = ld.pub.record_for(2)
        assert stream.decode_record(skipped).kind == stream.DELTA
        assert f.applier.apply(skipped) == "resync"
        assert f.applier.gaps == 1 and f.applier.applied_seq == 1
        f._force_full = True
        assert f.run_once() == "applied"
        assert f.applier.applied_seq == 3 and f.applier.full_adoptions >= 1
        assert _canon(_probe(ld.qp, BODY)) == _canon(_probe(fqp, BODY))

    def test_out_of_range_delta_is_refused_whole(self, made):
        """A delta with a row past the field leaves the applied fields as
        they were (every scatter is checked before any is written)."""
        ld = _leader(made)
        f, _ = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        _churn(ld.cache, 0)
        ld.cycle()
        rec = stream.decode_record(ld.pub.record_for(1))
        field = sorted(rec.delta)[-1]
        rows, vals = rec.delta[field]
        bad = dict(rec.delta, **{field: (np.append(rows, 10**6).astype(np.int32),
                                         np.concatenate([vals, vals[:1]]))})
        before = {k: v.copy() for k, v in f.applier.fields.items()}
        assert f.applier.apply(stream.encode_record(rec._replace(delta=bad))) == "resync"
        for k, v in before.items():
            np.testing.assert_array_equal(f.applier.fields[k], v)

    def test_ring_falloff_serves_synthesized_full(self, made):
        ld = _leader(made, ring_size=1,
                     objects=dict(queues=[Queue(name="default", weight=1)],
                                  nodes=[build_node("n0", cpu=8000, mem=16 * GiB)]))
        for i in range(3):
            _churn(ld.cache, i)
            ld.cycle()
        rec = stream.decode_record(ld.pub.record_for(1))
        assert rec.kind == stream.FULL
        assert rec.seq == ld.pub.counters()["head_seq"]
        f, fqp = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        assert _canon(_probe(ld.qp, BODY)) == _canon(_probe(fqp, BODY))

    def test_reconnect_after_leader_outage(self, made):
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        f.transport.down = True
        assert f.run_once() == "error" and f.pull_errors == 1
        for i in range(2):
            _churn(ld.cache, i)
            ld.cycle()
        f.transport.down = False
        assert f.run_once() == "applied"
        assert f.run_once() == "applied"
        assert f.applier.applied_seq == 3
        assert _canon(_probe(ld.qp, BODY)) == _canon(_probe(fqp, BODY))

    def test_restart_readopts_warm(self, made):
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        app = f.applier
        mode = app.revalidate_resident()
        assert mode["mode"] == "warm" and mode["resident_version"] > 0
        static_field = next(iter(app._static_dev))
        buf_before = app._static_dev[static_field][1]
        resident_before = app.resident
        uploads = app.static_uploads
        full_before = app.resident.full_uploads
        f._force_full = True
        assert f.run_once() == "applied"
        # unchanged state re-adopted: every stamp kept, nothing uploaded again
        assert app._static_dev[static_field][1] is buf_before
        assert app.resident is resident_before
        assert app.static_uploads == uploads
        assert app.resident.full_uploads == full_before
        assert _canon(_probe(ld.qp, BODY)) == _canon(_probe(fqp, BODY))
        f2, _ = _follower(made, ld.pub)
        assert f2.applier.revalidate_resident()["mode"] == "cold"

    def test_warm_resync_uploads_only_the_changed_fields(self, made):
        """A full frame after a gap rewrites only the fields that changed:
        the static fields the churn left alone keep their device tensors."""
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        app = f.applier
        before = dict(app._static_dev)
        for i in range(2):
            _churn(ld.cache, i)
            ld.cycle()
        c0 = app.resident.counters()
        f._force_full = True
        assert f.run_once() == "applied" and app.full_adoptions == 2
        kept = [k for k, v in app._static_dev.items() if v[1] is before[k][1]]
        moved = [k for k, v in app._static_dev.items() if v[1] is not before[k][1]]
        assert "node_alloc" in kept and "task_req" in moved
        # the per-cycle fields: the changed ones rewritten, the rest clean
        c1 = app.resident.counters()
        changed = len(app.resident.delta_record)
        assert 0 < changed < len(PER_CYCLE_FIELDS)
        assert (c1["full_uploads"] + c1["scatter_updates"]
                - c0["full_uploads"] - c0["scatter_updates"]) == changed
        assert c1["clean_hits"] - c0["clean_hits"] == len(PER_CYCLE_FIELDS) - changed
        assert _canon(_probe(ld.qp, BODY)) == _canon(_probe(fqp, BODY))

    def test_pull_loop_runs_and_stops(self, made):
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        f.start()
        try:
            for _ in range(500):
                if f.applier.applied_seq == 1:
                    break
                threading.Event().wait(0.01)
            assert f.applier.applied_seq == 1
        finally:
            f.stop()
        assert f._thread is None
        assert _canon(_probe(ld.qp, BODY)) == _canon(_probe(fqp, BODY))


class TestSweep:
    def test_sweep_matches_brute_force(self, made):
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        resp = _sweep(fqp, SWEEP)
        brute = 0
        for c in range(1, 17):
            if _probe(fqp, {"queue": "default", "count": c,
                            "requests": {"cpu": 4000, "memory": 2 * GiB}})["feasible"]:
                brute = c
        assert resp["max_fit"] == brute == 6
        assert resp["feasible"] and resp["probes"] < 16
        assert resp["staleness"]["lag_cycles"] == 0
        assert _canon(resp) == _canon(_sweep(ld.qp, SWEEP))

    def test_sweep_infeasible_and_validation(self, made):
        ld = _leader(made)
        f, fqp = _follower(made, ld.pub)
        assert f.run_once() == "applied"
        none_fit = _sweep(fqp, {"queue": "default", "max_count": 8, "requests": {"cpu": 64000}})
        assert none_fit["max_fit"] == 0 and not none_fit["feasible"]
        for body in ({"queue": "default", "max_count": 0, "requests": {"cpu": 100}},
                     {"queue": "default", "max_count": 65, "requests": {"cpu": 100}},
                     {"queue": "default", "max_count": 4, "requests": {"cpu": 100},
                      "evictions": True}):
            with pytest.raises(WhatifError):
                fqp.submit_sweep(body)


# ==========================================================================
# across the packages: a follower of one serves from the other's frames
# ==========================================================================


PROBES = (BODY, {"queue": "default", "count": 3, "requests": {"cpu": 2500, "memory": GiB}},
          {"queue": "default", "count": 1, "evictions": True,
           "requests": {"cpu": 7000, "memory": GiB}})


def test_port_follower_serves_jax_frames(made):
    """A port follower fed the JAX leader's frames answers what-ifs and
    sweeps dict for dict like the JAX leader, along a churned chain."""
    from kube_batch_tpu.replicate.publisher import ReplicationPublisher as JaxPublisher
    from kube_batch_tpu.serve.plane import QueryPlane as JaxPlane
    from test_replication import _run as jax_run

    jcache = build_cache(**_leader_objects())
    jqp = JaxPlane(jcache, start_thread=False)
    jcache.replication = jpub = encode_at_capture(JaxPublisher())
    try:
        jax_run(jcache)
        jpub.barrier()
        f, fqp = _follower(made, jpub)
        for i in range(3):
            assert f.run_once() == "applied"
            for body in PROBES:
                assert _probe(fqp, body) == _probe(jqp, body), body
            assert _sweep(fqp, SWEEP) == _sweep(jqp, SWEEP)
            pg, pod = _churn_objects(200 + i)
            jcache.add_pod_group(pg)
            jcache.add_pod(pod)
            jax_run(jcache)
            jpub.barrier()
    finally:
        jpub.close()
        jqp.close()
        jcache.stop()


def test_jax_follower_serves_port_frames(made):
    """The JAX package's follower fed the port leader's frames answers like
    the port leader."""
    from kube_batch_tpu.replicate.follower import FollowerCache as JaxFollowerCache
    from kube_batch_tpu.replicate.follower import ReplicationFollower as JaxFollower
    from kube_batch_tpu.serve.plane import QueryPlane as JaxPlane

    ld = _leader(made)
    jfcache = JaxFollowerCache()
    jfqp = JaxPlane(jfcache, start_thread=False)
    try:
        jf = JaxFollower("http://unused", cache=jfcache, query_plane=jfqp,
                         transport=Loopback(ld.pub), poll_s=0.001)
        for i in range(3):
            assert jf.run_once() == "applied"
            for body in PROBES:
                assert _probe(jfqp, body) == _probe(ld.qp, body), body
            _churn(ld.cache, 300 + i)
            ld.cycle()
    finally:
        jfqp.close()


# ==========================================================================
# the shipped conf: every record against the leader's lease at that seq
# ==========================================================================


def test_shipped_conf_every_record_answers_like_its_lease(made):
    """The overcommitted cluster under the shipped five-action conf, three
    cycles: after every publish the follower pulls the record, and before
    the leader's next swap both planes answer the same gangs (one with
    evictions) and a sweep identically.  The port republishes at every
    swap, so a cycle where reclaim, allocate and backfill swap carries
    several records."""
    from kube_batch_tpu_torch.testing.cycle_drive import kubelet

    cache = synthetic_overcommit_cluster(n_running=64, n_pending=32, n_nodes=8)
    qp = QueryPlane(cache, start_thread=False)
    cache.replication = pub = ReplicationPublisher()

    class Closer:
        def close(self):
            pub.close()
            qp.close()
            cache.stop()

    made.append(Closer())
    f, fqp = _follower(made, pub)
    bodies = ({"queue": "q1", "count": 2, "requests": {"cpu": 500, "memory": GiB}},
              {"queue": "q0", "count": 1, "requests": {"cpu": 250, "memory": GiB}},
              {"queue": "q1", "count": 1, "evictions": True,
               "requests": {"cpu": 1000, "memory": GiB}})
    sweep = {"queue": "q1", "max_count": 8, "requests": {"cpu": 500, "memory": GiB}}
    checked, errors = [], []
    publish = qp.publish_session

    def hooked(ssn, snap, meta):
        publish(ssn, snap, meta)
        try:
            pub.barrier()
            assert f.run_once() == "applied"
            lease = qp.broker.current()
            assert lease.seq == f.applier.applied_seq == pub.counters()["head_seq"]
            for body in bodies:
                got, want = _probe(fqp, body), _probe(qp, body)
                assert _canon(got) == _canon(want), (body, got, want)
            assert _canon(_sweep(fqp, sweep)) == _canon(_sweep(qp, sweep))
            checked.append(lease.seq)
        except BaseException as e:  # noqa: BLE001 — the plane logs and swallows
            errors.append(repr(e))

    qp.publish_session = hooked
    sched = Scheduler(cache, conf=load_scheduler_conf(shipped_conf_path()), device="cpu")
    made.append(sched)
    per_cycle = []
    for c in range(3):
        if c:
            kubelet(cache, list(cache.evictor.evicts))
        before = len(checked)
        sched.run_once()
        per_cycle.append(len(checked) - before)
    assert errors == []
    assert checked == list(range(1, len(checked) + 1))
    # records per cycle, stated: more than one where several actions swap
    assert per_cycle[0] >= 2 and sum(per_cycle) >= 4, per_cycle
    assert len(cache.evictor.evicts) > 0


# ==========================================================================
# the traps: torn capture, CPU aliasing, the CPU hint path, the device
# ==========================================================================


def test_frame_holds_the_values_at_capture(made):
    """The port's host snapshot hands live columns through, and the cycle
    mutates them after its publish (allocate's replay).  A live column
    mutated right after ``publish_cycle``, before the worker diffs it, must
    not reach the frame."""
    ld = _leader(made)
    _churn(ld.cache, 0)
    gate = threading.Event()
    encode = ld.pub._encode_locked

    def held(*a):
        gate.wait(30)
        return encode(*a)

    ld.pub._encode_locked = held
    publish_cycle = ld.pub.publish_cycle
    seen = {}

    def torn(snap, meta, lease, **kw):
        seq = publish_cycle(snap, meta, lease, **kw)
        cols = ld.cache.columns
        live = {"task_status": cols.t_status, "task_node": cols.t_node,
                "task_valid": cols.t_valid, "task_req": cols.t_init32}
        for name, col in live.items():
            assert getattr(snap, name) is col, name  # the snapshot hands it through
        seen.update({name: col.copy() for name, col in live.items()})
        for col in live.values():
            col[...] = 7
        gate.set()
        ld.pub.barrier()
        for name, col in live.items():
            col[...] = seen[name]
        return seq

    ld.pub.publish_cycle = torn
    ld.cycle()
    assert ld.cache.columns.check_consistency(ld.cache) == []
    rec = stream.decode_record(ld.pub.record_for(-1))
    assert rec.kind == stream.FULL, (rec.kind, ld.pub.counters())
    assert ld.pub.counters()["encode_errors"] == 0, ld.pub.counters()
    assert sorted(seen) and all(np.array_equal(rec.full[k], v) for k, v in seen.items())
    delta = stream.decode_record(ld.pub.record_for(1))
    assert {"task_valid", "task_req"} <= set(delta.delta)
    for name in set(seen) & set(delta.delta):
        rows, vals = delta.delta[name]
        np.testing.assert_array_equal(vals, seen[name][rows])


def test_jax_publisher_tears_where_the_port_does_not(made):
    """The same cycle on a JAX and a port leader, each publisher's encode
    held until the cycle (its replay) is over: the JAX frame carries the
    replay's binds, which its lease does not hold; the port's frame is the
    lease's state (ROADMAP Queue 3)."""
    from kube_batch_tpu.replicate.publisher import ReplicationPublisher as JaxPublisher
    from kube_batch_tpu.serve.plane import QueryPlane as JaxPlane
    from test_replication import _run as jax_run

    objects = _leader_objects()
    jcache = build_cache(**objects)
    jqp = JaxPlane(jcache, start_thread=False)
    jcache.replication = jpub = JaxPublisher()
    ld = _leader(made, objects=objects)
    try:
        jax_run(jcache)
        jpub.barrier()
        pg, pod = _churn_objects(0)
        jcache.add_pod_group(pg)
        jcache.add_pod(pod)
        ld.cache.add_pod_group(mirror(pg))
        ld.cache.add_pod(mirror(pod))
        gates, captured = {}, {}
        for name, pub, cols in (("jax", jpub, jcache.columns), ("port", ld.pub, ld.cache.columns)):
            gate = gates[name] = threading.Event()
            encode, publish_cycle = pub._encode_locked, pub.publish_cycle

            def held(*a, gate=gate, encode=encode):
                gate.wait(30)
                return encode(*a)

            def capture(snap, meta, lease, name=name, cols=cols, publish_cycle=publish_cycle,
                        **kw):
                seq = publish_cycle(snap, meta, lease, **kw)
                assert snap.task_status is cols.t_status  # a live column
                captured[name] = {f: np.array(getattr(snap, f))
                                  for f in ("task_status", "task_node")}
                return seq

            pub._encode_locked, pub.publish_cycle = held, capture
        jax_run(jcache)
        _port_run(ld.cache)
        for gate in gates.values():
            gate.set()
        jpub.barrier()
        ld.pub.barrier()
        # the state each stream now holds for seq 2: its full frame
        frames = {"jax": jstream.decode_record(jpub.record_for(-1)),
                  "port": stream.decode_record(ld.pub.record_for(-1))}
        assert {name: rec.seq for name, rec in frames.items()} == {"jax": 2, "port": 2}
        torn = {name: {f: not np.array_equal(rec.full[f], captured[name][f])
                       for f in ("task_status", "task_node")}
                for name, rec in frames.items()}
        for f in ("task_status", "task_node"):
            np.testing.assert_array_equal(captured["jax"][f], captured["port"][f])
        assert torn == {"jax": {"task_status": True, "task_node": True},
                        "port": {"task_status": False, "task_node": False}}
    finally:
        jpub.close()
        jqp.close()
        jcache.stop()


def test_cpu_lease_does_not_alias_the_host_fields(made):
    """On the CPU a tensor made from numpy can share its memory.  Publish,
    apply the next delta to the host fields without publishing, and probe
    the old lease: its tensors and its answer are unchanged."""
    ld = _leader(made)
    f, fqp = _follower(made, ld.pub)
    assert f.run_once() == "applied"
    lease = fqp.broker.current()
    tensors = {k: v.clone() for k, v in lease.snap._asdict().items()}
    answer = _probe(fqp, BODY)
    for i in range(2):
        _churn(ld.cache, i)
    ld.cycle()
    rec = stream.decode_record(ld.pub.record_for(1))
    # scatters into a static field and a per-cycle one
    assert {"task_req", "job_min_avail"} <= set(rec.delta)
    f.applier._apply_delta(rec)
    assert fqp.broker.current() is lease
    for k, v in lease.snap._asdict().items():
        assert torch.equal(v, tensors[k]), k
    assert _probe(fqp, BODY) == answer


def test_cpu_session_publish_takes_the_hint_path(made):
    """``publish_session`` asks the swap's delta record of the session's own
    device: a CPU session takes the hint for its per-cycle fields."""
    ld = _leader(made)
    hint, version = ld.cache.columns.export_delta_record("cpu")
    assert hint is not None and version > 0
    for i in range(2):
        _churn(ld.cache, i)
        ld.cycle()
    c = ld.pub.counters()
    assert c["hint_fields"] > 0 and c["records_delta"] == 2


def test_follower_defaults_to_cuda(monkeypatch, made):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fcache = FollowerCache()
    fqp = QueryPlane(fcache, start_thread=False)
    made.append(fqp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FollowerApplier(fcache, fqp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicationFollower("http://unused", cache=fcache, query_plane=fqp,
                            transport=Loopback(None))


def test_pulls_race_the_publisher(made):
    """Eight threads pull random ``since`` tokens and a follower's pull
    loop runs while the leader cycles, with a short switch interval: every
    frame decodes to the record its token asks for, and the follower ends
    answering like the leader."""
    import random
    import sys

    ld = _leader(made, ring_size=3)
    f, fqp = _follower(made, ld.pub)
    stop = threading.Event()
    errors = []

    def puller(k):
        rng = random.Random(k)
        while not stop.is_set():
            since = rng.randint(-1, ld.pub.counters()["head_seq"] + 1)
            rec = stream.decode_record(ld.pub.record_for(since))
            if rec.kind == stream.DELTA and rec.seq != since + 1:
                errors.append(("delta", since, rec.seq))
            elif rec.kind == stream.FULL and not (rec.seq > since and rec.full):
                errors.append(("full", since, rec.seq))
            elif rec.kind == stream.HEARTBEAT and rec.seq > since:
                errors.append(("heartbeat", since, rec.seq))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=puller, args=(k,)) for k in range(8)]
    try:
        for t in threads:
            t.start()
        f.start()
        for i in range(6):
            _churn(ld.cache, 400 + i)
            ld.cycle()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        f.stop()
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    while f.run_once() == "applied":
        pass
    assert f.applier.applied_seq == ld.pub.counters()["head_seq"] == 7
    assert _canon(_probe(ld.qp, BODY)) == _canon(_probe(fqp, BODY))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_meta_patch_at_scale_matches_the_jax_package(seed):
    """Name lists that shrink, grow and change in scattered entries: the
    port's patch (compared in C) is the JAX package's, key order included."""
    rng = np.random.default_rng(seed)
    n = 5000
    prev = {"task_keys": [f"ns/p{i}" for i in range(n)], "node_names": ["n0", "n1"],
            "job_uids": [f"j{i}" for i in range(n // 4)], "queue_names": ["q0", "q1"],
            "label_pair_bit": [], "taint_bit": [], "counts": [n, 2, n // 4, 2]}
    keys = list(prev["task_keys"])
    for i in rng.choice(n, 300, replace=False):
        keys[i] = "" if rng.random() < 0.5 else f"ns/new{i}"
    grow = int(rng.integers(-200, 200))
    keys = keys[:n + grow] if grow < 0 else keys + [f"ns/tail{i}" for i in range(grow)]
    cur = dict(prev, task_keys=keys, job_uids=prev["job_uids"][::-1],
               counts=[len(keys), 2, n // 4, 2])
    patch = stream.meta_patch(prev, cur)
    want = jstream.meta_patch(prev, cur)
    assert json.dumps(patch) == json.dumps(want)
    assert stream.apply_meta_patch(prev, patch) == cur
