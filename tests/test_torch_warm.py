"""The port's warm-started compacted allocate (``KB_WARM``) against the JAX
package's, on the same inputs.

The device half — ``lex_topk3``, ``node_view``, ``fresh_block_skey``,
``warm_refresh_table`` and the warm solve — is fed one numpy snapshot,
table and plan on both sides: every int and bool output (the result, the
refreshed table's idx / skey / hash / trunc, ``eroded``) bit for bit, the
f32 ledgers equal.  The host half — ``WarmTableState``'s planner — runs on
both packages' caches fed the same events (the ``test_torch_delta.py``
harness): each cycle the plan arrays, ``last_warm`` and the carried table
must equal the JAX package's, and the port's warm leg must decide as its
``KB_WARM=0`` leg.  The table's lifetime (axis growth, resident drops), a
plan without an absorbed swap and the ``KB_WARM`` reader are held too.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
from kube_batch_tpu.actions.allocate import (
    build_session_snapshot,
    session_allocate_config,
)
from kube_batch_tpu.framework.conf import load_scheduler_conf as jax_load_conf
from kube_batch_tpu.framework.session import close_session as jax_close
from kube_batch_tpu.framework.session import open_session as jax_open
from kube_batch_tpu.ops import assignment as jasg
from kube_batch_tpu.testing.synthetic import synthetic_cluster as jax_cluster
from kube_batch_tpu_torch.api.convert import (
    config_from_fields,
    result_to_numpy,
    snapshot_from_numpy,
)
from kube_batch_tpu_torch.ops import assignment as pasg
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

CPU = torch.device("cpu")


def t(a, dtype=None):
    """A numpy array as a CPU tensor (a copy)."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """A tensor or JAX array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(jax.device_get(x))


def assert_same(got, want, where: str) -> None:
    got, want = n(got), n(want)
    assert got.shape == want.shape, f"{where}: shape {got.shape} / {want.shape}"
    assert got.dtype == want.dtype, f"{where}: dtype {got.dtype} / {want.dtype}"
    assert np.array_equal(got, want), f"{where}: differs at {int((got != want).sum())} cells"


def assert_result(got, want, where: str) -> None:
    got = result_to_numpy(got)
    for name in want._fields:
        assert np.array_equal(getattr(got, name), np.asarray(getattr(want, name))), (
            f"{where}: {name} differs")


# --------------------------------------------------------------------------
# the device half
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def session_snapshot(n_tasks: int, n_nodes: int, seed: int):
    """(JAX numpy snapshot, JAX config) of a synthetic cluster's session
    (the JAX package's ``tests/test_warm.py`` recipe: gangs of 2, 2 queues)."""
    cache = jax_cluster(n_tasks=n_tasks, n_nodes=n_nodes, gang_size=2, n_queues=2,
                        seed=seed)
    conf = jax_load_conf(None)
    ssn = jax_open(cache, conf.tiers)
    try:
        snap, _meta = build_session_snapshot(ssn)
        config = session_allocate_config(ssn)
    finally:
        jax_close(ssn)
    return jax.device_get(snap), config


def pend_rows_of(snap, bucket: int) -> np.ndarray:
    rows = np.flatnonzero(np.asarray(snap.task_pending))
    assert 0 < rows.size <= bucket
    out = np.full(bucket, -1, np.int32)
    out[: rows.size] = rows.astype(np.int32)
    return out


def zero_table(P: int, W: int):
    return (np.zeros((P, W), np.int32), np.full((P, W), -(2 ** 31), np.int32),
            np.full((P, W), -1, np.int32), np.zeros(P, bool))


def make_plan(P, row_map=None, changed=(), rerank_rows=None, rerank_slots=None,
              c_slots=64, r_slots=128):
    rm = np.full(P, -1, np.int32) if row_map is None else np.asarray(row_map, np.int32)
    ch = np.full(c_slots, -1, np.int32)
    ch[: len(changed)] = np.asarray(list(changed), np.int32)
    rr = np.full(r_slots, -1, np.int32)
    rs = np.full(r_slots, -1, np.int32)
    if rerank_rows is not None:
        rr[: len(rerank_rows)] = np.asarray(rerank_rows, np.int32)
        rs[: len(rerank_slots)] = np.asarray(rerank_slots, np.int32)
    return rm, ch, rr, rs


def both_warm(jsnap, jconfig, rows, table, plan, W: int, k_min: int):
    """The warm solve on both packages: ((jax res, table, eroded), (port
    res, table, eroded)), the table as numpy on both sides."""
    cfg = jconfig._replace(topk=W)
    jres, jtab, jer = jasg.warm_allocate_solve(
        jsnap, jnp.asarray(rows), tuple(map(jnp.asarray, table)),
        tuple(map(jnp.asarray, plan)), cfg, k_min)
    psnap = snapshot_from_numpy(jsnap, CPU)
    pres, ptab, per = pasg.warm_allocate_solve(
        psnap, t(rows), tuple(map(t, table)), tuple(map(t, plan)),
        config_from_fields(cfg), k_min)
    return ((jax.device_get(jres), tuple(map(n, jtab)), n(jer)),
            (pres, tuple(map(n, ptab)), n(per)))


def check_warm(jsnap, jconfig, rows, table, plan, W, k_min, where):
    (jres, jtab, jer), (pres, ptab, per) = both_warm(jsnap, jconfig, rows, table,
                                                    plan, W, k_min)
    assert_result(pres, jres, where)
    for name, a, b in zip(("idx", "skey", "hash", "trunc"), ptab, jtab):
        assert_same(a, b, f"{where}: table {name}")
    assert_same(per, jer, f"{where}: eroded")
    return jtab, jres


@pytest.mark.parametrize("seed", [0, 3])
def test_lex_topk3_matches_jax(seed):
    """Random keys with heavy ties, indices unique per row but not sorted,
    a ragged last block and rows with fewer valid entries than K."""
    rng = np.random.default_rng(seed)
    P, M, K = 40, 150, 12
    skey = rng.integers(-3, 3, (P, M)).astype(np.int32)
    skey[rng.random((P, M)) < 0.3] = -(2 ** 31)
    hsh = rng.integers(0, 4, (P, M)).astype(np.int32)
    idx = np.stack([rng.permutation(10_000)[:M] for _ in range(P)]).astype(np.int32)
    want = jax.jit(jasg.lex_topk3, static_argnums=3)(skey, hsh, idx, K)
    got = pasg.lex_topk3(t(skey), t(hsh), t(idx), K)
    for name, a, b in zip(("idx", "skey", "hash"), got, want):
        assert_same(a, b, f"lex_topk3 {name}")


def test_node_view_and_fresh_keys_match_jax():
    """``node_view`` over changed rows with -1 padding (dead columns), and
    ``fresh_block_skey`` on it, against the JAX package's."""
    jsnap, jconfig = session_snapshot(200, 64, 5)
    rows = pend_rows_of(jsnap, 256)
    changed = np.full(64, -1, np.int32)
    changed[:5] = [3, 17, 40, 41, 63]
    jview = jasg.node_view(jasg.pend_view(jsnap, jnp.asarray(rows)), jnp.asarray(changed))
    pview = pasg.node_view(pasg.pend_view(snapshot_from_numpy(jsnap, CPU), t(rows)),
                           t(changed))
    for f in ("node_idle", "node_releasing", "node_used", "node_alloc", "node_valid",
              "node_sched", "node_label_bits", "node_taint_bits", "task_aff_mask",
              "task_pref_node", "task_pref_pod"):
        got, want = n(getattr(pview, f)), n(getattr(jview, f))
        if f.endswith("_bits"):
            want = want.view(np.int32)
        assert_same(got, want, f"node_view {f}")
    want = jax.jit(jasg.fresh_block_skey, static_argnums=2)(
        jview, jsnap.quanta, jconfig)
    got = pasg.fresh_block_skey(pview, t(jsnap.quanta), config_from_fields(jconfig))
    assert_same(got, want, "fresh_block_skey")


@pytest.mark.parametrize("releasing", [False, True])
def test_fresh_keys_zero_releasing_and_a_request_within_quanta(releasing):
    """The fresh keys over a changed-node subset with nothing releasing,
    for a row whose request fits a zero budget within ``quanta``: the JAX
    package counts the releasing fit only when something in the subset is
    releasing (K2 always counts it).  With one node releasing, the fit
    counts everywhere in the subset.  Bit-exact either way."""
    jsnap, jconfig = session_snapshot(200, 64, 5)
    snap = jsnap._replace(
        node_releasing=np.zeros_like(jsnap.node_releasing),
        task_req=jsnap.task_req.copy(), node_idle=jsnap.node_idle.copy())
    rows = pend_rows_of(snap, 256)
    small = int(rows[0])
    snap.task_req[small] = snap.quanta * 0.5      # fits a zero budget
    changed = np.full(64, -1, np.int32)
    changed[:4] = [2, 9, 30, 50]
    # idle within a quantum below zero: the request does not fit it
    snap.node_idle[changed[:4]] = -0.75 * snap.quanta
    if releasing:
        snap.node_releasing[9] = snap.quanta * 4
    jview = jasg.node_view(jasg.pend_view(snap, jnp.asarray(rows)), jnp.asarray(changed))
    want = n(jax.jit(jasg.fresh_block_skey, static_argnums=2)(jview, snap.quanta, jconfig))
    pview = pasg.node_view(pasg.pend_view(snapshot_from_numpy(snap, CPU), t(rows)),
                           t(changed))
    got = pasg.fresh_block_skey(pview, t(snap.quanta), config_from_fields(jconfig))
    assert_same(got, want, "fresh_block_skey")
    neg = int(n(jasg._neg_key()))
    # the small row keys above NEG at those nodes only when something in
    # the subset is releasing
    assert (want[0, :4] > neg).all() == releasing
    assert (want[0, :4] > neg).any() == releasing


def test_warm_refresh_table_matches_jax():
    """``warm_refresh_table`` on a carried table with a permuted bucket,
    changed nodes, re-ranked rows and fresh rows, against the JAX
    package's: the refreshed table and the erosion flags."""
    rng = np.random.default_rng(11)
    P, W, M, C, N, k_min = 64, 12, 48, 64, 200, 3
    tab_s = np.sort(rng.integers(-50, 50, (P, W)), axis=1)[:, ::-1].astype(np.int32)
    tab_s[rng.random((P, W)) < 0.2] = -(2 ** 31)
    tab_s = -np.sort(-tab_s, axis=1).astype(np.int32)
    tab_i = np.stack([rng.permutation(N)[:W] for _ in range(P)]).astype(np.int32)
    tab_h = rng.integers(0, 100, (P, W)).astype(np.int32)
    tab_t = rng.random(P) < 0.5
    row_map = rng.permutation(M).astype(np.int32)
    row_map[rng.random(M) < 0.2] = -1
    rows_m = rng.integers(0, 5000, M).astype(np.int32)
    changed = np.full(C, -1, np.int32)
    changed[:20] = rng.permutation(N)[:20]
    skey_c = rng.integers(-60, 60, (M, C)).astype(np.int32)
    hash_c = rng.integers(0, 100, (M, C)).astype(np.int32)
    R = 16
    ri = np.stack([rng.permutation(N)[:W] for _ in range(R)]).astype(np.int32)
    rs = -np.sort(-rng.integers(-50, 50, (R, W)), axis=1).astype(np.int32)
    rh = rng.integers(0, 100, (R, W)).astype(np.int32)
    trunc_i = rng.random(R) < 0.5
    slots = np.full(R, -1, np.int32)
    slots[:9] = rng.permutation(M)[:9]
    args = (tab_i, tab_s, tab_h, tab_t, row_map, rows_m, changed, skey_c, hash_c,
            ri, rs, rh, trunc_i, slots)
    want = jax.jit(jasg.warm_refresh_table, static_argnums=(14, 15))(*args, N, k_min)
    got = pasg.warm_refresh_table(*map(t, args), N, k_min)
    for name, a, b in zip(("idx", "skey", "hash", "trunc", "eroded"), got, want):
        assert_same(a, b, f"warm_refresh_table {name}")


def test_warm_solve_carry_merge_and_cut_match_jax():
    """The solve-level life of a carried table (the JAX package's
    ``test_warm_solve_carry_merge_and_cut_bit_exact``): cold build through
    the warm program, identity carry, a node whose key improves (merged
    in), a node whose idle is zeroed (cut) — each step's result, table and
    erosion flags equal to the JAX package's, and the result to the full
    solve's."""
    jsnap, jconfig = session_snapshot(400, 16, 7)
    P, K, W = 512, 4, 8
    rows = pend_rows_of(jsnap, P)
    live = int((rows >= 0).sum())
    full = jax.device_get(jasg.allocate_solve(jsnap, jconfig))
    plan0 = make_plan(P, rerank_rows=rows[:live], rerank_slots=np.arange(live), r_slots=P)
    table, res = check_warm(jsnap, jconfig, rows, zero_table(P, W), plan0, W, K,
                            "cold build")
    assert np.array_equal(np.asarray(res.assigned), np.asarray(full.assigned))
    ident = make_plan(P, row_map=np.arange(P))
    table, _ = check_warm(jsnap, jconfig, rows, table, ident, W, K, "identity carry")
    ni, nu = jsnap.node_idle.copy(), jsnap.node_used.copy()
    freed = nu[3] * 0.5
    ni[3] += freed
    nu[3] -= freed
    snap2 = jsnap._replace(node_idle=ni, node_used=nu)
    table, res = check_warm(snap2, jconfig, rows, table,
                            make_plan(P, row_map=np.arange(P), changed=[3]), W, K,
                            "displacement merge")
    full2 = jax.device_get(jasg.allocate_solve(snap2, jconfig))
    assert np.array_equal(np.asarray(res.assigned), np.asarray(full2.assigned))
    ni3, nu3 = snap2.node_idle.copy(), snap2.node_used.copy()
    nu3[3] += ni3[3]
    ni3[3] = 0.0
    snap3 = snap2._replace(node_idle=ni3, node_used=nu3)
    check_warm(snap3, jconfig, rows, table,
               make_plan(P, row_map=np.arange(P), changed=[3]), W, K, "erosion cut")


def test_warm_solve_erosion_and_task_rerank_match_jax():
    """A W=2 table whose most popular head node turns unschedulable (rows
    flagged eroded), then a row whose request doubles re-ranked alone —
    result, table and erosion flags equal to the JAX package's."""
    jsnap, jconfig = session_snapshot(400, 16, 5)
    P, K, W = 512, 2, 2
    rows = pend_rows_of(jsnap, P)
    live = int((rows >= 0).sum())
    plan0 = make_plan(P, rerank_rows=rows[:live], rerank_slots=np.arange(live), r_slots=P)
    table, _ = check_warm(jsnap, jconfig, rows, zero_table(P, W), plan0, W, K, "build")
    top = int(np.bincount(table[0][:live, 0]).argmax())
    ns = jsnap.node_sched.copy()
    ns[top] = False
    snap2 = jsnap._replace(node_sched=ns)
    (_, _, jer), _ = both_warm(snap2, jconfig, rows, table,
                               make_plan(P, row_map=np.arange(P), changed=[top]), W, K)
    assert jer[:live].any(), "no row flagged eroded after its table head died"
    table, _ = check_warm(snap2, jconfig, rows, table,
                          make_plan(P, row_map=np.arange(P), changed=[top]), W, K,
                          "erosion")
    slot = live // 2
    req = snap2.task_req.copy()
    req[rows[slot]] *= 2.0
    snap3 = snap2._replace(task_req=req)
    check_warm(snap3, jconfig, rows, table,
               make_plan(P, row_map=np.arange(P), rerank_rows=[rows[slot]],
                         rerank_slots=[slot]), W, K, "task re-rank")


# --------------------------------------------------------------------------
# the host half: the planner and the dispatch over churn, both packages
# --------------------------------------------------------------------------


def churn_events(jcache, rng, serial: int, cycle: int) -> list:
    """One cycle's churn, decided on the JAX cache (the JAX package's
    ``tests/test_warm.py`` ``_churn`` plus a kubelet step): bound pods of
    one job start Running, one all-bound gang completes, one gang of 2
    arrives, and every third cycle a node's label changes (a node feature
    delta)."""
    import dataclasses

    from kube_batch_tpu.api.pod import GROUP_NAME_ANNOTATION, Pod, PodGroup
    from kube_batch_tpu.api.types import PodPhase

    events = []
    for key in sorted(jcache.pods):
        pod = jcache.pods[key]
        if pod.phase == PodPhase.PENDING and pod.node_name is not None:
            events.append(("update_pod", dataclasses.replace(pod, phase=PodPhase.RUNNING)))
            if len(events) >= 6:
                break
    for uid, job in sorted(jcache.jobs.items()):
        pods = [jcache.pods.get(key) for key in sorted(job.tasks)]
        if pods and all(p is not None and p.node_name for p in pods):
            events += [("delete_pod", p) for p in pods]
            events.append(("delete_pod_group", uid))
            break
    events.append(("add_pod_group", PodGroup(
        name=f"wm{serial}", namespace="warm", min_member=2,
        queue=f"q{serial % 2}", creation_index=30_000 + serial)))
    for k in range(2):
        events.append(("add_pod", Pod(
            name=f"wm{serial}-{k}", namespace="warm",
            requests={"cpu": float(rng.choice([250.0, 500.0, 1000.0])),
                      "memory": float(2 ** 30)},
            annotations={GROUP_NAME_ANNOTATION: f"wm{serial}"},
            phase=PodPhase.PENDING, creation_index=(30_000 + serial) * 10 + k)))
    if cycle % 3 == 2:
        node = jcache.nodes[sorted(jcache.nodes)[cycle % len(jcache.nodes)]].node
        events.append(("update_node", dataclasses.replace(
            node, labels={**node.labels, "zone": f"z{cycle}"})))
    return events


@pytest.fixture
def warm_env(monkeypatch):
    for k in ("KB_TOPK", "KB_WARM", "KB_GUARD", "KB_SHARD"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KB_SHARD", "0")


def record_plans(monkeypatch, cls, sink: list) -> None:
    """Wrap ``cls.plan`` to append every plan's arrays and record."""
    real = cls.plan

    def plan(self, *args, **kw):
        out = real(self, *args, **kw)
        sink.append(None if out is None else dict(
            {k: np.array(out[k]) for k in ("row_map", "changed", "rerank_rows",
                                            "rerank_slots")},
            cold=bool(out["cold"]), w=int(out["w"]), last=dict(self.last)))
        return out

    monkeypatch.setattr(cls, "plan", plan)


@pytest.mark.parametrize("conf", ["default", "shipped"])
def test_warm_cycles_match_jax_and_the_cold_leg(conf, warm_env, monkeypatch):
    """Eight churn cycles on a contended cluster (760 pods, 36 nodes, a
    standing backlog) fed to a JAX cache and two port caches: each cycle
    the port's plan arrays, ``last_warm``, carried table and erosion flags
    equal the JAX package's, its decisions equal the JAX package's and its
    own ``KB_WARM=0`` leg's; the merge path engages and re-ranks fewer
    rows than the live bucket."""
    from kube_batch_tpu.api.resident import WarmTableState as JaxWarm
    from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
    from kube_batch_tpu_torch.api.resident import WarmTableState as PortWarm
    from kube_batch_tpu_torch.scheduler import Scheduler
    from test_torch_cycle import CONFS, _synthetic, apply, observed

    import kube_batch_tpu_torch.testing.synthetic as port_synth

    jcache, pcache = _synthetic(n_tasks=760, n_nodes=36, gang_size=4, n_queues=2, seed=0)
    ccache = port_synth.synthetic_cluster(n_tasks=760, n_nodes=36, gang_size=4,
                                          n_queues=2, seed=0)
    jconf, pconf = CONFS[conf]()
    jsched = JaxScheduler(jcache, conf=jconf)
    psched = Scheduler(pcache, conf=pconf, device="cpu")
    csched = Scheduler(ccache, conf=pconf, device="cpu")
    jalloc = next(a for a in jsched.actions if a.name == "allocate")
    palloc = next(a for a in psched.actions if a.name == "allocate")
    jplans, pplans = [], []
    record_plans(monkeypatch, JaxWarm, jplans)
    record_plans(monkeypatch, PortWarm, pplans)
    rng = np.random.default_rng(11)
    merges = partial = 0
    for cycle in range(8):
        where = f"{conf} cycle {cycle}"
        jplans.clear()
        pplans.clear()
        jsched.run_once()
        jcache.flush_binds()
        psched.run_once()
        monkeypatch.setenv("KB_WARM", "0")
        csched.run_once()
        monkeypatch.delenv("KB_WARM")
        want = observed(jcache)
        for name, cache in (("port", pcache), ("port KB_WARM=0", ccache)):
            got = observed(cache)
            for key in want:
                assert got[key] == want[key], f"{where}: {name} {key} differ"
        assert len(pplans) == len(jplans), where
        for p, j in zip(pplans, jplans):
            assert (p is None) == (j is None), where
            if j is None:
                continue
            for key in ("row_map", "changed", "rerank_rows", "rerank_slots"):
                assert np.array_equal(p[key], j[key]), f"{where}: plan {key}"
            assert (p["cold"], p["w"], p["last"]) == (j["cold"], j["w"], j["last"]), where
        assert palloc.last_warm == jalloc.last_warm, where
        jst = jcache.columns._warm_tables.get((None, None))
        pst = pcache.columns._warm_tables.get(CPU)
        assert (jst is None or jst.table is None) == (pst is None or pst.table is None), where
        if pst is not None and pst.table is not None:
            for name, a, b in zip(("idx", "skey", "hash", "trunc"), pst.table, jst.table):
                assert_same(a, b, f"{where}: carried {name}")
            assert_same(pst.eroded_dev, jst.eroded_dev, f"{where}: eroded")
        lw = palloc.last_warm
        if lw is not None and not lw["cold"]:
            merges += 1
            partial += lw["reranked"] < lw["bucket_live"]
        assert pcache.columns.check_consistency(pcache) == [], where
        events = churn_events(jcache, rng, cycle + 1, cycle)
        apply(jcache, pcache, events)
        from test_torch_cycle import mirror
        for kind, obj in events:
            getattr(ccache, kind)(mirror(obj))
    assert merges > 0, "the carried table never took the merge path"
    assert partial > 0, "every merge re-ranked the whole bucket"
    assert pcache.guard_plane.trips_total == 0
    jcache.stop()


def test_warm_table_dropped_on_axis_growth_and_resident_drop(warm_env):
    """Task- and node-axis growth and ``drop_resident`` (the guard heal)
    drop the carried table wholesale."""
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    cols = synthetic_cluster(n_tasks=200, n_nodes=16, gang_size=4, n_queues=2,
                             seed=0).columns
    st = cols.warm_table_state(CPU)
    assert cols.warm_table_state("cpu") is st
    cols.reserve(n_tasks=cols.tasks.cap + 1)
    assert not cols._warm_tables, "task growth kept the carried table"
    cols.warm_table_state(CPU)
    cols.reserve(n_nodes=cols.nodes.cap + 1)
    assert not cols._warm_tables, "node growth kept the carried table"
    st = cols.warm_table_state(CPU)
    cols.drop_resident()
    assert not cols._warm_tables, "drop_resident kept the carried table"
    assert cols.warm_table_state(CPU) is not st


def test_warm_table_dropped_with_a_failed_swap_and_a_device_change(warm_env, monkeypatch):
    """A failed swap (``resident_snap`` drops the residency) and a device
    change of the per-cycle cache drop the carried table; a swap that
    completes feeds the state its delta record."""
    from kube_batch_tpu_torch.api import resident as president
    from kube_batch_tpu_torch.api.columns import resident_snap
    from kube_batch_tpu_torch.framework.conf import load_scheduler_conf
    from kube_batch_tpu_torch.framework.session import close_session, open_session
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    cache = synthetic_cluster(n_tasks=200, n_nodes=16, gang_size=4, n_queues=2, seed=0)
    cols = cache.columns
    ssn = open_session(cache, load_scheduler_conf(None).tiers, "cpu")
    try:
        snap, _ = cols.device_snapshot(ssn)
        st = cols.warm_table_state(CPU)
        resident_snap(cols, snap, "cpu")
        assert st._absorbed_version == cols._per_cycle_dev[CPU].version == 1
        # a repeat of the same snapshot is memoized and absorbs nothing new
        resident_snap(cols, snap, "cpu")
        assert st._absorbed_version == 1
        # the state of another device goes when the cache changes device
        cols._warm_tables[torch.device("meta")] = object()
        cols._per_cycle_dev[torch.device("meta")] = object()
        del cols._per_cycle_dev[CPU]
        snap2, _ = cols.device_snapshot(ssn)
        resident_snap(cols, snap2, "cpu")
        assert torch.device("meta") not in cols._warm_tables
        assert cols._warm_tables.get(CPU) is st
        snap3, _ = cols.device_snapshot(ssn)
        monkeypatch.setattr(president.StagedUpload, "run",
                            lambda self: (_ for _ in ()).throw(RuntimeError("boom")))
        with pytest.raises(RuntimeError, match="boom"):
            resident_snap(cols, snap3, "cpu")
        assert not cols._warm_tables
    finally:
        close_session(ssn)


def test_warm_plan_declines_without_an_absorbed_swap(warm_env):
    """A state that has not absorbed the current resident swap (a broken
    delta chain, e.g. ``KB_DEVICE_CACHE=0``) refuses to plan, and the
    dispatch builds cold."""
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    cols = synthetic_cluster(n_tasks=200, n_nodes=16, gang_size=4, n_queues=2,
                             seed=0).columns
    st = cols.warm_table_state(CPU)
    rows = np.full(64, -1, np.int32)
    rows[:4] = [0, 1, 2, 3]
    assert st.plan(cols, rows, 4, AllocateConfig()) is None


@pytest.mark.parametrize("raw,on", [(None, True), ("", True), ("1", True), ("true", True),
                                    ("ON", True), ("yes", True), ("0", False),
                                    ("off", False), ("offf", False), ("2", False)])
def test_kb_warm_reader(raw, on, monkeypatch):
    """Empty, 1, true, on and yes turn the carry on; anything else turns
    it off (a mistyped disable must not leave it on) — the JAX package's
    ``resolve_warm``, unlike the port's kill switches."""
    from kube_batch_tpu.actions.allocate import resolve_warm as jax_resolve_warm
    from kube_batch_tpu_torch.actions.allocate import resolve_warm

    if raw is None:
        monkeypatch.delenv("KB_WARM", raising=False)
    else:
        monkeypatch.setenv("KB_WARM", raw)
    assert resolve_warm() is on
    assert jax_resolve_warm() is on
