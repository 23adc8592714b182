"""Tier C of the port's device-program audits (``analysis/memory_audit``):
the single-device registry is clean-or-allowlisted at the audit point on
the CPU, and each rule catches its planted bug — a program over the
budget, a task × node plane in a steady program, an in-place update that
allocated the resident's size, and a per-round move between mesh
positions that carries the node axis.  Mirrors ``tests/test_hbm_audit.py``
case for case where a case has a port meaning."""

from __future__ import annotations

import pytest
import torch

from kube_batch_tpu_torch.analysis.memory_audit import (
    GIB,
    H100_BYTES,
    HBM_ALLOWLIST,
    HBM_RULES,
    ShapePoint,
    audit_entry_at,
    axis_dims,
    budget_bytes,
    glob_match,
    headroom_report,
    run_memory_audit,
    shape_points,
)
from kube_batch_tpu_torch.analysis.program_audit import (
    AUDIT_POINT,
    REGISTRY,
    EntryPoint,
    point_data,
)
from kube_batch_tpu_torch.parallel.mesh import make_mesh
from kube_batch_tpu_torch.parallel.shard_solve import Collectives
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

# a fixture point with unambiguous axis extents: task dims {4096, 2048,
# 1024}, node dims {512, 256} (T/8 = 512 collides with N and the node axis
# claims it), as the JAX tier's fixture
_SP = ShapePoint(
    name="fixture", tasks=4000, nodes=500, T=4096, N=512, J=8, Q=2, R=3, W=1,
    K_aff=1, P=1024, topk=2, warm_w=4, warm_c=4, warm_pi=4, probe_b=2, probe_g=4,
    scatter_rows=8,
)


def _entry(name, fn, args, **kw):
    return EntryPoint(name=name, build=lambda sp, dev: (fn, args), **kw)


def _rules(report):
    return [r for r, _ in report.findings]


def _tn_outer():
    # materialises a [T, N] outer product — the planted full-matrix plane
    return lambda a, b: (a[:, None] * b[None, :]).sum(), (torch.ones(4096), torch.ones(512))


def _tn_entry(name="planted.tn", **kw):
    fn, args = _tn_outer()
    return _entry(name, fn, args, **kw)


class _Resident:
    def __init__(self):
        self.t = torch.zeros(4096, dtype=torch.float32)

    def resident(self, field):
        return self.t


def _round_moves(mesh, rows, per_round=True, rounds=3):
    """A tail that sends a [rows, 3] ledger slice to every position each
    round (or once, per solve)."""
    acct = Collectives(mesh, "planted")
    idle = torch.ones(rows * mesh.size, 3)
    for r in range(rounds if per_round else 1):
        if per_round:
            acct.rounds += 1
        for j, d in enumerate(mesh.devices):
            part = idle[j * rows:(j + 1) * rows]
            if per_round:
                acct.move(part, d)
            else:
                acct.note("per_solve", "all_gather", part)
    return acct


class TestShapeLadder:
    def test_three_points_including_the_north_star(self):
        pts = {sp.name: sp for sp in shape_points()}
        assert len(pts) >= 3
        ns = pts["northstar-1m"]
        assert ns.tasks == 1_000_000 and ns.nodes == 100_000
        assert ns.T >= 1_000_000 and ns.N >= 100_000
        assert ns.P <= ns.T // 4
        assert "headline-50k" in pts and "bench-20k" in pts

    def test_the_audit_point_separates_task_and_node_extents(self):
        """KBT202 and KBT204 need both axes recognised at the audit point:
        T and P on the task side, N and every shard's width on the node
        side, nothing shared."""
        task, node = axis_dims(AUDIT_POINT)
        sp = AUDIT_POINT
        assert {sp.T, sp.P} <= task
        assert {sp.N, sp.N // 2, sp.N // 4, sp.N // 8} <= node
        assert not task & node

    def test_the_audit_points_data_has_its_extents(self):
        d = point_data(AUDIT_POINT, "cpu")
        s = d.snap
        sp = AUDIT_POINT
        assert s.task_req.shape == (sp.T, sp.R) and s.node_idle.shape == (sp.N, sp.R)
        assert s.job_min_avail.shape == (sp.J,) and s.queue_weight.shape == (sp.Q,)
        assert s.node_label_bits.shape == (sp.N, sp.W) and s.task_aff_mask.shape[0] == sp.K_aff
        # the bucket covers every schedulable pending row
        tj = s.task_job.long()
        live = s.task_pending & s.job_schedulable[tj]
        rows = d.pend_rows[d.pend_rows >= 0].long()
        assert int(live.sum()) == rows.numel() and bool(live[rows].all())


class TestSelfEnforcement:
    def test_single_device_registry_clean_at_the_audit_point(self):
        findings = run_memory_audit(registry=tuple(REGISTRY), device="cpu")
        assert findings == [], "\n" + "\n".join(f.render() for f in findings)

    def test_steady_entries_hold_the_sparse_contract(self):
        """The only KBT202 waivers are the named corners (evict bids, the
        topk and warm build planes), the only KBT204 waivers the sharded
        tail's ledger slices, and every waiver names its ROADMAP item."""
        for e_pat, rule, _pt in HBM_ALLOWLIST:
            if rule == "KBT202":
                assert "evict" in e_pat or "topk" in e_pat or "warm" in e_pat, e_pat
            if rule == "KBT204":
                assert e_pat.startswith("parallel.mesh."), e_pat
        for key, reason in HBM_ALLOWLIST.items():
            assert "ROADMAP" in reason, key


class TestPlantedBugs:
    def test_planted_over_budget_program_is_detected(self):
        rep = audit_entry_at(_tn_entry("planted.big"), _SP, budget=1024, label="1 KiB (test)", device="cpu")
        assert _rules(rep) == ["KBT201"]
        assert "exceed" in rep.findings[0][1] and "fixture" in rep.findings[0][1]

    def test_planted_tn_temporary_in_a_steady_program_is_detected(self):
        rep = audit_entry_at(_tn_entry(steady=True), _SP, device="cpu")
        assert _rules(rep) == ["KBT202"]
        msg = rep.findings[0][1]
        assert "T=4096" in msg and "N=512" in msg

    def test_the_same_plane_passes_when_not_steady(self):
        rep = audit_entry_at(_tn_entry("planted.cold"), _SP, device="cpu")
        assert rep.traced and _rules(rep) == []

    def test_compacted_geometry_steady_program_passes(self):
        rep = audit_entry_at(_entry("planted.sparse", lambda t: (t * 2.0).sum(dim=1),
                                    (torch.ones(1024, 2),), steady=True), _SP, device="cpu")
        assert rep.traced and _rules(rep) == []

    def test_planted_resident_sized_allocation_is_detected(self):
        def refresh(r):
            r.t.copy_(r.t + 1.0)  # the update built whole, then copied in

        rep = audit_entry_at(_entry("planted.alloc", refresh, (_Resident(),),
                                    in_place=("t",)), _SP, device="cpu")
        assert _rules(rep) == ["KBT203"]
        assert "allocated" in rep.findings[0][1]

    def test_in_place_update_passes(self):
        def refresh(r):
            r.t.index_copy_(0, torch.arange(3), torch.ones(3))

        rep = audit_entry_at(_entry("planted.inplace", refresh, (_Resident(),),
                                    in_place=("t",)), _SP, device="cpu")
        assert rep.traced and _rules(rep) == []

    def test_planted_node_scaled_round_move_is_detected(self):
        mesh = make_mesh(["cpu"] * 2)
        rep = audit_entry_at(_entry("planted.move", _round_moves, (mesh, 256)), _SP, device="cpu")
        assert _rules(rep) == ["KBT204"]
        msg = rep.findings[0][1]
        assert "move" in msg and "N/2=256" in msg and "6,144 B a round" in msg

    def test_per_solve_gather_passes(self):
        # the same ledger moved once per solve is the allowed pattern
        mesh = make_mesh(["cpu"] * 2)
        rep = audit_entry_at(_entry("planted.solve", _round_moves, (mesh, 256, False)), _SP, device="cpu")
        assert rep.traced and _rules(rep) == []

    def test_task_scaled_round_move_passes(self):
        # O(tasks) a round is the contract
        mesh = make_mesh(["cpu"] * 2)
        rep = audit_entry_at(_entry("planted.tasks", _round_moves, (mesh, 1024)), _SP, device="cpu")
        assert rep.traced and _rules(rep) == [] and rep.round_move_bytes == 2 * 1024 * 12

    def test_broken_entry_names_the_shape_point_instead_of_crashing(self):
        def build(sp, dev):
            raise ValueError("shape-derived python branch blew up")

        rep = audit_entry_at(EntryPoint("planted.broken", build), _SP, device="cpu")
        assert not rep.traced and _rules(rep) == ["KBT000"]
        assert "failed to run" in rep.findings[0][1] and "fixture" in rep.findings[0][1]
        findings = run_memory_audit(registry=[EntryPoint("planted.broken", build)],
                                    points=[_SP], allowlist={}, device="cpu")
        assert [f.rule for f in findings] == ["KBT000"]


class TestAllowlist:
    def test_allow_with_reason_suppresses(self):
        allow = {("planted.tn", "KBT202", "fixture"): "fixture: deliberate"}
        assert run_memory_audit([_tn_entry(steady=True)], [_SP], allowlist=allow, device="cpu") == []

    def test_allow_without_reason_is_itself_a_finding(self):
        allow = {("planted.tn", "KBT202", "fixture"): "   "}
        findings = run_memory_audit([_tn_entry(steady=True)], [_SP], allowlist=allow, device="cpu")
        assert [f.rule for f in findings] == ["KBT000"]
        assert "no reason" in findings[0].message

    def test_stale_allowlist_entry_is_itself_a_finding(self):
        clean = _entry("planted.clean", lambda x: x + 1.0, (torch.ones(256),), steady=True)
        allow = {("planted.clean", "KBT202", "fixture"): "was fixed"}
        findings = run_memory_audit([clean], [_SP], allowlist=allow, device="cpu")
        assert [f.rule for f in findings] == ["KBT000"]
        assert "stale" in findings[0].message

    def test_uncovered_allowlist_entry_is_not_judged_stale(self):
        # a single-device run must not flag sharded-namespace waivers, nor
        # a run on the card the north star's
        clean = _entry("planted.clean", lambda x: x + 1.0, (torch.ones(256),))
        allow = {("parallel.mesh.not_in_this_run", "KBT202", "*"): "r",
                 ("planted.clean", "KBT201", "northstar-1m"): "r"}
        assert run_memory_audit([clean], [_SP], allowlist=allow, device="cpu") == []

    def test_wildcard_points_cover_the_whole_ladder(self):
        allow = {("planted.tn", "KBT202", "*"): "fixture: deliberate"}
        assert run_memory_audit([_tn_entry(steady=True)], [_SP], allowlist=allow, device="cpu") == []

    def test_select_filters_hbm_rules_but_keeps_meta(self):
        entry = _tn_entry(steady=True)
        assert run_memory_audit([entry], [_SP], allowlist={}, select=["KBT201"], device="cpu") == []
        findings = run_memory_audit([entry], [_SP], allowlist={}, select=["KBT202"], device="cpu")
        assert [f.rule for f in findings] == ["KBT202"]

    def test_glob_matches_literal_brackets(self):
        assert glob_match("ops.eviction.evict_solve[reclaim]", "ops.eviction.evict_solve[*]")
        assert glob_match("ops.eviction.evict_solve[preempt]", "ops.eviction.evict_solve[*]")
        assert not glob_match("ops.eviction.evict_solver", "ops.eviction.evict_solve[*]")
        assert glob_match("parallel.mesh.sharded_allocate_solve[shard_map,2d]",
                          "parallel.mesh.*sharded_allocate_solve[shard_map*]")
        assert not glob_match("parallel.mesh.sharded_allocate_solve[pjit]",
                              "parallel.mesh.*sharded_allocate_solve[shard_map*]")
        assert glob_match("anything at all", "*")
        assert not glob_match("kbt202", "KBT202")


class TestBudget:
    def test_default_budget_is_the_card(self, monkeypatch):
        """No card here: an H100's 80 GB, never a TPU profile."""
        monkeypatch.delenv("KB_HBM_BUDGET", raising=False)
        assert budget_bytes("cpu") == (H100_BYTES, "H100 80 GB")

    def test_profile_override(self, monkeypatch):
        monkeypatch.setenv("KB_HBM_BUDGET", "v6e")
        assert budget_bytes("cpu") == (32 * GIB, "v6e")

    def test_gib_override(self, monkeypatch):
        monkeypatch.setenv("KB_HBM_BUDGET", "24")
        b, label = budget_bytes("cpu")
        assert b == 24 * GIB and "24" in label

    def test_garbage_override_falls_back_hard(self, monkeypatch):
        monkeypatch.setenv("KB_HBM_BUDGET", "plenty")
        assert budget_bytes("cpu") == (H100_BYTES, "H100 80 GB")

    def test_small_budget_judges_the_recorders_live_bytes(self, monkeypatch):
        """On the CPU KBT201 reads the recorder's peak: the [T, N] plane of
        4096 × 512 f32 (8 MiB) and its inputs."""
        monkeypatch.setenv("KB_HBM_BUDGET", "0.0078125")  # 8 MiB
        findings = run_memory_audit([_tn_entry()], [_SP], allowlist={}, device="cpu")
        assert [f.rule for f in findings] == ["KBT201"]
        monkeypatch.setenv("KB_HBM_BUDGET", "0.0079")
        assert run_memory_audit([_tn_entry()], [_SP], allowlist={}, device="cpu") == []


class TestHeadroom:
    def test_in_place_credit_lowers_the_peak(self):
        """An update in place allocates nothing; the same update built
        whole allocates the column (the port's form of the donation
        credit)."""
        x = torch.zeros(1024, 1024)
        inplace = audit_entry_at(_entry("planted.a", lambda t: t.mul_(2.0).add_(1.0), (x,)), _SP, device="cpu")
        whole = audit_entry_at(_entry("planted.b", lambda t: t * 2.0 + 1.0, (x,)), _SP, device="cpu")
        assert inplace.peak_bytes == 4 * 2**20
        assert whole.peak_bytes == inplace.peak_bytes + 2 * 4 * 2**20

    def test_headroom_report_structure(self):
        entry = _entry("planted.report", lambda x: x + 1.0, (torch.ones(256),))
        rep = headroom_report(registry=[entry], points=[_SP], device="cpu")
        assert rep["budget_bytes"] > 0
        d = rep["entries"]["planted.report"]["fixture"]
        assert d["traced"] and d["peak_bytes"] == 2048
        assert d["headroom_bytes"] == rep["budget_bytes"] - d["peak_bytes"]
        assert d["over_budget"] is False and d["findings"] == []
        assert rep["points"][0]["name"] == "fixture"


class TestCatalog:
    def test_hbm_rules_documented(self):
        assert set(HBM_RULES) == {"KBT201", "KBT202", "KBT203", "KBT204"}
        assert all(HBM_RULES.values())


@pytest.mark.parametrize("mode", ["reclaim", "preempt"])
def test_sharded_evict_moves_only_task_vectors(mode):
    """The eviction tail sends task vectors back each round, no ledger:
    its entries need no KBT204 waiver."""
    from kube_batch_tpu_torch.analysis.program_audit import run_entry, sharded_registry

    entry = next(e for e in sharded_registry(make_mesh(["cpu"] * 8))
                 if e.name == f"parallel.mesh.sharded_evict_solve[{mode}][shard_map]")
    run = run_entry(entry, AUDIT_POINT, "cpu")
    moves = [s for s in run.sites if s["kind"] == "move"]
    assert moves and all(s["shape"] == (AUDIT_POINT.T,) for s in moves)
