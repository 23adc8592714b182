"""Tier B of the port's device-program audits (``analysis/program_audit``):
the registries run clean on the CPU, each rule catches its planted bug,
suppressions need a reason, and the recorder counts what a hand-written
program does.  Mirrors ``tests/test_jaxpr_audit.py`` case for case where a
case has a port meaning; the CLI's exit codes for every rule of both
tiers are here too.  No JAX is imported: the card's half (marked
``cuda``) runs on the card's machine."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.analysis import __main__ as cli
from kube_batch_tpu_torch.analysis import memory_audit, program_audit
from kube_batch_tpu_torch.analysis.program_audit import (
    AUDIT_POINT,
    AUDIT_RULES,
    REGISTRY,
    EntryPoint,
    audit_entry,
    run_audit,
    run_entry,
    sharded_registry,
)
from kube_batch_tpu_torch.analysis.recorder import Recorder
from kube_batch_tpu_torch.parallel.mesh import make_mesh
from kube_batch_tpu_torch.utils import seams
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


def _entry(name, fn, args, **kw):
    return EntryPoint(name=name, build=lambda sp, dev: (fn, args), **kw)


def _vec():
    return torch.arange(8, dtype=torch.float32)


def _rules(findings):
    return [f.rule for f in findings]


class _Resident:
    """A resident tensor an in-place program updates (``args[0]``)."""

    def __init__(self):
        self.t = torch.zeros(64, dtype=torch.float32)

    def resident(self, field):
        return self.t


# --------------------------------------------------------------------------
# the registries
# --------------------------------------------------------------------------


class TestRegistryClean:
    def test_cli_runs_both_registries_clean_on_the_cpu(self, capsys):
        """``--programs --memory --device cpu`` over the single-device
        registry and the sharded one on an eight-position CPU mesh (and its
        2 × 4 grid): exit 0."""
        rc = cli.main(["--programs", "--memory", "--device", "cpu"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert out.strip().endswith("kbt-audit: clean")

    def test_registry_covers_the_hot_path(self):
        names = {e.name for e in REGISTRY}
        for part in ("allocate_solve", "allocate_topk_solve", "warm_allocate_solve",
                     "evict_solve", "resident", "masked_best_node_raw",
                     "masked_topk_blocks", "enqueue_gate", "topk-inert",
                     "failure_histogram_bucket_solve", "sentinel"):
            assert any(part in n for n in names), part

    def test_sharded_variants_on_the_cpu_mesh(self):
        """Both implementations of every sharded solve, the gate, both mesh
        scatters, and the (tasks=2) grid's body on the 2 × 4 mesh."""
        sharded = sharded_registry(make_mesh(["cpu"] * 8))
        names = {e.name for e in sharded}
        for impl in ("shard_map", "pjit"):
            assert f"parallel.mesh.sharded_allocate_solve[{impl}]" in names
            assert f"parallel.mesh.sharded_evict_solve[reclaim][{impl}]" in names
            assert f"parallel.mesh.sharded_probe_solve[{impl}]" in names
        assert "parallel.mesh.sharded_allocate_solve[shard_map,2d]" in names
        assert {"api.resident.scatter_sharded", "api.resident.scatter_repl"} <= names
        grid = next(e for e in sharded if e.name.endswith("[shard_map,2d]"))
        run = run_entry(grid, AUDIT_POINT, "cpu")
        assert not run.error and run.rec.opaque["masked_best_node_raw"] == 8 * run.rec.rounds

    def test_budgets_are_one_readback_per_round(self):
        """PERF.md's contract, per entry: the full solve reads back once a
        round (plus its outer passes), the compacted and warm ones twice."""
        by = {e.name: e for e in REGISTRY}
        assert by["ops.assignment.allocate_solve"].syncs == (3, 1)
        assert by["ops.assignment.allocate_topk_solve"].syncs == (3, 2)
        assert by["ops.eviction.evict_solve[reclaim]"].syncs == (0, 1)
        assert by["ops.admission.enqueue_gate"].syncs == (0, 0)
        run = run_entry(by["ops.assignment.allocate_solve"], AUDIT_POINT, "cpu")
        rounds = run.rec.rounds
        assert rounds > 1 and rounds <= len(run.rec.syncs) <= rounds + 3
        assert run.rec.opaque["masked_best_node_raw"] == rounds


# --------------------------------------------------------------------------
# planted bugs
# --------------------------------------------------------------------------


class TestPlantedBugs:
    def test_planted_f64_upcast_is_detected(self):
        findings = audit_entry(_entry("planted.f64", lambda x: x.double() * 2.0, (_vec(),)), device="cpu")
        assert _rules(findings) == ["KBT101"]
        assert "float64" in findings[0].message

    def test_planted_astype_f64_is_detected(self):
        findings = audit_entry(_entry("planted.astype", lambda x: x.to(torch.float64).sum(),
                                      (_vec(),)), device="cpu")
        assert _rules(findings) == ["KBT101"]

    def test_planted_transfer_to_meta_is_detected(self):
        """On the CPU the one transfer a program can make is to another
        device type."""
        findings = audit_entry(_entry("planted.transfer", lambda x: x.to("meta") + 1.0,
                                      (_vec(),)), device="cpu")
        assert _rules(findings) == ["KBT102"]
        assert "cpu->meta" in findings[0].message

    def test_declared_upload_passes(self):
        findings = audit_entry(_entry("planted.upload", lambda x: x.to("meta"), (_vec(),),
                                      uploads=1), device="cpu")
        assert findings == []

    def test_planted_host_sync_is_detected(self):
        def f(x):
            return x * 2.0 if bool(x.sum() > 0) else x

        findings = audit_entry(_entry("planted.sync", f, (_vec(),)), device="cpu")
        assert _rules(findings) == ["KBT103"]
        assert "scalar_read" in findings[0].message

    def test_planted_data_dependent_shape_is_detected(self):
        findings = audit_entry(_entry("planted.mask", lambda x: x[x > 3.0], (_vec(),)), device="cpu")
        assert _rules(findings) == ["KBT103"]
        assert "dynamic_shape" in findings[0].message

    def test_zero_d_index_is_a_readback(self):
        """Indexing with a 0-d tensor reads it back first; a [1] index does
        not (the probe's queue lookups)."""
        q = torch.tensor(2)
        assert _rules(audit_entry(_entry("planted.0d", lambda x, i: x[i], (_vec(), q)), device="cpu")) \
            == ["KBT103"]
        assert audit_entry(_entry("planted.1d", lambda x, i: x[i.reshape(1)][0],
                                  (_vec(), q)), device="cpu") == []

    def test_round_budget_is_per_round(self):
        def rounds(x, n, reads):
            for _ in range(n):
                for _ in range(reads - 1):
                    bool(x.any())
                seams.round_end(x.any())
            return x

        ok = _entry("planted.rounds", rounds, (_vec(), 3, 1), syncs=(0, 1))
        assert audit_entry(ok, device="cpu") == []
        bad = _entry("planted.rounds2", rounds, (_vec(), 3, 2), syncs=(0, 1))
        findings = audit_entry(bad, device="cpu")
        assert _rules(findings) == ["KBT103"] and "over 3 round(s)" in findings[0].message

    def test_planted_in_place_move_is_detected(self):
        def swap(r, v):
            r.t = r.t + v  # a new tensor, not an in-place update
            return r.t

        findings = audit_entry(_entry("planted.move", swap, (_Resident(), 1.0),
                                      in_place=("t",)), device="cpu")
        assert _rules(findings) == ["KBT104"]

    def test_declared_in_place_update_passes(self):
        def swap(r, v):
            return r.t.add_(v)

        assert audit_entry(_entry("planted.inplace", swap, (_Resident(), 1.0),
                                  in_place=("t",)), device="cpu") == []

    def test_kernel_wrapper_is_opaque(self):
        """What a kernel's plain version does inside stays out; its outputs
        are charged."""
        @seams.opaque
        def kernel(x):
            bool(x.double().sum() > 0)  # the plain version's business
            return x * 2.0

        rec_entry = _entry("planted.kernel", kernel, (_vec(),))
        assert audit_entry(rec_entry, device="cpu") == []
        run = run_entry(rec_entry, AUDIT_POINT, "cpu")
        assert run.rec.opaque == {"kernel": 1}
        assert run.rec.allocations == [32]

    def test_broken_entry_reports_instead_of_reading_clean(self):
        def build(sp, dev):
            raise RuntimeError("registry rot")

        findings = audit_entry(EntryPoint("planted.broken", build), device="cpu")
        assert _rules(findings) == ["KBT000"]
        assert "failed to run" in findings[0].message


class TestSuppression:
    def _f64_entry(self, allow):
        return _entry("planted.sup", lambda x: x.double(), (_vec(),), allow=allow)

    def test_allow_with_reason_suppresses(self):
        assert audit_entry(self._f64_entry({"KBT101": "fixture: deliberate upcast"}), device="cpu") == []

    def test_allow_without_reason_is_itself_a_finding(self):
        assert _rules(audit_entry(self._f64_entry({"KBT101": "  "}), device="cpu")) == ["KBT000"]

    def test_select_filters_audit_rules(self):
        entry = self._f64_entry({})
        assert run_audit(registry=[entry], select=["KBT102"], device="cpu") == []
        assert _rules(run_audit(registry=[entry], select=["KBT101"], device="cpu")) == ["KBT101"]


class TestCatalog:
    def test_audit_rules_documented(self):
        assert set(AUDIT_RULES) == {"KBT101", "KBT102", "KBT103", "KBT104"}
        assert all(AUDIT_RULES.values())

    def test_list_rules(self, capsys):
        assert cli.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        assert all(r in out for r in list(AUDIT_RULES) + list(memory_audit.HBM_RULES))


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------


class TestRecorder:
    def test_live_bytes_and_peak_of_a_hand_computed_program(self):
        x = torch.zeros(1024, dtype=torch.float32)            # 4 096 B input

        def prog(x):
            a = torch.empty(2048, dtype=torch.float32)         # +8 192 → 12 288
            del a                                              # −8 192 → 4 096
            b = x + 1.0                                        # +4 096 → 8 192
            c = b.view(32, 32)                                 # a view: no bytes
            return c.add_(1.0)                                 # in place: no bytes

        rec = Recorder("cpu")
        rec.charge(x)
        with rec:
            out = prog(x)
        assert rec.input_bytes == 4096
        assert rec.allocations == [8192, 4096]
        assert rec.peak == 12288
        assert rec.live == 8192
        assert out.shape == (32, 32)
        assert rec.syncs == [] and rec.transfers == []

    def test_a_host_copy_of_a_cpu_tensor_is_no_event(self):
        rec = Recorder("cpu")
        with rec:
            _vec().cpu()
            _vec().numpy()
        assert rec.syncs == [] and rec.transfers == []

    def test_seams_are_off_outside_a_recording(self):
        assert seams.round_end(torch.tensor(True)) is True
        rec = Recorder("cpu")
        with rec:
            seams.round_end(torch.tensor(False))
        seams.round_end(torch.tensor(True))
        assert rec.rounds == 1 and len(rec.syncs) == 1


# --------------------------------------------------------------------------
# the CLI: every rule's planted bug exits 1 with its id
# --------------------------------------------------------------------------


def _plane(sp, dev):
    return lambda a, b: (a[:, None] * b[None, :]).sum(), (
        torch.ones(sp.T), torch.ones(sp.N))


def _planted(rule):
    """A registry of one entry that trips ``rule`` at the audit point."""
    if rule == "KBT101":
        return [_entry("planted.101", lambda x: x.double(), (_vec(),))]
    if rule == "KBT102":
        return [_entry("planted.102", lambda x: x.to("meta"), (_vec(),))]
    if rule == "KBT103":
        return [_entry("planted.103", lambda x: bool(x.any()), (_vec(),))]
    if rule == "KBT104":
        return [_entry("planted.104", lambda r: setattr(r, "t", r.t + 1.0), (_Resident(),),
                       in_place=("t",))]
    if rule in ("KBT201", "KBT202"):
        return [EntryPoint(f"planted.{rule[3:]}", _plane, steady=rule == "KBT202")]
    if rule == "KBT203":
        def refill(r):
            r.t.copy_(torch.zeros_like(r.t))  # a resident-sized buffer
        return [_entry("planted.203", refill, (_Resident(),), in_place=("t",))]
    if rule == "KBT204":
        return [_entry("planted.204", _node_scaled_round_moves, (make_mesh(["cpu"] * 8),))]
    raise AssertionError(rule)


def _node_scaled_round_moves(mesh, rounds=3):
    """A sharded body whose tail sends an [N/8, R] ledger slice back to
    every position each round."""
    from kube_batch_tpu_torch.parallel.shard_solve import Collectives

    acct = Collectives(mesh, "planted")
    idle = torch.ones(AUDIT_POINT.N, AUDIT_POINT.R)
    n_loc = AUDIT_POINT.N // 8
    for _ in range(rounds):
        acct.rounds += 1
        for j, d in enumerate(mesh.devices):
            acct.move(idle[j * n_loc:(j + 1) * n_loc], d)
    return acct


@pytest.mark.parametrize("rule", ["KBT101", "KBT102", "KBT103", "KBT104",
                                  "KBT201", "KBT202", "KBT203", "KBT204"])
def test_cli_exits_1_with_the_rule_id(rule, monkeypatch, capsys):
    monkeypatch.setattr(program_audit, "default_registry", lambda device: _planted(rule))
    if rule == "KBT201":
        monkeypatch.setenv("KB_HBM_BUDGET", str(64 / 2**30))  # 64 B
    tier = "--programs" if rule.startswith("KBT10") else "--memory"
    rc = cli.main([tier, "--device", "cpu", "--jsonl"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rc == 1
    assert [r["rule"] for r in rows] == [rule]


def test_cli_usage_errors_exit_2(capsys):
    assert cli.main(["--select", "KBT999", "--device", "cpu"]) == 2
    assert cli.main(["--device", "cpu"]) == 2
    assert cli.main(["--no-such-flag"]) == 2
    capsys.readouterr()


def test_cli_select_routes_ids_to_their_tier(monkeypatch, capsys):
    """KBT10x ids run tier B only; a selection without them skips it."""
    monkeypatch.setattr(program_audit, "default_registry", lambda device: _planted("KBT101"))
    assert cli.main(["--select", "KBT101", "--device", "cpu", "--jsonl"]) == 1
    assert cli.main(["--select", "KBT202", "--device", "cpu", "--jsonl"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["rule"] for r in rows] == ["KBT101"]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the audit's card half times and counts on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_registries_clean_on_the_card_and_syncs_match_sync_debug(cuda_device):
    """Every rule judged on the card at the audit point, the sharded
    registry on four positions of the first card; each program's recorded
    syncs equal CUDA's sync-debug count of the same call."""
    registry = tuple(REGISTRY) + sharded_registry(make_mesh(["cuda:0"] * 4))
    runs = {}
    for e in registry:
        runs[(e.name, AUDIT_POINT.name, str(cuda_device))] = run_entry(
            e, AUDIT_POINT, cuda_device, sync_debug=True)
    assert run_audit(registry, cuda_device, runs=runs) == []
    assert memory_audit.run_memory_audit(registry, [AUDIT_POINT], cuda_device, runs=runs) == []
    gaps = {k[0]: (len(r.rec.syncs), r.sync_debug) for k, r in runs.items()
            if len(r.rec.syncs) != r.sync_debug}
    assert gaps == {}
    assert np.all([r.peak_bytes > 0 for r in runs.values()])


# --------------------------------------------------------------------------
# the entry points run on the card unless asked for the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda e: audit_entry(e),
    lambda e: run_audit(registry=[e]),
    lambda e: memory_audit.audit_entry_at(e, AUDIT_POINT),
    lambda e: memory_audit.run_memory_audit([e], [AUDIT_POINT]),
    lambda e: memory_audit.headroom_report([e], [AUDIT_POINT]),
], ids=["audit_entry", "run_audit", "audit_entry_at", "run_memory_audit", "headroom_report"])
def test_entry_points_default_to_the_card(call, monkeypatch):
    """Without ``device``, each of the five entry points asks for CUDA and
    raises on a machine with no card instead of running on the CPU."""
    ran = []
    entry = _entry("planted.cpu", lambda x: ran.append(x.device) or x * 2.0, (_vec(),))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(entry)
    assert ran == []
