"""Tier D of the port's analyzer (``kube_batch_tpu_torch/analysis/races.py``),
case for case with ``tests/test_races.py``: per-rule planted fixtures with
a true negative each, the suppression contract, the --domains report, CLI
routing/alias/exit-code parity, the self-enforcement check that keeps the
port race-clean, and the runtime guarded-access corroborator (including
the planted unguarded access it must catch).  No JAX is imported."""

import json
import textwrap
import threading

import pytest

from kube_batch_tpu_torch.analysis import check_source, run_paths
from kube_batch_tpu_torch.analysis import lockdep
from kube_batch_tpu_torch.analysis.races import (
    RACE_RULES, RACE_RULES_BY_ID, RULE_ALIASES, module_domains,
    domains_report, runtime_domain_specs,
)
from kube_batch_tpu_torch.utils import blocking
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


def findings_for(src: str, relpath: str = "serve/x.py"):
    return check_source(textwrap.dedent(src), relpath, rules=RACE_RULES)


def rule_ids(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# KBT301 — shared attribute accessed off its inferred lock domain
# ---------------------------------------------------------------------------


class TestKBT301:
    BAD = """
    import threading

    class Worker:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

        def _run(self):
            while True:
                self.count += 1

        def snapshot(self):
            with self._lock:
                return self.count
    """

    def test_lock_free_write_on_worker_root_triggers(self):
        findings = findings_for(self.BAD)
        assert rule_ids(findings) == ["KBT301"]
        assert "_lock" in findings[0].message

    def test_guarded_everywhere_is_clean(self):
        src = self.BAD.replace(
            "            while True:\n                self.count += 1",
            "            while True:\n                with self._lock:\n"
            "                    self.count += 1",
        )
        assert findings_for(src) == []

    def test_wrong_lock_is_still_a_finding(self):
        src = """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self._other = threading.Lock()
                self.count = 0
                t = threading.Thread(target=self._run)
                t.start()

            def _run(self):
                with self._other:
                    self.count += 1

            def snapshot(self):
                with self._lock:
                    return self.count
        """
        findings = findings_for(src)
        assert rule_ids(findings) == ["KBT301"]
        assert "instead" in findings[0].message

    def test_init_writes_are_exempt(self):
        # construction happens-before every spawn — __init__ accesses are
        # never findings (the BAD fixture's __init__ writes don't report)
        findings = findings_for(self.BAD)
        assert all(f.line > 10 for f in findings)

    def test_single_root_class_is_clean(self):
        # no second thread root -> nothing is concurrent, even unguarded
        src = """
        import threading

        class Tally:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def _bump(self):
                self.count += 1

            def _read(self):
                with self._lock:
                    return self.count
        """
        assert findings_for(src) == []


# ---------------------------------------------------------------------------
# KBT302 — publish-then-mutate handoff (generalized StatusFlush contract)
# ---------------------------------------------------------------------------


class TestKBT302:
    def test_live_container_submitted_then_mutated_triggers(self):
        src = """
        import threading

        class Producer:
            def __init__(self, pool):
                self._lock = threading.Lock()
                self.buf = []
                self.pool = pool

            def flush(self):
                self.pool.submit(self._consume, self.buf)
                with self._lock:
                    self.buf.append(1)

            def _consume(self, items):
                return len(items)
        """
        findings = findings_for(src)
        assert rule_ids(findings) == ["KBT302"]

    def test_snapshot_handoff_under_lock_is_clean(self):
        src = """
        import threading

        class Producer:
            def __init__(self, pool):
                self._lock = threading.Lock()
                self.buf = []
                self.pool = pool

            def flush(self):
                with self._lock:
                    snap = list(self.buf)
                self.pool.submit(self._consume, snap)

            def _consume(self, items):
                return len(items)
        """
        assert findings_for(src) == []

    def test_thread_args_publication_triggers(self):
        src = """
        import threading

        class Producer:
            def __init__(self):
                self._lock = threading.Lock()
                self.buf = []

            def go(self):
                t = threading.Thread(target=consume, args=(self.buf,))
                t.start()
                with self._lock:
                    self.buf.append(1)
        """
        findings = findings_for(src)
        assert "KBT302" in rule_ids(findings)


class TestKBT302Legacy:
    """The writeback-stage contract KBT302 grew from (formerly KBT012):
    the overlapped stage may only touch the value-snapshotted StatusFlush
    handoff, never the live stores."""

    def test_writeback_reading_live_jobs_triggers(self):
        src = """
        class SchedulerCache:
            def run_status_flush(self, flush):
                for pg in flush.to_write:
                    self.status_updater.update_pod_group(pg)
                for uid in self.jobs:
                    pass
        """
        assert rule_ids(findings_for(src, "cache/cache.py")) == ["KBT302"]

    def test_worker_body_reading_cache_columns_triggers(self):
        src = """
        class Scheduler:
            def _writeback(self, flush):
                if flush:
                    self.cache.run_status_flush(flush)
                self.cache.columns.j_touched.fill(False)
        """
        assert rule_ids(findings_for(src, "scheduler.py")) == ["KBT302"]

    def test_snapshotted_handoff_is_clean(self):
        src = """
        class SchedulerCache:
            def run_status_flush(self, flush):
                updater = self.status_updater
                for pg in flush.to_write:
                    updater.update_pod_group(pg)
                for name, c in flush.qwrites:
                    updater.update_queue_status(name, c)
        """
        assert findings_for(src, "cache/cache.py") == []

    def test_out_of_scope_unflagged(self):
        src = """
        def run_status_flush(self, flush):
            return self.jobs
        """
        assert findings_for(src, "sim/runner.py") == []

    def test_legacy_allow_comment_still_suppresses(self):
        # migration contract: an allow written against the old id keeps
        # suppressing the rule it migrated into
        src = """
        class SchedulerCache:
            def run_status_flush(self, flush):
                # kbt: allow[KBT012] frozen at stage time, stage owns it
                for uid in self.jobs:
                    pass
        """
        assert findings_for(src, "cache/cache.py") == []


# ---------------------------------------------------------------------------
# KBT303 — check-then-act outside the guarding lock
# ---------------------------------------------------------------------------


class TestKBT303:
    def test_lock_free_check_then_act_triggers(self):
        src = """
        import threading

        class Broker:
            def __init__(self):
                self._lock = threading.Lock()
                self.pending = []
                t = threading.Thread(target=self._drain)
                t.start()

            def _drain(self):
                if self.pending:
                    self.pending.pop()

            def add(self, x):
                with self._lock:
                    self.pending.append(x)
        """
        findings = findings_for(src)
        assert rule_ids(findings) == ["KBT303"]
        assert "interleave" in findings[0].message

    def test_check_then_act_under_the_lock_is_clean(self):
        src = """
        import threading

        class Broker:
            def __init__(self):
                self._lock = threading.Lock()
                self.pending = []
                t = threading.Thread(target=self._drain)
                t.start()

            def _drain(self):
                with self._lock:
                    if self.pending:
                        self.pending.pop()

            def add(self, x):
                with self._lock:
                    self.pending.append(x)
        """
        assert findings_for(src) == []


# ---------------------------------------------------------------------------
# KBT304 — unguarded lazy init
# ---------------------------------------------------------------------------


class TestKBT304:
    def test_unguarded_lazy_init_triggers(self):
        src = """
        import threading

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self._table = None
                t = threading.Thread(target=self._refresh)
                t.start()

            def _refresh(self):
                if self._table is None:
                    self._table = dict()

            def get(self):
                with self._lock:
                    return self._table
        """
        findings = findings_for(src)
        assert rule_ids(findings) == ["KBT304"]
        assert "lazy init" in findings[0].message

    def test_double_checked_init_is_clean(self):
        # the sanctioned idiom: lock-free reference peek, re-verified
        # under the lock before the write
        src = """
        import threading

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self._table = None
                t = threading.Thread(target=self._refresh)
                t.start()

            def _refresh(self):
                if self._table is None:
                    with self._lock:
                        if self._table is None:
                            self._table = dict()

            def get(self):
                with self._lock:
                    return self._table
        """
        assert findings_for(src) == []

    def test_fully_guarded_lazy_init_is_clean(self):
        src = """
        import threading

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self._table = None
                t = threading.Thread(target=self._refresh)
                t.start()

            def _refresh(self):
                with self._lock:
                    if self._table is None:
                        self._table = dict()

            def get(self):
                with self._lock:
                    return self._table
        """
        assert findings_for(src) == []


# ---------------------------------------------------------------------------
# suppression contract
# ---------------------------------------------------------------------------


class TestSuppression:
    def test_allow_with_reason_suppresses(self):
        src = TestKBT301.BAD.replace(
            "self.count += 1",
            "self.count += 1  # kbt: allow[KBT301] stat counter, torn "
            "reads tolerated",
        )
        assert findings_for(src) == []

    def test_allow_without_reason_does_not_suppress(self):
        # a reasonless allow[] is ignored AND reported
        src = TestKBT301.BAD.replace(
            "self.count += 1",
            "self.count += 1  # kbt: allow[KBT301]",
        )
        assert rule_ids(findings_for(src)) == ["KBT000", "KBT301"]

    def test_allow_for_a_different_rule_does_not_suppress(self):
        src = TestKBT301.BAD.replace(
            "self.count += 1",
            "self.count += 1  # kbt: allow[KBT304] wrong rule id",
        )
        assert "KBT301" in rule_ids(findings_for(src))

    def test_pytest_only_roots_are_excluded(self):
        # testing/ spawns threads for harnesses — tier D skips the tree
        assert findings_for(TestKBT301.BAD, "testing/harness.py") == []


# ---------------------------------------------------------------------------
# the --domains report (the reviewable inference)
# ---------------------------------------------------------------------------


class TestDomains:
    def test_module_domains_infer_the_dominating_lock(self):
        doms = module_domains(
            textwrap.dedent(TestKBT301.BAD), "serve/x.py")
        dom = next(d for d in doms if d.attr == "count")
        assert dom.cls == "Worker"
        assert dom.lock == "_lock"
        assert dom.written
        assert any(r.startswith("worker:") for r in dom.roots)

    def test_package_report_names_the_hot_structures(self):
        report = domains_report()
        assert "SchedulerCache" in report
        assert "_ingest_staged" in report
        assert "_ingest_lock" in report
        assert "LeaseBroker" in report

    def test_runtime_specs_resolve_against_the_static_map(self):
        specs = runtime_domain_specs([
            ("kube_batch_tpu_torch.cache.cache", "SchedulerCache",
             "_ingest_staged"),
        ])
        assert specs == [("kube_batch_tpu_torch.cache.cache", "SchedulerCache",
                          "_ingest_staged", "_ingest_lock")]

    def test_runtime_specs_raise_on_static_drift(self):
        with pytest.raises(LookupError):
            runtime_domain_specs([
                ("kube_batch_tpu_torch.cache.cache", "SchedulerCache",
                 "no_such_attribute"),
            ])

    def test_plugin_hot_structure_table_has_not_drifted(self):
        # the corroborator's instrumentation table must stay resolvable
        # against the static inference (LookupError here = drift)
        from kube_batch_tpu_torch.analysis.pytest_plugin import HOT_STRUCTURES

        specs = runtime_domain_specs(HOT_STRUCTURES)
        assert len(specs) == len(HOT_STRUCTURES)


# ---------------------------------------------------------------------------
# CLI: --races/--races-only, select routing, alias, exit codes, jsonl
# ---------------------------------------------------------------------------


class TestRacesCli:
    def _main(self, *args):
        from kube_batch_tpu_torch.analysis import __main__ as cli

        return cli.main(list(args))

    @pytest.fixture()
    def bad_file(self, tmp_path):
        p = tmp_path / "racy.py"
        p.write_text(textwrap.dedent(TestKBT301.BAD))
        return str(p)

    def test_races_only_reports_and_exits_one(self, bad_file, capsys):
        assert self._main("--races-only", bad_file) == 1
        out = capsys.readouterr().out
        assert "KBT301" in out

    def test_races_only_clean_package_exits_zero(self, capsys):
        assert self._main("--races-only", "kube_batch_tpu_torch/analysis") == 0
        assert "clean" in capsys.readouterr().out

    def test_select_race_id_implies_the_tier(self, bad_file, capsys):
        # a KBT30x selection routes to tier D without an explicit --races
        assert self._main("--select", "KBT301", bad_file) == 1
        out = capsys.readouterr().out
        assert "KBT301" in out

    def test_select_other_race_rule_filters(self, bad_file):
        assert self._main("--select", "KBT303", bad_file) == 0

    def test_kbt012_alias_selects_kbt302(self, tmp_path, capsys):
        p = tmp_path / "cache"
        p.mkdir()
        f = p / "cache.py"
        f.write_text(textwrap.dedent("""
        class SchedulerCache:
            def run_status_flush(self, flush):
                return self.jobs
        """))
        assert self._main("--select", "KBT012", str(f)) == 1
        out = capsys.readouterr().out
        assert "KBT302" in out

    def test_jsonl_parses_and_carries_the_rule(self, bad_file, capsys):
        assert self._main("--races-only", "--jsonl", bad_file) == 1
        rows = [json.loads(line)
                for line in capsys.readouterr().out.splitlines() if line]
        assert rows and all(r["rule"] == "KBT301" for r in rows)

    def test_unknown_rule_is_a_usage_error(self):
        assert self._main("--select", "KBT399") == 2

    def test_nonexistent_path_reports_not_clean(self, capsys):
        assert self._main("--races-only", "/nonexistent/z.py") == 1
        assert "KBT000" in capsys.readouterr().out

    def test_broken_module_reports_not_clean(self, tmp_path, capsys):
        p = tmp_path / "broken.py"
        p.write_text("def f(:\n")
        assert self._main("--races-only", str(p)) == 1
        assert "KBT000" in capsys.readouterr().out

    def test_domains_flag_prints_the_map(self, capsys):
        assert self._main("--domains") == 0
        out = capsys.readouterr().out
        assert "SchedulerCache" in out and "_ingest_lock" in out

    def test_list_rules_includes_tier_d_and_alias(self, capsys):
        assert self._main("--list-rules") == 0
        out = capsys.readouterr().out
        for rid in RACE_RULES_BY_ID:
            assert rid in out
        assert "KBT012" in out and "alias" in out

    def test_static_only_select_skips_the_race_tier(self, monkeypatch):
        # mirror of the tier-B/C contract: a KBT001-only selection must
        # not run tier D only to discard its findings
        import kube_batch_tpu_torch.analysis.__main__ as cli

        calls = []
        real = cli.run_paths

        def spy(paths=None, rules=None):
            calls.append([r.id for r in (rules or [])])
            return real(paths, rules=rules)

        monkeypatch.setattr(cli, "run_paths", spy)
        assert self._main("--races", "--select", "KBT001",
                          "kube_batch_tpu_torch/analysis") == 0
        assert all("KBT301" not in ids for ids in calls)


# ---------------------------------------------------------------------------
# tier-1 self-enforcement: the package is race-clean
# ---------------------------------------------------------------------------


class TestSelfEnforcement:
    def test_package_is_race_clean(self):
        findings = run_paths(rules=list(RACE_RULES))
        assert findings == [], "\n" + "\n".join(
            f.render() for f in findings)

    def test_alias_table_points_at_live_rules(self):
        for alias, target in RULE_ALIASES.items():
            assert target in RACE_RULES_BY_ID
            assert alias not in RACE_RULES_BY_ID

    def test_every_rule_has_title_and_grounding_doc(self):
        for rule in RACE_RULES:
            assert rule.title
            assert rule.__doc__ and len(rule.__doc__.strip()) > 40


# ---------------------------------------------------------------------------
# runtime corroborator (lockdep.install_guarded_access)
# ---------------------------------------------------------------------------


class _PlantedBox:
    """Corroborator fixture: a lock-owning class the tests instrument
    against a private LockdepState (never the module fixture's)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._items = []


class TestGuardedAccessCorroborator:
    @pytest.fixture()
    def instrumented(self):
        state = lockdep.LockdepState()
        inst = lockdep.install_guarded_access(
            [(__name__, "_PlantedBox", "_items", "_lock")], state=state)
        try:
            yield state
        finally:
            inst.uninstall()

    @staticmethod
    def _share(box):
        # touch from a second thread (under the lock — itself clean) so
        # the instance counts as shared and enforcement arms
        def toucher():
            with box._lock:
                box._items.append("shared")

        t = threading.Thread(target=toucher)
        t.start()
        t.join()

    def test_planted_unguarded_access_is_caught(self, instrumented):
        box = _PlantedBox()
        self._share(box)
        box._items.append("unguarded")  # planted violation
        kinds = [v.kind for v in instrumented.violations]
        assert kinds == ["unguarded-access"]
        assert "_items" in instrumented.violations[0].description
        assert "_lock" in instrumented.violations[0].description

    def test_guarded_access_is_clean(self, instrumented):
        box = _PlantedBox()
        self._share(box)
        with box._lock:
            box._items.append("guarded")
        assert instrumented.violations == []

    def test_thread_confined_instance_never_enforces(self, instrumented):
        box = _PlantedBox()
        box._items.append(1)  # only ever one thread — no enforcement
        assert instrumented.violations == []

    def test_allow_unguarded_region_is_exempt(self, instrumented):
        box = _PlantedBox()
        self._share(box)
        with blocking.allow_unguarded("test: torn read tolerated"):
            box._items.append("sanctioned")
        assert instrumented.violations == []

    def test_allow_unguarded_requires_a_reason(self):
        with pytest.raises(ValueError):
            with blocking.allow_unguarded(""):
                pass

    def test_violations_dedupe_per_class_attr(self, instrumented):
        box = _PlantedBox()
        self._share(box)
        box._items.append(1)
        box._items.append(2)
        assert len(instrumented.violations) == 1

    def test_uninstall_restores_plain_attribute_access(self):
        state = lockdep.LockdepState()
        inst = lockdep.install_guarded_access(
            [(__name__, "_PlantedBox", "_items", "_lock")], state=state)
        box = _PlantedBox()
        box._items.append(1)
        inst.uninstall()
        assert "_items" not in vars(_PlantedBox)
        assert box._items == [1]  # value survived in the instance dict
