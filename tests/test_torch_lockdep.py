"""The port's runtime lock checker (``kube_batch_tpu_torch/analysis/
lockdep.py``), case for case with ``tests/test_lockdep.py``: the synthetic
A→B/B→A inversion and the lock-held-across-sleep case must be caught;
consistent ordering and reentrant acquires must stay clean.

Every test here builds a PRIVATE LockdepState — the one the module fixture
installed watches the real port objects and must never see these provoked
violations.  No JAX is imported (``test_torch_lockdep_jax.py`` holds the
two checkers side by side)."""

import threading

from kube_batch_tpu_torch.analysis import lockdep
from kube_batch_tpu_torch.analysis.lockdep import LockdepState, TrackedLock
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


def _locks(state, *sites):
    return [TrackedLock(state, site) for site in sites]


class TestOrderInversion:
    def test_ab_ba_inversion_is_flagged(self):
        state = LockdepState()
        a, b = _locks(state, "mod.cache:10", "mod.volume:20")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        kinds = [v.kind for v in state.violations]
        assert kinds == ["order-inversion"]
        assert "mod.cache:10" in state.violations[0].description
        assert "mod.volume:20" in state.violations[0].description
        # both acquisition stacks are carried for diagnosis
        assert "first observed at" in state.violations[0].stack

    def test_inversion_across_threads_is_flagged(self):
        state = LockdepState()
        a, b = _locks(state, "A", "B")

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        th1 = threading.Thread(target=t1)
        th1.start()
        th1.join()
        th2 = threading.Thread(target=t2)
        th2.start()
        th2.join()
        assert [v.kind for v in state.violations] == ["order-inversion"]

    def test_consistent_order_is_clean(self):
        state = LockdepState()
        a, b, c = _locks(state, "A", "B", "C")
        for _ in range(3):
            with a:
                with b:
                    with c:
                        pass
        assert state.violations == []
        assert ("A", "B") in state.edges and ("B", "C") in state.edges

    def test_same_instance_reentrant_rlock_is_clean(self):
        state = LockdepState()
        r = TrackedLock(state, "R", reentrant=True)
        with r:
            with r:
                pass
        assert state.violations == []
        assert state.edges == {}

    def test_same_site_nesting_without_declaration_is_flagged(self):
        # two instances of one lock class have no defined order, so
        # undeclared nesting reports
        state = LockdepState()
        x1 = TrackedLock(state, "S")
        x2 = TrackedLock(state, "S")
        with x1:
            with x2:
                pass
        assert [v.kind for v in state.violations] == ["same-site-nesting"]
        assert "S" in state.violations[0].description
        assert "allow_nesting" in state.violations[0].description
        # no self-edge enters the order graph (it would be an instant cycle)
        assert ("S", "S") not in state.edges

    def test_same_site_nesting_reported_once_per_site(self):
        state = LockdepState()
        x1 = TrackedLock(state, "S")
        x2 = TrackedLock(state, "S")
        for _ in range(3):
            with x1:
                with x2:
                    pass
        assert len(state.violations) == 1

    def test_allow_nesting_declares_the_order(self):
        from kube_batch_tpu_torch.utils.blocking import allow_nesting

        state = LockdepState()
        x1 = TrackedLock(state, "S")
        x2 = TrackedLock(state, "S")
        with allow_nesting("aggregate lock order: acquired sorted by uid"):
            with x1:
                with x2:
                    pass
        assert state.violations == []

    def test_allow_nesting_requires_a_reason(self):
        import pytest

        from kube_batch_tpu_torch.utils.blocking import allow_nesting

        with pytest.raises(ValueError):
            with allow_nesting("  "):
                pass

    def test_allow_nesting_does_not_sanction_blocking(self):
        # the two annotations are separate switches: a nesting-sanctioned
        # region still reports blocking-under-lock
        from kube_batch_tpu_torch.utils.blocking import allow_nesting

        state = LockdepState()
        x1 = TrackedLock(state, "S")
        x2 = TrackedLock(state, "S")
        with allow_nesting("declared nesting for this test"):
            with x1:
                with x2:
                    state.on_blocking_call("time.sleep(0.1)")
        assert [v.kind for v in state.violations] == ["blocking-under-lock"]

    def test_cross_site_order_still_checked_inside_allow_nesting(self):
        # the annotation declares SAME-site nesting only; a cross-site
        # inversion inside the region must still report
        from kube_batch_tpu_torch.utils.blocking import allow_nesting

        state = LockdepState()
        a, b = _locks(state, "A", "B")
        with a:
            with b:
                pass
        with allow_nesting("same-site declaration must not mask this"):
            with b:
                with a:
                    pass
        assert [v.kind for v in state.violations] == ["order-inversion"]

    def test_transitive_three_lock_cycle_is_flagged(self):
        # A→B, B→C recorded with no direct two-lock inversion anywhere;
        # the closing C→A edge completes A→B→C→A and must report with the
        # full chain
        state = LockdepState()
        a, b, c = _locks(state, "mod.cache:1", "mod.volume:2", "mod.server:3")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with a:
                pass
        kinds = [v.kind for v in state.violations]
        assert kinds == ["order-inversion"]
        v = state.violations[0]
        assert "transitive" in v.description
        for site in ("mod.cache:1", "mod.volume:2", "mod.server:3"):
            assert site in v.description
        # every chain edge carries its first-observed stack for diagnosis
        assert v.stack.count("first observed at") == 2

    def test_transitive_dag_without_cycle_is_clean(self):
        # A→B, B→C, A→C is a DAG — consistent global order, no report
        state = LockdepState()
        a, b, c = _locks(state, "A", "B", "C")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with a:
            with c:
                pass
        assert state.violations == []

    def test_transitive_cycle_reported_once(self):
        state = LockdepState()
        a, b, c = _locks(state, "A", "B", "C")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        for _ in range(3):
            with c:
                with a:
                    pass
        # the closing edge is recorded on first sight; repeats are cache
        # hits in the unlocked probe and must not re-report
        assert len(state.violations) == 1

    def test_duplicate_inversions_not_double_reported(self):
        state = LockdepState()
        a, b = _locks(state, "A", "B")
        with a:
            with b:
                pass
        for _ in range(3):
            with b:
                with a:
                    pass
        # the b->a edge is recorded after the first report, so the
        # inversion fires once, not once per repetition
        assert len(state.violations) == 1


class TestBlockingUnderLock:
    def test_sleep_while_holding_lock_is_flagged(self):
        state = LockdepState()
        (a,) = _locks(state, "mod.server:30")
        with a:
            state.on_blocking_call("time.sleep(0.1)")
        assert [v.kind for v in state.violations] == ["blocking-under-lock"]
        assert "mod.server:30" in state.violations[0].description

    def test_sleep_outside_lock_is_clean(self):
        state = LockdepState()
        (a,) = _locks(state, "A")
        with a:
            pass
        state.on_blocking_call("time.sleep(0.1)")
        assert state.violations == []

    def test_release_order_need_not_be_lifo(self):
        state = LockdepState()
        a, b = _locks(state, "A", "B")
        a.acquire()
        b.acquire()
        a.release()
        state.on_blocking_call("time.sleep(0.1)")  # still holds B
        b.release()
        state.on_blocking_call("time.sleep(0.1)")  # holds nothing
        assert len(state.violations) == 1
        assert "B" in state.violations[0].description


class TestInstallation:
    def test_module_runs_under_the_port_checker(self):
        # the port_lockdep fixture installed the checker for this module;
        # a lock created here (a test module) is a real primitive
        import os

        if os.environ.get("KBT_LOCKDEP", "1").lower() in ("0", "false", "no"):
            return
        assert lockdep.current_state() is not None
        lk = threading.Lock()
        assert not isinstance(lk, TrackedLock)

    def test_module_lock_swap_keeps_mutual_exclusion(self):
        # a module-level lock held on another thread across install (and
        # the tracked one across uninstall) still excludes the other side
        from kube_batch_tpu_torch.obs import trace

        was = lockdep.uninstall()
        original = trace._ATTACH_LOCK
        held, release = threading.Event(), threading.Event()

        def hold(lock):
            with lock:
                held.set()
                release.wait(5)

        try:
            t = threading.Thread(target=hold, args=(original,))
            t.start()
            assert held.wait(5)
            lockdep.install(state=LockdepState())
            tracked = trace._ATTACH_LOCK
            assert isinstance(tracked, TrackedLock)
            assert tracked.acquire(timeout=0.05) is False
            release.set()
            t.join(5)
            assert tracked.acquire(timeout=5) is True
            tracked.release()

            held.clear()
            release.clear()
            t = threading.Thread(target=hold, args=(tracked,))
            t.start()
            assert held.wait(5)
            lockdep.uninstall()
            assert trace._ATTACH_LOCK is original
            assert original.acquire(timeout=0.05) is False
            release.set()
            t.join(5)
            assert original.acquire(timeout=5) is True
            original.release()
        finally:
            release.set()
            lockdep.uninstall()
            if was is not None:
                lockdep.install(state=was)

    def test_tracked_lock_api_matches_threading(self):
        state = LockdepState()
        lk = TrackedLock(state, "A")
        assert lk.acquire() is True
        assert lk.locked()
        lk.release()
        assert not lk.locked()
        assert lk.acquire(blocking=False) is True
        lk.release()
        with lk as got:
            assert got is lk

    def test_condition_over_a_tracked_rlock_waits_and_notifies(self):
        state = LockdepState()
        cond = threading.Condition(TrackedLock(state, "C", reentrant=True))
        box = []

        def waiter():
            with cond:
                with cond:  # reentrant: wait releases every level
                    cond.wait_for(lambda: box, timeout=5)

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            box.append(1)
            cond.notify_all()
        t.join(timeout=5)
        assert not t.is_alive()
        assert state.violations == []
        assert state.held_sites() == []


class TestPipelineLockRegistration:
    """The pipelined loop's locks must be REGISTERED with the runtime
    checker (created inside tracked modules → TrackedLock),
    and its documented order — cache big lock → trigger condition guard,
    with the ingest-staging buffer and dispatch-futures mutex as leaves —
    must hold; the reverse nesting is exactly what lockdep would report."""

    def test_pipeline_locks_are_tracked(self):
        import os

        if os.environ.get("KBT_LOCKDEP", "1").lower() in ("0", "false", "no"):
            return
        from kube_batch_tpu_torch.cache.cache import SchedulerCache
        from kube_batch_tpu_torch.scheduler import CycleTrigger

        cache = SchedulerCache()
        trig = CycleTrigger()
        # cache/cache.py and scheduler.py are tracked module prefixes: the
        # staging buffer lock, the dispatch-futures mutex, and the trigger's
        # explicitly created condition guard all instrument
        assert isinstance(cache._ingest_lock, TrackedLock)
        assert isinstance(cache._dispatch_mu, TrackedLock)
        assert isinstance(trig._cond._lock, TrackedLock)

    def test_big_lock_to_trigger_order_is_clean(self):
        """Model the real order on a private state: notify() fires under
        the big lock (the dirty-advance hook), wait_for_work holds only the
        condition guard.  Consistent → no violations."""
        state = LockdepState()
        big = TrackedLock(state, "cache.cache:big", reentrant=True)
        cond = TrackedLock(state, "scheduler:trigger-cond")
        staging = TrackedLock(state, "cache.cache:ingest-staging")
        # ingest thread: staging alone, then the wake outside it
        with staging:
            pass
        with cond:
            pass
        # dirty-advance wake: big → cond
        with big:
            with cond:
                pass
        # cycle thread: big alone (drain), cond alone (wait)
        with big:
            pass
        with cond:
            pass
        assert state.violations == []

    def test_reverse_nesting_would_be_flagged(self):
        state = LockdepState()
        big = TrackedLock(state, "cache.cache:big", reentrant=True)
        cond = TrackedLock(state, "scheduler:trigger-cond")
        with big:
            with cond:
                pass
        # a trigger callback that re-entered the cache would invert it
        with cond:
            with big:
                pass
        assert [v.kind for v in state.violations] == ["order-inversion"]


class TestLockProfile:
    """Lock-hold / contention profiling on TrackedLock (the ROADMAP's
    'striped per-kind ingest locks (profile first)' item): acquire-wait
    and hold times accumulate per lock class, merged across threads."""

    def test_hold_time_recorded(self):
        import time as _t

        state = LockdepState()
        (lk,) = _locks(state, "mod.cache:1")
        with lk:
            _t.sleep(0.01)
        rec = state.profile_report()["mod.cache:1"]
        assert rec["acquires"] == 1
        assert rec["hold_ms_total"] >= 8.0
        assert rec["hold_ms_max"] >= 8.0
        assert rec["wait_ms_total"] < 8.0, "uncontended acquire ~free"

    def test_contended_acquire_records_wait(self):
        import time as _t

        state = LockdepState()
        (lk,) = _locks(state, "mod.cache:2")
        entered = threading.Event()

        def holder():
            with lk:
                entered.set()
                _t.sleep(0.05)

        t = threading.Thread(target=holder)
        t.start()
        entered.wait(timeout=5)
        with lk:          # blocks until the holder releases
            pass
        t.join(timeout=5)
        rec = state.profile_report()["mod.cache:2"]
        assert rec["acquires"] == 2
        assert rec["wait_ms_max"] >= 20.0, (
            "the contended acquire's wait must be attributed"
        )

    def test_reentrant_acquires_count_once_for_hold(self):
        state = LockdepState()
        lk = TrackedLock(state, "mod.cache:3", reentrant=True)
        with lk:
            with lk:
                pass
        rec = state.profile_report()["mod.cache:3"]
        assert rec["acquires"] == 2      # each acquire's wait is recorded
        assert rec["hold_ms_total"] >= 0.0

    def test_suite_installed_state_profiles_cache_locks(self):
        """The fixture-installed checker carries the profile too — the
        port cache's big lock shows up after any ingest."""
        import pytest as _pytest

        from kube_batch_tpu_torch.api.pod import Queue
        from kube_batch_tpu_torch.cache.cache import SchedulerCache

        state = lockdep.current_state()
        if state is None:
            _pytest.skip("lockdep disabled (KBT_LOCKDEP=0)")
        cache = SchedulerCache()
        cache.add_queue(Queue(name="lp", uid="ulp", weight=1))
        prof = state.profile_report()
        assert any("kube_batch_tpu_torch.cache.cache" in site for site in prof), (
            "the cache big lock's class must appear in the merged profile"
        )


class TestChipDrive:
    """``chip_smoke.py``'s ``lockdep`` phase drive at a small size on the
    CPU, under this module's checker: every threaded surface of one
    standalone server, no violation, the four hot structures
    instrumented, the gate walked."""

    def test_lock_drive_runs_clean(self, monkeypatch):
        import kube_batch_tpu_torch.actions.enqueue as enqueue
        from kube_batch_tpu_torch.testing.lock_drive import FOLLOW_RECORDS, drive_lockdep

        gate_rows = []
        execute = enqueue.EnqueueAction.execute

        def counted(self, ssn):
            execute(self, ssn)
            gate_rows.append(self.last_gate_rows)

        monkeypatch.setattr(enqueue.EnqueueAction, "execute", counted)
        r = drive_lockdep(1024, 256, device="cpu")
        assert r["violations"] == 0, r["violation_descriptions"]
        assert r["guarded"] == 4
        assert r["bound"] == 1024 + r["arrivals"]
        assert r["follower"]["applied"] >= FOLLOW_RECORDS
        assert r["whatif_statuses"] == [200] * 4
        assert sum(gate_rows) > 0
        assert r["top_wait"] and r["edges"] >= 1
