"""The port's tracing plane (``kube_batch_tpu_torch/obs``) against the JAX
package's, after ``tests/test_trace.py``'s cases.

Span mechanics (nesting, an exception, the disabled tracer, the implicit
record's roll, virtual-time stamps, a raising attribution probe), the
Chrome export and the validator's verdicts, the flight recorder's windows,
flush and ring bound, and the alert evaluator's firing and resolving run
the same inputs through both packages and compare what comes out.  The
budget-shed and SLO-breach dumps run the same small cluster through both
schedulers: their ``meta.json`` are equal but for times.  Then the port
alone: ``KB_TRACE`` on and off decide identically over seeded churn, the
pipelined writeback span overlaps the next cycle's ``session_open`` in
the exported trace (forced by holding the writeback worker on an event,
not by sleeping), and the decision-latency sink equals the span-stamped
samples on the direct and the staged ingest paths.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time

import numpy as np
import pytest

import kube_batch_tpu.obs.trace as jax_trace
import kube_batch_tpu_torch.obs.trace as port_trace
from kube_batch_tpu import metrics as jax_prom
from kube_batch_tpu.api.pod import GROUP_NAME_ANNOTATION, Node, Pod, PodGroup, Queue
from kube_batch_tpu.api.types import PodPhase
from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
from kube_batch_tpu.framework.conf import load_scheduler_conf as jax_load_conf
from kube_batch_tpu.guard.plane import GuardPlane as JaxGuardPlane
from kube_batch_tpu.obs.alerts import AlertEvaluator as JaxAlerts
from kube_batch_tpu.obs.recorder import FlightRecorder as JaxRecorder
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu.sim.clock import VirtualClock
from kube_batch_tpu_torch import metrics as port_prom
from kube_batch_tpu_torch.api import pod as ppod
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.framework.conf import load_scheduler_conf
from kube_batch_tpu_torch.guard.plane import GuardPlane
from kube_batch_tpu_torch.obs.alerts import AlertEvaluator
from kube_batch_tpu_torch.obs.recorder import FlightRecorder
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_cycle import mirror
from test_torch_metrics import record_tree, recording, span_tree
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

GiB = float(1 << 30)

#: (Tracer, FlightRecorder, chrome_trace, validate_chrome_trace) per package
PKGS = {
    "jax": (jax_trace.Tracer, JaxRecorder, jax_trace.chrome_trace,
            jax_trace.validate_chrome_trace),
    "port": (port_trace.Tracer, FlightRecorder, port_trace.chrome_trace,
             port_trace.validate_chrome_trace),
}


def both(fn):
    """``fn(package name)`` for both packages; the outcomes must be equal."""
    got = {name: fn(name) for name in PKGS}
    assert got["jax"] == got["port"], got
    return got["port"]


def tracer(name, tmp_path, ring=16, post=0, **kw):
    Tr, Rec, _, _ = PKGS[name]
    rec = Rec(ring=ring, directory=str(tmp_path / name), post_cycles=post)
    return Tr(recorder=rec, enabled=True, **kw), rec


def trees(rec) -> list:
    return [record_tree(r) for r in rec.records()]


# --------------------------------------------------------------------------
# span mechanics
# --------------------------------------------------------------------------


class TestSpans:
    def test_nesting_builds_a_tree(self, tmp_path):
        def run(name):
            tr, rec = tracer(name, tmp_path)
            tr.begin_cycle("test")
            with tr.span("outer"):
                with tr.span("inner_a"):
                    pass
                with tr.span("inner_b") as sp:
                    sp.set(k=1)
            tr.end_cycle()
            (r,) = rec.records()
            outer = r.spans[0]
            assert outer.t1 >= outer.children[1].t1 >= outer.children[1].t0 >= outer.t0
            return trees(rec), tr.state()["span_counts"]

        got, counts = both(run)
        assert got[0]["spans"] == [("outer", {}, [("inner_a", {}, []),
                                                  ("inner_b", {"k": 1}, [])])]
        assert counts == {"outer": 1, "inner_a": 1, "inner_b": 1}

    def test_exception_closes_the_span(self, tmp_path):
        def run(name):
            tr, rec = tracer(name, tmp_path)
            tr.begin_cycle("test")
            with pytest.raises(RuntimeError):
                with tr.span("boom"):
                    raise RuntimeError("x")
            tr.end_cycle()
            sp = rec.records()[0].spans[0]
            assert sp.t1 >= sp.t0
            # the per-thread stack unwound: a follow-up span is a root again
            tr.begin_cycle("test2")
            with tr.span("after"):
                pass
            tr.end_cycle()
            return trees(rec)

        got = both(run)
        assert got[0]["spans"] == [("boom", {"error": "RuntimeError"}, [])]
        assert got[1]["spans"] == [("after", {}, [])]

    def test_disabled_tracer_still_times_but_retains_nothing(self, tmp_path):
        def run(name):
            Tr, Rec, _, _ = PKGS[name]
            rec = Rec(ring=4, directory=str(tmp_path / name))
            tr = Tr(recorder=rec, enabled=False)
            tr.begin_cycle("test")
            with tr.span("stage") as sp:
                time.sleep(0.002)
                sp.set(ignored=True)
            tr.end_cycle()
            assert sp.dur_ms > 0, "spans always stamp (metrics feed from them)"
            rec.trigger("never_armed")
            return rec.records(), tr.spans_total, sp.attrs, rec.enabled, rec.stats()["armed"]

        assert both(run) == ([], 0, None, False, 0)

    def test_implicit_record_rolls_over(self, tmp_path):
        def run(name):
            tr, rec = tracer(name, tmp_path)
            for _ in range(PKGS_IMPLICIT_ROLL[name] + 5):
                with tr.span("direct"):
                    pass
            return [(r.reason, len(r.spans)) for r in rec.records()]

        assert both(run) == [("implicit", port_trace.IMPLICIT_ROLL)]

    def test_virtual_time_stamps_follow_the_injected_clock(self, tmp_path):
        def run(name):
            clock = VirtualClock(start=7.0)
            tr, rec = tracer(name, tmp_path, clock=clock)
            tr.begin_cycle("vt")
            with tr.span("stage") as sp:
                clock.sleep(2.5)
            tr.end_cycle()
            d = rec.records()[0].to_dict()
            return sp.vt0, sp.vt1, d["vt0"], d["spans"][0]["vt_dur"]

        assert both(run) == (7.0, 9.5, 7.0, 2.5)

    def test_raising_attribution_probe_leaks_no_stack_entry(self, tmp_path, monkeypatch):
        class Cols:
            def resident_counters(self):
                raise RuntimeError("probe")

        def boom(_cols):
            raise RuntimeError("probe")

        def run(name):
            mod = jax_trace if name == "jax" else port_trace
            tr, rec = tracer(name, tmp_path)
            monkeypatch.setattr(mod, "_scatter_totals", boom)
            tr.begin_cycle("probe")
            with tr.device_span("solve_dispatch", cols=Cols()):
                pass
            with tr.span("after"):
                pass
            tr.end_cycle()
            return trees(rec), len(tr._stack())

        got, depth = both(run)
        assert depth == 0
        assert [s[0] for s in got[0]["spans"]] == ["solve_dispatch", "after"]


PKGS_IMPLICIT_ROLL = {"jax": jax_trace.IMPLICIT_ROLL, "port": port_trace.IMPLICIT_ROLL}


# --------------------------------------------------------------------------
# chrome export and the validator
# --------------------------------------------------------------------------


def _strip_times(doc: dict) -> list:
    return [(e["name"], e["ph"], e.get("args", {}).get("depth"), e.get("args", {}).get("cycle"))
            for e in doc["traceEvents"]]


class TestChromeExport:
    def test_export_of_the_same_spans_has_the_same_events(self, tmp_path):
        def run(name):
            _, _, chrome, validate = PKGS[name]
            tr, rec = tracer(name, tmp_path)
            for c in range(2):
                tr.begin_cycle("t")
                with tr.span("session_open"):
                    with tr.span("plugin:gang.open"):
                        pass
                with tr.span("action:allocate"):
                    pass
                tr.end_cycle()
            doc = chrome(rec.records())
            return validate(doc), _strip_times(doc), doc["displayTimeUnit"]

        errs, events, unit = both(run)
        assert errs == [] and unit == "ms"
        assert ("plugin:gang.open", "X", 1, 1) in events

    @pytest.mark.parametrize("doc", [
        {"traceEvents": [
            {"name": "outer", "ph": "X", "ts": 0.0, "dur": 10.0, "pid": 1, "tid": 1},
            {"name": "child-too-long", "ph": "X", "ts": 5.0, "dur": 50.0, "pid": 1, "tid": 1}]},
        {"traceEvents": [{"name": "n", "ph": "X", "ts": 0.0, "dur": -1.0, "pid": 1, "tid": 1}]},
        {"traceEvents": [{"name": "n", "ph": "X", "ts": float("nan"), "dur": 1.0,
                          "pid": 1, "tid": 1}]},
        {"traceEvents": []},
        {"traceEvents": [
            {"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "pid": 1, "tid": 1},
            {"name": "b", "ph": "X", "ts": 2.0, "dur": 3.0, "pid": 1, "tid": 1},
            {"name": "c", "ph": "X", "ts": 4.0, "dur": 30.0, "pid": 1, "tid": 2}]},
    ], ids=["unbalanced", "negative", "nan", "empty", "valid"])
    def test_validator_verdicts_match(self, doc):
        verdict = both(lambda name: PKGS[name][3](json.loads(json.dumps(doc))))
        assert bool(verdict) == (doc["traceEvents"] == [] or
                                 doc["traceEvents"][-1]["name"] != "c")


# --------------------------------------------------------------------------
# the flight recorder
# --------------------------------------------------------------------------


def normalized_meta(path, racing=()) -> dict:
    """A dump's meta.json without its times, and without the root spans
    named in ``racing`` (a span a worker thread may or may not have added
    when the dump was written)."""
    meta = json.loads((path / "meta.json").read_text())
    # an SLO breach's detail names the worst latency
    meta["detail"] = re.sub(r"decision [0-9.]+ms", "decision <t>ms", meta["detail"])
    meta["tree"] = [{"cycle": r["cycle"], "reason": r["reason"],
                     "spans": [span_tree(s) for s in r["spans"] if s["name"] not in racing],
                     "decisions": len(r.get("attrs", {}).get("decision_lat_ms", ()))}
                    for r in meta["tree"]]
    return meta


class TestFlightRecorder:
    @staticmethod
    def _record(tr):
        tr.begin_cycle("t")
        with tr.span("s"):
            pass
        tr.end_cycle()

    def test_dump_captures_cycles_before_and_after(self, tmp_path):
        def run(name):
            _, _, _, validate = PKGS[name]
            tr, rec = tracer(name, tmp_path, ring=8, post=2)
            for _ in range(5):
                self._record(tr)
            rec.trigger("test_anomaly", detail="planted")
            assert rec.dumps == [], "the dump waits out the post-trigger window"
            for _ in range(2):
                self._record(tr)
            d = tmp_path / name / "flight-test_anomaly-0000"
            doc = json.loads((d / "trace.json").read_text())
            residue = [p.name for p in (tmp_path / name).iterdir() if p.name.startswith(".tmp-")]
            return len(rec.dumps), normalized_meta(d), validate(doc), residue

        n, meta, errs, residue = both(run)
        assert n == 1 and errs == [] and residue == []
        assert (meta["reason"], meta["cycles_before"], meta["cycles_after"]) == \
            ("test_anomaly", 5, 2)

    def test_flush_publishes_armed_captures_and_triggers_coalesce(self, tmp_path):
        def run(name):
            tr, rec = tracer(name, tmp_path, ring=8, post=10)
            self._record(tr)
            rec.trigger("end_of_run")
            rec.trigger("end_of_run")  # coalesced into the armed capture
            armed = rec.stats()["armed"]
            out = rec.flush()
            return armed, len(out), len(rec.dumps), len(rec.stats()["triggers"])

        assert both(run) == (1, 1, 1, 2)

    def test_ring_is_bounded(self, tmp_path):
        def run(name):
            tr, rec = tracer(name, tmp_path, ring=4)
            for _ in range(10):
                self._record(tr)
            st = rec.stats()
            return st["cycles_resident"], st["cycles_recorded"], st["capacity"]

        assert both(run) == (4, 10, 4)


# --------------------------------------------------------------------------
# the same small cluster through both schedulers
# --------------------------------------------------------------------------


def cluster_events(n_nodes=4, n_queues=2):
    events = [("add_queue", Queue(name=f"q{q}", uid=f"uq{q}", weight=q + 1))
              for q in range(n_queues)]
    events += [("add_node", Node(name=f"n{i}", allocatable={
        "cpu": 16000.0, "memory": 64 * GiB, "pods": 110.0})) for i in range(n_nodes)]
    return events


def gang_events(serial, size=2, n_queues=2):
    g = f"g{serial}"
    events = [("add_pod_group", PodGroup(
        name=g, namespace="tr", uid=f"pg-{g}", min_member=size,
        queue=f"q{serial % n_queues}", creation_index=serial))]
    events += [("add_pod", Pod(
        name=f"{g}-{k}", namespace="tr", uid=f"pod-{g}-{k}",
        requests={"cpu": 500.0, "memory": 1 * GiB},
        annotations={GROUP_NAME_ANNOTATION: g}, phase=PodPhase.PENDING,
        creation_index=serial * 100 + k)) for k in range(size)]
    return events


class Pair:
    """A JAX scheduler and a port scheduler over caches built from the same
    events (the JAX package's built-in conf)."""

    def __init__(self):
        self.j, self.p = JaxCache(), SchedulerCache()
        self.apply(cluster_events())
        self.jsched = JaxScheduler(self.j, conf=jax_load_conf(None))
        self.psched = Scheduler(self.p, conf=load_scheduler_conf(None), device="cpu")

    def apply(self, events):
        for kind, obj in events:
            getattr(self.j, kind)(obj)
            getattr(self.p, kind)(mirror(obj))

    def both(self, fn):
        fn(self.jsched)
        fn(self.psched)

    def close(self):
        for s in (self.jsched, self.psched):
            s.close()
            s.cache.stop()


@pytest.fixture
def pair():
    made = []

    def make():
        made.append(Pair())
        return made[-1]

    yield make
    for p in made:
        p.close()


def test_budget_shed_dumps_match_jax(pair, tmp_path, monkeypatch):
    monkeypatch.setenv("KB_CYCLE_BUDGET", "0.000001")
    monkeypatch.setenv("KB_TRACE_POST", "1")
    dumps = {}
    for name in ("jax", "port"):
        monkeypatch.setenv("KB_TRACE_DIR", str(tmp_path / name))
        pr = pair()
        pr.apply(gang_events(1))
        sched = pr.jsched if name == "jax" else pr.psched
        sched.run_once_pipelined()  # overruns the 1 µs budget: a shed
        sched.run_once_pipelined()  # the post-trigger cycle
        sched.drain_pipeline()
        rec = sched.cache.flight_recorder
        assert rec.dumps, "a shed must arm a flight dump"
        assert "budget_shed" in [t["reason"] for t in rec.triggers]
        # the dump is written as the shed cycle's record closes, while that
        # cycle's writeback, just handed to its worker, may still be open
        dumps[name] = normalized_meta(tmp_path / name / "flight-budget_shed-0000",
                                      racing=("writeback",))
    assert dumps["jax"] == dumps["port"]
    assert dumps["port"]["cycles_before"] == 0 and dumps["port"]["cycles_after"] == 1


def test_slo_breach_dumps_match_jax(pair, tmp_path, monkeypatch):
    monkeypatch.setenv("KB_TRACE_SLO_MS", "0.000001")
    # the breach fires mid-cycle (at the bind decision), so the triggering
    # cycle itself is the first post-trigger capture
    monkeypatch.setenv("KB_TRACE_POST", "1")
    dumps = {}
    for name in ("jax", "port"):
        monkeypatch.setenv("KB_TRACE_DIR", str(tmp_path / name))
        pr = pair()
        pr.apply(gang_events(1))
        sched = pr.jsched if name == "jax" else pr.psched
        sched.run_once()
        assert "slo_breach" in [t["reason"] for t in sched.cache.flight_recorder.triggers]
        dumps[name] = normalized_meta(tmp_path / name / "flight-slo_breach-0000")
    assert dumps["jax"] == dumps["port"]
    assert dumps["port"]["tree"][0]["decisions"] == 2


# --------------------------------------------------------------------------
# guard trip-rate alerts
# --------------------------------------------------------------------------

ALERT_PKGS = {"jax": (JaxGuardPlane, JaxAlerts), "port": (GuardPlane, AlertEvaluator)}


class TestAlerts:
    def test_threshold_fires_and_resolves(self):
        def run(name):
            Plane, Alerts = ALERT_PKGS[name]
            gp = Plane(enabled=True, audit_every=0, cooldown=4)
            ev = Alerts(threshold=2, window=4)
            seen = []
            for detail in ("t1", "t2"):
                gp.trip("allocate", ["topk"], reason="invariant", detail=detail)
                gp.end_cycle()
                seen.append(ev.evaluate(gp))
            for _ in range(6):
                gp.end_cycle()
            seen.append(ev.evaluate(gp))
            return seen, ev.state()

        with recording() as logs:
            seen, state = both(run)
        assert seen[0]["guard_trips"] is False, "one trip is under the threshold"
        assert seen[1]["guard_trips"] is True and seen[1]["guard_trips:topk"] is True
        assert seen[2]["guard_trips"] is False, "the window slid past both trips"
        assert state["alerts"]["guard_trips"]["fired_total"] == 1
        assert logs["jax"].summary() == logs["port"].summary()
        sets = logs["port"].summary()["sets"]
        assert sets[("volcano_alerts_firing", ("guard_trips",))] == (3, 0.0)
        assert sets[("volcano_guard_path_demoted", ("topk",))] == (2, 1.0)

    def test_gauge_follows_firing_state(self):
        from kube_batch_tpu_torch.metrics.metrics import ALERTS_FIRING

        gp = GuardPlane(enabled=True, audit_every=0, cooldown=4)
        ev = AlertEvaluator(threshold=1, window=8)
        gp.trip("reclaim", ["warm"], reason="audit", detail="x")
        gp.end_cycle()
        ev.evaluate(gp)
        assert ALERTS_FIRING._values[("guard_trips",)] == 1.0
        assert ALERTS_FIRING._values[("guard_trips:warm",)] == 1.0

    def test_scheduler_cycle_evaluates_alerts_and_a_trip_dumps(self, monkeypatch, tmp_path):
        """The loop evaluates the alerts on the guard's cycle clock, and a
        trip arms the flight recorder beside the guard bundle."""
        monkeypatch.setenv("KB_ALERT_GUARD_TRIPS", "1")
        monkeypatch.setenv("KB_TRACE_POST", "1")
        monkeypatch.setenv("KB_TRACE_DIR", str(tmp_path))
        cache = SchedulerCache()
        for kind, obj in cluster_events() + gang_events(1):
            getattr(cache, kind)(mirror(obj))
        sched = Scheduler(cache, conf=load_scheduler_conf(None), device="cpu")
        try:
            sched.run_once()  # attaches the guard plane through the dispatch
            cache.guard_plane.trip("allocate", ["topk"], reason="invariant",
                                   detail="planted")
            sched.run_once()
            st = cache.alert_evaluator.state()
            assert st["alerts"]["guard_trips"]["firing"] is True
            assert [t["reason"] for t in cache.flight_recorder.triggers] == ["guard_trip"]
            (dump,) = cache.flight_recorder.dumps
            doc = json.loads(open(f"{dump}/trace.json").read())
            assert port_trace.validate_chrome_trace(doc) == []
        finally:
            sched.close()
            cache.stop()


# --------------------------------------------------------------------------
# the port alone: inertness, the overlap, the decision-latency sink
# --------------------------------------------------------------------------


class PortChurn:
    """``tests/test_trace.py``'s seeded churn, decided on the first port
    cache and applied to every cache given."""

    def __init__(self, caches, seed):
        self.caches = caches
        self.rng = np.random.default_rng(seed)
        self.serial = 0
        self.gangs = []

    def apply(self, kind, obj):
        for c in self.caches:
            getattr(c, kind)(dataclasses.replace(obj) if dataclasses.is_dataclass(obj) else obj)

    def add_gang(self):
        self.serial += 1
        g, rng = f"g{self.serial}", self.rng
        size = int(rng.integers(1, 4))
        self.apply("add_pod_group", ppod.PodGroup(
            name=g, namespace="tr", uid=f"pg-{g}", min_member=size,
            queue=f"q{int(rng.integers(2))}", creation_index=self.serial))
        for k in range(size):
            self.apply("add_pod", ppod.Pod(
                name=f"{g}-{k}", namespace="tr", uid=f"pod-{g}-{k}",
                requests={"cpu": float(rng.choice([250.0, 500.0, 1000.0])),
                          "memory": 1 * GiB},
                annotations={GROUP_NAME_ANNOTATION: g}, phase=ppod.PodPhase.PENDING,
                creation_index=self.serial * 100 + k))
        self.gangs.append(g)

    def step(self):
        head = self.caches[0]
        r = self.rng.random()
        if r < 0.45:
            self.add_gang()
        elif r < 0.70 and self.gangs:
            g = self.gangs.pop(int(self.rng.integers(len(self.gangs))))
            job = head.jobs.get(f"tr/{g}")
            for key in sorted(job.tasks) if job is not None else []:
                for c in self.caches:
                    if key in c.pods:
                        c.delete_pod(c.pods[key])
            self.apply("delete_pod_group", f"tr/{g}")
        elif r >= 0.70:
            pods = sorted((p for p in head.pods.values() if p.node_name), key=lambda p: p.key())
            for p in pods[: int(self.rng.integers(1, 3))]:
                phase = (ppod.PodPhase.RUNNING if p.phase == ppod.PodPhase.PENDING
                         else ppod.PodPhase.SUCCEEDED if self.rng.random() < 0.5 else None)
                if phase is not None:
                    for c in self.caches:
                        c.update_pod(dataclasses.replace(c.pods[p.key()], phase=phase))


def _state(cache) -> dict:
    return {"binds": dict(cache.binder.binds),
            "pods": {k: (p.node_name, p.phase) for k, p in sorted(cache.pods.items())},
            "pg": {uid: (j.pod_group.phase, j.pod_group.running, j.pod_group.succeeded)
                   for uid, j in sorted(cache.jobs.items()) if j.pod_group is not None},
            "conditions": dict(cache.pod_conditions),
            "queue_statuses": dict(cache.status_updater.queue_statuses)}


def _port_cache():
    cache = SchedulerCache()
    for kind, obj in cluster_events():
        getattr(cache, kind)(mirror(obj))
    return cache


@pytest.mark.parametrize("seed", [3, 17])
def test_trace_on_vs_off_decisions_identical(seed, monkeypatch):
    """The same churn under KB_TRACE=0 and KB_TRACE=1: identical binds,
    statuses, conditions and queue writebacks, serial and pipelined."""
    monkeypatch.setenv("KB_TRACE", "0")
    c_off = _port_cache()
    s_off = Scheduler(c_off, conf=load_scheduler_conf(None), device="cpu")
    monkeypatch.setenv("KB_TRACE", "1")
    c_on = _port_cache()
    s_on = Scheduler(c_on, conf=load_scheduler_conf(None), device="cpu")
    assert c_on.tracer.enabled and not c_off.tracer.enabled
    churn = PortChurn([c_on, c_off], seed)
    try:
        for _ in range(3):
            churn.add_gang()
        for cycle in range(8):
            churn.step()
            for s in (s_on, s_off):
                if cycle % 2:
                    s.run_once()
                else:
                    s.run_once_pipelined()
                    s.drain_pipeline()
            assert _state(c_on) == _state(c_off), f"seed {seed} cycle {cycle}"
        assert c_on.binder.binds
        assert c_on.tracer.cycles_total == 8 and c_on.tracer.spans_total > 0
        assert c_off.flight_recorder.records() == [] and c_off.tracer.spans_total == 0
    finally:
        for s in (s_on, s_off):
            s.close()
            s.cache.stop()


def test_writeback_span_overlaps_next_cycle_compute():
    """Cycle N's writeback span (its own thread track) overlaps cycle N+1's
    session_open span: the writeback worker is held inside its bind drain
    until cycle N+1's open has started, and released from inside that open."""
    import kube_batch_tpu_torch.scheduler as sched_mod

    cache = _port_cache()
    for kind, obj in gang_events(1):
        getattr(cache, kind)(mirror(obj))
    sched = Scheduler(cache, conf=load_scheduler_conf(None), device="cpu")
    started, release = threading.Event(), threading.Event()
    orig_flush, orig_open = cache.flush_binds, sched_mod.open_session
    hold = {"on": False}

    def held_flush(*a, **kw):
        if hold["on"] and threading.current_thread().name == "kb-writeback":
            started.set()
            assert release.wait(30), "cycle N+1 never released the writeback"
        return orig_flush(*a, **kw)

    def releasing_open(*a, **kw):
        if hold["on"]:
            assert started.wait(30), "cycle N's writeback never started"
            release.set()
        return orig_open(*a, **kw)

    cache.flush_binds = held_flush
    try:
        sched.run_once_pipelined()
        sched.drain_pipeline()
        for kind, obj in gang_events(2):
            getattr(cache, kind)(mirror(obj))
        hold["on"] = True
        sched.run_once_pipelined()   # cycle N: its writeback is held
        sched_mod.open_session = releasing_open
        sched.run_once_pipelined()   # cycle N+1 opens under N's egress
        sched_mod.open_session = orig_open
        hold["on"] = False
        sched.drain_pipeline()
        records = cache.flight_recorder.records()
        (wb,) = [s for s in records[1].spans if s.name == "writeback"]
        (nxt,) = [s for s in records[2].spans if s.name == "session_open"]
        assert wb.t0 < nxt.t1 and nxt.t0 < wb.t1, "the writeback overlaps N+1's open"
        assert wb.tid != nxt.tid, "the writeback rides its own thread track"
        doc = port_trace.chrome_trace(records)
        assert port_trace.validate_chrome_trace(doc) == []
        names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
        assert names == {"cycle", "writeback"}
    finally:
        sched_mod.open_session = orig_open
        cache.flush_binds = orig_flush
        release.set()
        sched.close()
        cache.stop()


def _stamped(cache) -> list:
    out = []
    for rec in cache.flight_recorder.records():
        out.extend(rec.attrs.get("decision_lat_ms", ()))
    cur = cache.tracer.current
    if cur is not None:
        out.extend(cur.attrs.get("decision_lat_ms", ()))
    return out


@pytest.mark.parametrize("path", ["direct", "staged"])
def test_decision_latency_sink_matches_the_span_stamps(path):
    """Every histogram / sink sample has its span-stamped twin on the
    cycle's record; staged, the stage-time clock covers the stage → drain
    wait."""
    sink = []
    port_prom.set_decision_latency_sink(sink)
    cache = _port_cache()
    sched = Scheduler(cache, conf=load_scheduler_conf(None), device="cpu")
    try:
        if path == "staged":
            cache.enable_ingest_staging()
        for s in (1, 2):
            for kind, obj in gang_events(s):
                getattr(cache, kind)(mirror(obj))
        if path == "staged":
            assert "tr/g1-0" in cache._arrival_ts
            time.sleep(0.01)  # a real stage → drain wait
            sched.run_once_pipelined()
            sched.drain_pipeline()
        else:
            sched.run_once()
    finally:
        port_prom.set_decision_latency_sink(None)
        if path == "staged":
            cache.disable_ingest_staging()
        sched.close()
        cache.stop()
    assert len(sink) == 4, "both 2-gangs decided"
    if path == "staged":
        assert min(sink) >= 10.0
    assert sorted(round(v, 3) for v in sink) == sorted(_stamped(cache))
    assert cache._arrival_ts == {}


def test_jax_sink_counts_the_same_decisions(pair):
    """The same two gangs through both schedulers: the sink receives one
    sample per bind decision in each package."""
    sinks = {"jax": [], "port": []}
    pr = pair()
    for s in (1, 2):
        pr.apply(gang_events(s))
    jax_prom.set_decision_latency_sink(sinks["jax"])
    port_prom.set_decision_latency_sink(sinks["port"])
    try:
        pr.both(lambda s: s.run_once())
    finally:
        jax_prom.set_decision_latency_sink(None)
        port_prom.set_decision_latency_sink(None)
    assert len(sinks["jax"]) == len(sinks["port"]) == 4
    assert trees(pr.j.flight_recorder) == trees(pr.p.flight_recorder)
