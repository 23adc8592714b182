"""Cycle tracing plane — structured spans over the scheduling cycle (the
Dapper span model, Sigelman et al. 2010, sized for one process), mirroring
``kube_batch_tpu/obs/trace.py``.

Every stage of the cycle — ingest drain, resync, session open, each
action, status derive, the writeback barrier or bind drain, and the
overlapped writeback — runs inside a context-manager :class:`Span`; the
actions' and plugins' child spans nest under them through a per-thread
stack.  Wall time is stamped through the one seam (``utils.telemetry``),
virtual time through an injected clock, when the scheduler has one.  A
:meth:`Tracer.device_span` samples the column store's resident-cache
counters (``ColumnStore.resident_counters``) at entry and exit, so a
scatter or an unexpected full upload is annotated onto the span that paid
it (``resident``).  A span stamps host time: CUDA launches return before
the device finishes, so a dispatch span holds the launches and the device
time lands in the ``device_wait`` span, whose readback waits for it.
Nothing here synchronizes the device.

Where the port differs from the JAX package: there is no jit, so no span
carries ``compiles`` or ``retrace`` and ``retraces_attributed`` stays 0.
On the sharded path, ``KB_TRACE_COLLECTIVES=1`` has
:meth:`Tracer.annotate_collectives` put the solve's collective bytes per
round and per solve (``parallel/mesh.collective_stats``, at the JAX
package's abstract shapes) on the ``solve_dispatch`` span.

Complete per-cycle trees land in the flight recorder's ring
(``obs/recorder.py``) and export as Chrome trace-event JSON
(:func:`chrome_trace`): the writeback span rides its own thread track and
overlaps the next cycle's compute.

Tracing is inert: spans read clocks and counters, never scheduling state,
so cycles decide the same with ``KB_TRACE`` on or off.  ``KB_TRACE=0``
turns off retention (ring, attrs, device sampling, dumps); spans still
stamp their own wall time, so the latency metrics they feed (action,
plugin and stage histograms) mean the same either way.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Dict, List, Optional

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.utils import telemetry
from kube_batch_tpu_torch.utils.switches import env_flag

import time as _time  # identity sentinel only: `clock is _time` ⇒ no vt


#: root spans per implicit record before it rolls into the ring — callers
#: that drive open/close directly (drives, tests) never call begin_cycle,
#: and an unbounded current record would grow forever
IMPLICIT_ROLL = 512


class Span:
    """One traced region.  Created only via the :class:`Tracer` span
    factories; re-entrant use of a single instance is not supported —
    every ``span()`` call makes a fresh one."""

    __slots__ = ("name", "t0", "t1", "vt0", "vt1", "tid", "attrs",
                 "children", "_tracer", "_record", "_cols", "_sc0")

    def __init__(self, tracer: "Tracer", name: str,
                 record: Optional["CycleRecord"] = None,
                 cols=None, attrs: Optional[Dict] = None):
        self.name = name
        self.t0 = self.t1 = 0.0
        self.vt0 = self.vt1 = None
        self.tid = 0
        self.attrs = attrs
        self.children: List["Span"] = []
        self._tracer = tracer
        self._record = record  # explicit target (the writeback worker)
        self._cols = cols
        self._sc0 = None

    # -- timing -----------------------------------------------------------
    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    @property
    def dur_us(self) -> float:
        return (self.t1 - self.t0) * 1e6

    def set(self, **attrs) -> None:
        """Annotate the span (no-op when retention is disabled so the
        disabled tracer stays allocation-free on the attr path)."""
        if not self._tracer.enabled:
            return
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)

    # -- context manager --------------------------------------------------
    def __enter__(self) -> "Span":
        tracer = self._tracer
        self.tid = threading.get_ident()
        stack = tracer._stack()
        stack.append(self)
        # device-attribution sampling happens outside the stamped window, so
        # the counter reads never inflate the span's own duration — and
        # inside a guard: attribution must never hurt a cycle, and a probe
        # that raised after the stack push would leak the entry and corrupt
        # this thread's nesting for good
        if tracer.enabled and self._cols is not None:
            try:
                self._sc0 = _scatter_totals(self._cols)
            except Exception:  # noqa: BLE001 — attribution only
                self._sc0 = None
        clock = tracer.clock
        if clock is not None:
            self.vt0 = clock.monotonic()
        self.t0 = telemetry.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = telemetry.perf_counter()
        tracer = self._tracer
        try:
            clock = tracer.clock
            if clock is not None:
                self.vt1 = clock.monotonic()
            if tracer.enabled and self._sc0 is not None:
                sc = _scatter_totals(self._cols)
                delta = {k: sc[k] - self._sc0.get(k, 0)
                         for k in sc if sc[k] != self._sc0.get(k, 0)}
                if delta:
                    self.set(resident=delta)
            if exc_type is not None:
                self.set(error=exc_type.__name__)
        except Exception:  # noqa: BLE001 — attribution only; the stack
            pass           # unwind below must ALWAYS run
        finally:
            stack = tracer._stack()
            stack.pop()
            if stack and self._record is None:
                if tracer.enabled:
                    stack[-1].children.append(self)
                    tracer._count_span(self)
            else:
                tracer._close_root(self)
        return False

    # -- export -----------------------------------------------------------
    def to_dict(self) -> Dict:
        d: Dict = {"name": self.name, "dur_ms": round(self.dur_ms, 4)}
        if self.vt0 is not None:
            d["vt0"] = round(self.vt0, 6)
            if self.vt1 is not None:
                d["vt_dur"] = round(self.vt1 - self.vt0, 6)
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


def _scatter_totals(cols) -> Dict[str, int]:
    """Flattened per-path resident-cache counters ({path.counter: n}) —
    the delta between a device span's entry and exit attributes scatter /
    full-upload traffic to the owning dispatch."""
    out: Dict[str, int] = {}
    try:
        for path, c in cols.resident_counters().items():
            for k, v in c.items():
                out[f"{path}.{k}"] = int(v)
    except Exception:  # noqa: BLE001 — attribution must never hurt a cycle
        pass
    return out


class CycleRecord:
    """One cycle's complete trace tree.  Root spans are appended by the
    cycle thread; the overlapped writeback span arrives from its worker
    thread AFTER the record was finalized into the ring — appends are
    guarded by the tracer's lock."""

    __slots__ = ("cycle", "reason", "t0", "t1", "vt0", "vt1", "spans",
                 "attrs", "closed")

    def __init__(self, cycle: int, reason: str, t0: float,
                 vt0: Optional[float]):
        self.cycle = cycle
        self.reason = reason
        self.t0 = t0
        self.t1: Optional[float] = None
        self.vt0 = vt0
        self.vt1: Optional[float] = None
        self.spans: List[Span] = []
        self.attrs: Dict = {}
        self.closed = False

    def to_dict(self) -> Dict:
        d = {
            "cycle": self.cycle,
            "reason": self.reason,
            "dur_ms": (round((self.t1 - self.t0) * 1e3, 4)
                       if self.t1 is not None else None),
            "spans": [s.to_dict() for s in self.spans],
        }
        if self.vt0 is not None:
            d["vt0"] = round(self.vt0, 6)
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class Tracer:
    """The per-cache span recorder.  One instance per SchedulerCache
    (``tracer_of``); the Scheduler re-points ``clock`` at its injected
    clock so virtual-time stamps follow it."""

    def __init__(self, clock=None, recorder=None, enabled: Optional[bool] = None):
        self.enabled = (
            enabled if enabled is not None else env_flag("KB_TRACE", True)
        )
        # vt stamps only for a real injected clock — the wall-clock default
        # would duplicate t0/t1 into the vt fields
        self.clock = None if clock is None or clock is _time else clock
        self.recorder = recorder
        if recorder is not None:
            # a disabled tracer never feeds the ring, so the recorder must
            # not ARM captures either — an armed window that can never
            # settle (record_cycle is the settle path) would accumulate
            # forever on a long-running KB_TRACE=0 server
            recorder.enabled = self.enabled
        # arrival→decision SLO (ms) that arms a flight dump; 0 = off
        try:
            self.slo_ms = float(os.environ.get("KB_TRACE_SLO_MS", "0") or 0)
        except ValueError:
            self.slo_ms = 0.0
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._seq = itertools.count()
        self.current: Optional[CycleRecord] = None
        # seed-stable longitudinal stats (stage_attribution)
        self.cycles_total = 0
        self.spans_total = 0
        self.span_counts: Dict[str, int] = {}
        # no jit in the port: nothing is ever attributed here (kept so the
        # surfaces have the JAX package's keys)
        self.retraces_attributed = 0
        # sharded dispatch spans carry their collective bytes (opt-in)
        self.collectives = env_flag("KB_TRACE_COLLECTIVES", False)
        self._collective_cache: Dict = {}

    # -- thread-local span stack -----------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -- cycle bracket ----------------------------------------------------
    def begin_cycle(self, reason: str = "tick") -> CycleRecord:
        """Open a new cycle record (finalizing any implicit predecessor);
        returns the record so the pipelined caller can hand it to the
        writeback worker."""
        vt0 = self.clock.monotonic() if self.clock is not None else None
        rec = CycleRecord(next(self._seq), reason,
                          telemetry.perf_counter(), vt0)
        with self._mu:
            prev, self.current = self.current, rec
        if prev is not None:
            self._finalize(prev)
        return rec

    def end_cycle(self) -> None:
        with self._mu:
            rec, self.current = self.current, None
        if rec is not None:
            self._finalize(rec)

    def _finalize(self, rec: CycleRecord) -> None:
        rec.t1 = telemetry.perf_counter()
        if self.clock is not None:
            rec.vt1 = self.clock.monotonic()
        rec.closed = True
        with self._mu:
            self.cycles_total += 1
        recorder = self.recorder
        if recorder is not None and self.enabled:
            recorder.record_cycle(rec)

    def _count_span(self, span: Span) -> None:
        with self._mu:
            self.spans_total += 1
            self.span_counts[span.name] = (
                self.span_counts.get(span.name, 0) + 1
            )
            if span.attrs and span.attrs.get("retrace"):
                self.retraces_attributed += span.attrs.get("compiles", 1)

    def _close_root(self, span: Span) -> None:
        """A span finished with no parent on its thread: attach it to its
        record (explicit for writeback spans, else the current cycle) and
        feed the per-stage latency surface.  The histogram observes even
        with KB_TRACE=0 — the knob disables RETENTION (ring, dumps, device
        attribution), never the latency metrics spans feed (the same
        contract as the action/plugin histograms reading sp.dur_us)."""
        metrics.observe_stage_latency(span.name, span.dur_ms)
        if self.enabled:
            self._count_span(span)
            with self._mu:
                rec = span._record
                if rec is None:
                    rec = self.current
                    if rec is None:
                        # direct-driven flows (drives, tests) never
                        # bracket cycles — collect under an implicit record
                        rec = self.current = CycleRecord(
                            next(self._seq), "implicit", span.t0, span.vt0
                        )
                rec.spans.append(span)
                roll = (rec is self.current
                        and rec.reason == "implicit"
                        and len(rec.spans) >= IMPLICIT_ROLL)
                if roll:
                    self.current = None
            if roll:
                self._finalize(rec)

    # -- span factories (the only constructors) ---------------------------
    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs=attrs or None)

    def device_span(self, name: str, cols=None, **attrs) -> Span:
        """A span that attributes device work: the resident cache's
        scatter / upload deltas (``resident``) land on the owning span."""
        return Span(self, name, cols=cols if self.enabled else None,
                    attrs=attrs or None)

    def cycle_span(self, name: str, record: Optional[CycleRecord],
                   **attrs) -> Span:
        """A root span explicitly targeted at ``record`` — the overlapped
        writeback stage runs on its own worker thread after its cycle's
        record was already finalized into the ring."""
        return Span(self, name, record=record, attrs=attrs or None)

    # -- cycle annotations -------------------------------------------------
    def note_cycle_attr(self, key: str, value) -> None:
        if not self.enabled:
            return
        with self._mu:
            rec = self.current
            if rec is not None:
                rec.attrs[key] = value

    def note_decision_latencies(self, ms_values) -> None:
        """Stamp this cycle's arrival→decision samples onto the trace tree
        (the exact values the histogram/sink observe — test_trace pins the
        equality) and arm a flight dump on an SLO breach."""
        if not ms_values or not self.enabled:
            return
        with self._mu:
            rec = self.current
            if rec is not None:
                rec.attrs.setdefault("decision_lat_ms", []).extend(
                    round(v, 3) for v in ms_values
                )
        if self.slo_ms > 0 and self.recorder is not None:
            worst = max(ms_values)
            if worst > self.slo_ms:
                self.recorder.trigger(
                    "slo_breach",
                    detail=f"arrival→decision {worst:.1f}ms > "
                           f"KB_TRACE_SLO_MS={self.slo_ms:g}",
                )

    def anomaly(self, reason: str, detail: str = "") -> None:
        """Route a non-guard anomaly (a budget shed) to the flight
        recorder."""
        if self.recorder is not None and self.enabled:
            self.recorder.trigger(reason, detail=detail)

    # -- surfaces ---------------------------------------------------------
    def last_cycle(self) -> Optional[Dict]:
        recorder = self.recorder
        if recorder is None:
            return None
        with self._mu:
            rec = recorder.last_record()
        return rec.to_dict() if rec is not None else None

    def state(self) -> Dict:
        with self._mu:
            out = {
                "enabled": self.enabled,
                "cycles_traced": self.cycles_total,
                "spans_total": self.spans_total,
                "span_counts": dict(self.span_counts),
                "retraces_attributed": self.retraces_attributed,
            }
        if self.recorder is not None:
            out["ring"] = self.recorder.stats()
        out["last_cycle"] = self.last_cycle()
        return out

    def annotate_collectives(self, span: Span, config, snap, mesh,
                             pend_rows=None) -> None:
        """Put the sharded solve's collective result bytes per round and
        per solve on ``span`` (``KB_TRACE_COLLECTIVES=1``; memoized per
        mesh, config and shapes).  The shapes are the JAX package's:
        ``snap``'s task and node buckets, its audit's abstract R, W and K,
        so the attribute equals the JAX package's."""
        if not (self.enabled and self.collectives) or mesh is None:
            return
        try:
            from kube_batch_tpu_torch.parallel.mesh import (
                collective_stats,
                shard_map_enabled,
            )

            if not shard_map_enabled():
                return
            T = int(snap.task_req.shape[0])
            N = int(snap.node_idle.shape[0])
            pend = int(pend_rows.shape[0]) if pend_rows is not None else None
            key = (mesh, config, T, N, pend)
            if key not in self._collective_cache:
                stats = collective_stats(mesh, config=config, shape=dict(T=T, N=N),
                                         pend_bucket=pend)
                self._collective_cache[key] = {
                    "per_round_bytes": stats["per_round_bytes"],
                    "per_solve_bytes": stats["per_solve_bytes"],
                }
            out = self._collective_cache[key]
        except Exception:  # noqa: BLE001 — attribution only
            return
        if out:
            span.set(collective_bytes=out)

    def stage_attribution(self) -> Dict:
        """The seed-stable longitudinal summary: span counts per stage plus
        the attributed retrace total (0 in the port) — everything here is a
        function of the event stream, not the host's wall clock."""
        with self._mu:
            return {
                "cycles_traced": self.cycles_total,
                "spans_total": self.spans_total,
                "stages": dict(sorted(self.span_counts.items())),
                "retraces_attributed": self.retraces_attributed,
            }


# --------------------------------------------------------------------------
# per-cache attach (the guard_of idiom)
# --------------------------------------------------------------------------

_ATTACH_LOCK = threading.Lock()


def tracer_of(cache, clock=None) -> Tracer:
    """The per-cache tracer accessor: the scheduler, the actions and the
    framework all reach tracing through here, so one cache has exactly one
    span plane and one flight-recorder ring.  ``clock`` (the Scheduler's
    injected clock) re-points virtual-time stamping on first attach."""
    tr = getattr(cache, "tracer", None)
    if tr is None:
        with _ATTACH_LOCK:
            tr = getattr(cache, "tracer", None)
            if tr is None:
                from kube_batch_tpu_torch.obs.recorder import FlightRecorder

                rec = FlightRecorder.from_env()
                tr = Tracer(clock=clock, recorder=rec)
                cache.flight_recorder = rec
                cache.tracer = tr
    if clock is not None and clock is not _time and tr.clock is None:
        tr.clock = clock
    return tr


# --------------------------------------------------------------------------
# Chrome trace-event export + structural validation
# --------------------------------------------------------------------------


def chrome_trace(records) -> Dict:
    """Render cycle records as a Chrome trace-event document (`ph: "X"`
    complete events, µs timestamps) — load in ``chrome://tracing`` or
    Perfetto.  Thread ids are preserved, so the writeback stage rides its
    own track and the pipelined overlap is visible as spans of cycle N's
    writeback under cycle N+1's compute."""
    events: List[Dict] = []
    tid_names: Dict[int, str] = {}

    def emit(span: Span, cycle: int, depth: int) -> None:
        events.append({
            "name": span.name,
            "ph": "X",
            "ts": span.t0 * 1e6,
            "dur": max(span.t1 - span.t0, 0.0) * 1e6,
            "pid": 1,
            "tid": span.tid,
            "args": dict(span.attrs or {}, cycle=cycle, depth=depth),
        })
        if "writeback" in span.name:
            tid_names.setdefault(span.tid, "writeback")
        else:
            tid_names.setdefault(span.tid, "cycle")
        for child in span.children:
            emit(child, cycle, depth + 1)

    for rec in records:
        for span in rec.spans:
            emit(span, rec.cycle, 0)
    meta = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
         "args": {"name": name}}
        for tid, name in sorted(tid_names.items())
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc: Dict) -> List[str]:
    """Structural validation of an exported trace: every complete event
    carries a non-negative duration, per-thread events are properly nested
    (a deeper span lies inside its ancestor's bounds — balanced brackets),
    and timestamps are finite/monotonic per (thread, depth) stream.
    Returns the violations (empty = valid); the chip smoke and the tests
    gate on it."""
    errs: List[str] = []
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    if not events:
        return ["no complete (ph=X) events"]
    by_tid: Dict[int, List[Dict]] = {}
    for e in events:
        if not isinstance(e.get("ts"), (int, float)) or e["ts"] != e["ts"]:
            errs.append(f"non-numeric ts on {e.get('name')}")
            continue
        if e.get("dur", -1) < 0:
            errs.append(f"negative dur on {e.get('name')}")
        by_tid.setdefault(e["tid"], []).append(e)
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict] = []  # enclosing spans
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - 1e-3:
                stack.pop()
            if stack:
                outer = stack[-1]
                if e["ts"] + e["dur"] > outer["ts"] + outer["dur"] + 1e-3:
                    errs.append(
                        f"unbalanced nesting on tid {tid}: "
                        f"{e['name']} ends after its enclosing "
                        f"{outer['name']}"
                    )
            stack.append(e)
    return errs
