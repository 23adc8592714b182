"""GuardPlane — the per-fast-path health breaker (the guard's third tier).

Mirrors ``kube_batch_tpu/guard/plane.py``.  Each demotable fast path
carries a health state:

    healthy ──trip──▶ demoted ──KB_GUARD_COOLDOWN clean cycles──▶ probing
       ▲                 ▲                                           │
       └── clean probe ──┘◀──────────── trip during probe ───────────┘

A demoted path's dispatches run its oracle (``topk``: the full program;
``warm``: the cold per-solve table build; ``shard_map``: the ``"pjit"``
oracle, the single-device program over the gathered snapshot);
``probing`` is half-open: the
next dispatch runs the fast path again under the sentinel, and one clean
engaged cycle re-promotes.  Time counts in scheduling cycles
(``Scheduler.run_once`` calls :meth:`GuardPlane.end_cycle`).

Every trip also runs the heal hook (``ColumnStore.drop_resident``: the
next dispatch uploads every column in full, and the carried warm tables
go; the query plane's lease is retired) and, when the caller supplies
one, a lazy bundle dump.  A trip is also the flight recorder's primary
trigger (``obs/recorder.py``): the trace trees of the cycles around the
condemned solve dump beside the guard bundle.  Every state transition
happens under one leaf lock; heals and dumps run outside it.

Trips, audits and demotions feed ``volcano_guard_trips_total``,
``volcano_guard_audits_total`` and ``volcano_guard_path_demoted``
(``metrics/``); the trip log feeds the alert evaluator
(:meth:`GuardPlane.trip_series`, ``obs/alerts.py``).  The plane keeps its
own counters too (``verdicts_consumed``, ``trips_total``,
``failed_closed``, ``audits_run``, ``audits_mismatched``, ``trip_log``,
``bundles``).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.utils.switches import env_int

logger = logging.getLogger("kube_batch_tpu_torch")

#: the JAX package's demotable fast paths.  The port engages "topk" (the
#: compacted solve), "warm" (the carried table) and "shard_map" (the
#: sharded solves' shard bodies; demoted, they run the "pjit" oracle);
#: "pallas" keeps its slot so the state has the same keys, but nothing in
#: the port engages it (a CUDA tensor always runs the kernels)
FAST_PATHS = ("topk", "shard_map", "pallas", "warm")

HEALTHY, DEMOTED, PROBING = "healthy", "demoted", "probing"


class PathHealth:
    """One fast path's breaker state (mutated under the plane's lock)."""

    def __init__(self, name: str):
        self.name = name
        self.state = HEALTHY
        self.clean_cycles = 0   # clean cycles since demotion
        self.trips = 0
        self.promotions = 0

    def snapshot(self) -> Dict:
        return {"state": self.state, "clean_cycles": self.clean_cycles,
                "trips": self.trips, "promotions": self.promotions}


class GuardPlane:
    def __init__(self, enabled: Optional[bool] = None,
                 audit_every: Optional[int] = None,
                 cooldown: Optional[int] = None,
                 bundle_dir: Optional[str] = None):
        if enabled is None:
            enabled = os.environ.get("KB_GUARD", "").strip().lower() not in (
                "0", "false", "off", "no")
        self.enabled = enabled
        self.audit_every = (audit_every if audit_every is not None
                            else env_int("KB_AUDIT_EVERY", 64))
        self.cooldown = (cooldown if cooldown is not None
                         else max(1, env_int("KB_GUARD_COOLDOWN", 8)))
        self.bundle_dir = bundle_dir  # None → guard/bundle.py's default
        self._lock = threading.Lock()
        self.paths: Dict[str, PathHealth] = {n: PathHealth(n) for n in FAST_PATHS}
        # per-action dispatch counters (the audit cadence)
        self._dispatches: Dict[str, int] = {}
        self._cycle_engaged: set = set()
        self._cycle_tripped: set = set()
        self._ever_engaged: set = set()
        self.cycle = 0
        # lifetime diagnostics
        self.verdicts_consumed = 0  # sentinel verdicts read (any value)
        self.trips_total = 0
        self.failed_closed = 0      # condemned solves discarded
        self.audits_run = 0
        self.audits_mismatched = 0
        self.bundles: List[str] = []
        self.trip_log: List[Dict] = []

    # ------------------------------------------------------------------
    # dispatch-side queries
    # ------------------------------------------------------------------
    def allow(self, path: str) -> bool:
        """May this fast path run?  Demoted paths answer False (the
        dispatch selects the oracle); probing paths answer True."""
        if not self.enabled:
            return True
        with self._lock:
            ph = self.paths.get(path)
            return ph is None or ph.state != DEMOTED

    def audit_due(self, action: str) -> bool:
        """True on every KB_AUDIT_EVERY-th dispatch of ``action``."""
        if not self.enabled or self.audit_every <= 0:
            return False
        with self._lock:
            k = self._dispatches.get(action, 0) + 1
            self._dispatches[action] = k
            return k % self.audit_every == 0

    # ------------------------------------------------------------------
    # verdict / audit consumption
    # ------------------------------------------------------------------
    def consume_verdict(self, action: str, engaged: Sequence[str],
                        verdict: int, hist=None, detail: str = "",
                        dump: Optional[Callable[[], str]] = None,
                        heal: Optional[Callable[[], None]] = None) -> bool:
        """Record one sentinel verdict.  True: the action may apply the
        result; False: the solve is condemned and the action fails
        closed."""
        if not self.enabled:
            return True
        with self._lock:
            self.verdicts_consumed += 1
            self._ever_engaged.update(engaged)
        if int(verdict) == 0:
            with self._lock:
                self._cycle_engaged.update(engaged)
            return True
        with self._lock:
            self.failed_closed += 1
        self.trip(action, engaged, reason="invariant",
                  detail=detail or f"verdict={int(verdict)}", hist=hist,
                  dump=dump, heal=heal)
        return False

    def note_audit(self, action: str, engaged: Sequence[str], matched: bool,
                   detail: str = "",
                   dump: Optional[Callable[[], str]] = None,
                   heal: Optional[Callable[[], None]] = None) -> None:
        """Record one shadow-oracle comparison."""
        if not self.enabled:
            return
        with self._lock:
            self.audits_run += 1
        metrics.register_guard_audit("match" if matched else "mismatch")
        if matched:
            with self._lock:
                self._cycle_engaged.update(engaged)
            return
        with self._lock:
            self.audits_mismatched += 1
        self.trip(action, engaged, reason="audit", detail=detail, dump=dump,
                  heal=heal)

    def trip(self, action: str, engaged: Sequence[str], reason: str,
             detail: str = "", hist=None,
             dump: Optional[Callable[[], str]] = None,
             heal: Optional[Callable[[], None]] = None) -> None:
        """One integrity trip: demote the engaged fast paths, heal the
        resident data, dump the bundle.  A second trip in the same cycle
        re-confirms the demotion."""
        with self._lock:
            self.trips_total += 1
            targets = [n for n in engaged if n in self.paths]
            if not targets:
                # unattributable (e.g. a corrupted resident column caught
                # by a full-matrix solve's sentinel): demote every fast
                # path that engaged in this process and is not demoted
                targets = sorted(p for p in self._ever_engaged
                                 if self.paths[p].state != DEMOTED)
            record = {
                "cycle": self.cycle, "action": action, "reason": reason,
                "engaged": list(engaged), "demoted": list(targets),
                "detail": detail,
                "hist": list(map(int, hist)) if hist is not None else None,
            }
            self.trip_log.append(record)
            for name in targets:
                ph = self.paths[name]
                ph.trips += 1
                ph.state = DEMOTED
                ph.clean_cycles = 0
                self._cycle_tripped.add(name)
                metrics.set_guard_path_demoted(name, 1)
        metrics.register_guard_trip(action, reason)
        logger.error("guard plane trip (%s/%s): %s — failing closed; demoted %s",
                     action, reason, detail, targets or "no fast path")
        # outside the lock: the heal touches the column store, the dump
        # reads the snapshot back and writes files.  The flight recorder's
        # capture of the cycles around this trip is armed first
        flight = getattr(getattr(self, "host_cache", None), "flight_recorder", None)
        if flight is not None:
            try:
                flight.trigger("guard_trip", detail=f"{action}/{reason}: {detail}")
            except Exception:  # noqa: BLE001 — diagnostics only
                logger.exception("flight-recorder trigger failed")
        if heal is not None:
            try:
                heal()
            except Exception:  # noqa: BLE001 — healing must not kill the cycle
                logger.exception("guard resident heal failed")
        if dump is not None:
            try:
                path = dump()
                if path:
                    with self._lock:
                        record["bundle"] = path
                        self.bundles.append(path)
            except Exception:  # noqa: BLE001 — diagnostics only
                logger.exception("guard bundle dump failed")

    # ------------------------------------------------------------------
    # cycle clock
    # ------------------------------------------------------------------
    def end_cycle(self) -> None:
        """Advance the breaker clock: demoted paths accrue clean cycles
        toward their half-open probe; a probing path that ran engaged and
        clean this cycle re-promotes."""
        if not self.enabled:
            return
        with self._lock:
            self.cycle += 1
            for name, ph in self.paths.items():
                if name in self._cycle_tripped:
                    continue  # trip() already reset this path
                if ph.state == DEMOTED:
                    ph.clean_cycles += 1
                    if ph.clean_cycles >= self.cooldown:
                        ph.state = PROBING
                        logger.info("guard path %s half-open after %d clean cycles",
                                    name, ph.clean_cycles)
                elif ph.state == PROBING and name in self._cycle_engaged:
                    ph.state = HEALTHY
                    ph.promotions += 1
                    metrics.set_guard_path_demoted(name, 0)
                    logger.info("guard path %s re-promoted (clean probe)", name)
            self._cycle_engaged.clear()
            self._cycle_tripped.clear()

    def trip_series(self, since: int):
        """(cycle, trip_log[since:], new length) under the plane's lock:
        the alert evaluator's incremental read (``obs/alerts.py``)."""
        with self._lock:
            return self.cycle, list(self.trip_log[since:]), len(self.trip_log)

    # ------------------------------------------------------------------
    def state(self) -> Dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "cycle": self.cycle,
                "cooldown": self.cooldown,
                "audit_every": self.audit_every,
                "verdicts_consumed": self.verdicts_consumed,
                "trips_total": self.trips_total,
                "failed_closed": self.failed_closed,
                "audits_run": self.audits_run,
                "audits_mismatched": self.audits_mismatched,
                "bundles": list(self.bundles),
                "paths": {n: p.snapshot() for n, p in self.paths.items()},
            }


#: serializes the lazy attach below
_ATTACH_LOCK = threading.Lock()


def guard_of(cache) -> GuardPlane:
    """The cache's guard plane, attached on first use: every dispatch site
    goes through here, so all five actions share one breaker state."""
    gp = getattr(cache, "guard_plane", None)
    if gp is None:
        with _ATTACH_LOCK:
            gp = getattr(cache, "guard_plane", None)
            if gp is None:
                gp = GuardPlane()
                # the back-pointer for the flight-recorder trigger in
                # trip(); the state machine never reads through it
                gp.host_cache = cache
                cache.guard_plane = gp
    return gp


# --------------------------------------------------------------------------
# the shared sentinel consumer: one copy of the readback-side plumbing
# (checksum cross-check, histogram folding, detail, bundle thunk, heal)
# --------------------------------------------------------------------------


def make_heal(ssn):
    """The trip heal: drop the resident device state (a corrupted column
    is cured by the next dispatch's full upload; the warm tables go too)
    and retire the published what-if lease: a condemned solve's snapshot
    must not keep serving probes, which wait for the next clean publish."""
    cols = ssn.columns
    qp = getattr(ssn.cache, "query_plane", None)

    def heal():
        if cols is not None:
            cols.drop_resident()
        if qp is not None:
            qp.broker.retire()

    return heal


def sentinel_bundle_thunk(gp: GuardPlane, action: str, dev_snap, config,
                          report, pend_rows=None):
    """Lazy bundle dump for a trip: captures the exact device snapshot the
    condemned solve consumed."""
    def dump():
        from kube_batch_tpu_torch.guard.bundle import dump_bundle

        return dump_bundle(action, dev_snap, config, report,
                           pend_rows=pend_rows, directory=gp.bundle_dir)

    return dump


def consume_sentinel(gp: GuardPlane, action: str, ssn, snap, dev_snap,
                     config, verdict: int, vhist, echeck: int, engaged,
                     host_bad: int = 0, pend_rows=None,
                     extra_report=None) -> bool:
    """Consume one solve's sentinel outputs plus the host cross-checks:
    ``host_bad`` counts the action's own host violations; the
    device-against-host eligibility checksum is compared here.  Host
    violations fold into histogram slot 0.  True: lawful; False: fail
    closed."""
    from kube_batch_tpu_torch.ops.invariants import (
        INVARIANT_NAMES,
        host_eligibility_checksum,
    )

    host_ck = host_eligibility_checksum(snap)
    if (int(echeck) & 0xFFFFFFFF) != host_ck:
        host_bad += 1
    total = int(verdict) + host_bad
    vhist = (np.zeros(len(INVARIANT_NAMES), np.int64) if vhist is None
             else np.asarray(vhist).astype(np.int64).copy())
    vhist[0] += host_bad
    detail = ", ".join(f"{name}={int(c)}"
                       for name, c in zip(INVARIANT_NAMES, vhist) if c)
    if host_bad:
        detail += f" (host eligibility cross-check: {host_bad})"
    report = {"verdict": int(total), "detail": detail, "engaged": list(engaged),
              "host_cross_check": host_bad, "host_checksum": host_ck}
    if extra_report:
        report.update(extra_report)
    return gp.consume_verdict(
        action, engaged, total, hist=vhist, detail=detail,
        dump=sentinel_bundle_thunk(gp, action, dev_snap, config, report,
                                   pend_rows=pend_rows),
        heal=make_heal(ssn))


def consume_assignment_sentinel(gp: GuardPlane, action: str, ssn, snap, meta,
                                ginfo, verdict: int, vhist, echeck: int,
                                assigned, extra_report=None) -> bool:
    """The assignment-shaped consumer shared by allocate and backfill's
    stranded-capacity pass: a placement must target a row the host also
    believes pending (the device's pending column could be the corrupted
    thing), then :func:`consume_sentinel`."""
    host_bad = int(np.sum((np.asarray(assigned) >= 0)
                          & ~np.asarray(snap.task_pending)[: meta.n_tasks]))
    return consume_sentinel(
        gp, action, ssn, snap, ginfo["dev"], ginfo["config"], int(verdict),
        vhist, int(echeck), ginfo["engaged"], host_bad=host_bad,
        pend_rows=ginfo.get("pend_rows"), extra_report=extra_report)
