"""Flight recorder — the black box for the scheduling cycle, mirroring
``kube_batch_tpu/obs/recorder.py``.

A bounded ring (``KB_TRACE_RING``, default 256 cycles) of complete
per-cycle trace trees from the span recorder (obs/trace.py).  On an
anomaly — a guard-plane trip, a cycle-budget shed, an arrival→decision
SLO breach — the recorder snapshots the N cycles BEFORE
the trigger, arms a capture of the N cycles AFTER it, and publishes the
whole window as a self-contained dump directory:

    <dir>/flight-<reason>-<serial>/
        trace.json   — Chrome trace-event JSON (chrome://tracing/Perfetto
                       render the pipelined overlap directly)
        meta.json    — trigger reason/detail, window bounds, knobs

The write uses the guard-bundle idiom (build in a temp sibling,
``os.replace`` into place) so a crash mid-dump never leaves a half
capture.  Dump directory resolution: ``KB_TRACE_DIR``, else
``<KB_GUARD_DIR>/flight`` when the guard bundle dir is configured (trip
dumps land NEXT to the guard bundle for the same incident), else
``flight-recorder``.  ``KB_TRACE_POST`` (default 8) sets N — how many
post-trigger cycles each dump waits for before publishing.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
from collections import deque
from typing import Dict, List, Optional

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.utils.switches import env_int

logger = logging.getLogger("kube_batch_tpu_torch")

_KNOBS = (
    "KB_TRACE", "KB_TRACE_RING", "KB_TRACE_POST", "KB_TRACE_SLO_MS",
    "KB_PIPELINE", "KB_TOPK", "KB_SHARD_MAP", "KB_GUARD", "JAX_PLATFORMS",
)

#: in-memory bound on the trigger log (dumps on disk are the durable record)
MAX_TRIGGER_LOG = 64


def flight_dir() -> str:
    explicit = os.environ.get("KB_TRACE_DIR", "").strip()
    if explicit:
        return explicit
    guard = os.environ.get("KB_GUARD_DIR", "").strip()
    if guard:
        return os.path.join(guard, "flight")
    return "flight-recorder"


class FlightRecorder:
    def __init__(self, ring: Optional[int] = None,
                 directory: Optional[str] = None,
                 post_cycles: Optional[int] = None):
        self.ring_cap = ring if ring is not None else max(
            2, env_int("KB_TRACE_RING", 256)
        )
        self.directory = directory  # None → flight_dir() at dump time
        self.post_cycles = (
            post_cycles if post_cycles is not None
            else max(0, env_int("KB_TRACE_POST", 8))
        )
        # set False by a disabled Tracer: with no record_cycle feed, an
        # armed capture could never settle — trigger() then no-ops
        self.enabled = True
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=self.ring_cap)
        # armed captures: trigger fired, waiting out their post window
        self._armed: List[Dict] = []
        self.cycles_recorded = 0
        self.triggers: deque = deque(maxlen=MAX_TRIGGER_LOG)
        self.dumps: List[str] = []
        self._serial = 0

    @classmethod
    def from_env(cls) -> "FlightRecorder":
        return cls()

    # ------------------------------------------------------------------
    def record_cycle(self, record) -> None:
        """Ring-append one finalized cycle record; settle armed captures
        whose post-trigger window completed (file I/O OUTSIDE the lock)."""
        due: List[Dict] = []
        with self._mu:
            self._ring.append(record)
            self.cycles_recorded += 1
            for armed in self._armed:
                armed["post"].append(record)
                if len(armed["post"]) >= self.post_cycles:
                    due.append(armed)
            if due:
                self._armed = [a for a in self._armed if a not in due]
        for armed in due:
            self._publish(armed)

    def trigger(self, reason: str, detail: str = "") -> None:
        """One anomaly: snapshot the pre-trigger ring, arm the
        post-trigger capture.  With ``post_cycles == 0`` (or an idle
        process that never cycles again) the dump publishes immediately.

        No-ops when tracing is disabled (nothing feeds the ring, so a
        capture could never settle), and COALESCES repeat triggers: while
        a capture for ``reason`` is still armed, a new trigger of the same
        reason only logs — a sustained SLO breach or a trip storm must not
        arm one capture (each holding a full ring snapshot) per event."""
        if not self.enabled:
            return
        with self._mu:
            self.triggers.append({
                "reason": reason, "detail": detail,
                "cycle": self.cycles_recorded,
            })
            if any(a["reason"] == reason for a in self._armed):
                return  # coalesced into the already-armed capture
            armed = {
                "reason": reason,
                "detail": detail,
                "pre": list(self._ring),
                "post": [],
                "trigger_cycle": self.cycles_recorded,
            }
            if self.post_cycles > 0:
                self._armed.append(armed)
                armed = None
        if armed is not None:
            self._publish(armed)

    def flush(self) -> List[str]:
        """Publish every still-armed capture with whatever post-trigger
        cycles arrived (shutdown / end-of-run path: the drives call this
        so a trigger near the end of a run still dumps)."""
        with self._mu:
            armed, self._armed = self._armed, []
        out = []
        for a in armed:
            path = self._publish(a)
            if path:
                out.append(path)
        return out

    # ------------------------------------------------------------------
    def _publish(self, armed: Dict) -> Optional[str]:
        from kube_batch_tpu_torch.obs.trace import chrome_trace

        records = armed["pre"] + armed["post"]
        if not records:
            logger.warning("flight dump for %s skipped: empty ring",
                           armed["reason"])
            return None
        root = self.directory or flight_dir()
        try:
            os.makedirs(root, exist_ok=True)
            doc = chrome_trace(records)
            meta = {
                "schema": 1,
                "reason": armed["reason"],
                "detail": armed["detail"],
                "trigger_cycle": armed["trigger_cycle"],
                "cycles_before": len(armed["pre"]),
                "cycles_after": len(armed["post"]),
                "cycle_ids": [r.cycle for r in records],
                "knobs": {k: os.environ.get(k, "") for k in _KNOBS},
                "tree": [r.to_dict() for r in records],
            }
            # atomic publish: whole dump in a temp sibling, one rename —
            # the guard-bundle idiom, so a crash never leaves a half dump
            tmp = tempfile.mkdtemp(dir=root, prefix=".tmp-flight-")
            try:
                with open(os.path.join(tmp, "trace.json"), "w") as f:
                    json.dump(doc, f)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f, indent=2, sort_keys=True)
                while True:
                    final = os.path.join(
                        root, f"flight-{armed['reason']}-{self._serial:04d}"
                    )
                    if not os.path.exists(final):
                        try:
                            os.replace(tmp, final)
                            break
                        except OSError:
                            pass  # lost a concurrent-dump race — next serial
                    self._serial += 1
                    if self._serial > 9999:
                        raise OSError("flight recorder directory full")
            except BaseException:
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
                raise
        except Exception:  # noqa: BLE001 — diagnostics only, never the cycle
            logger.exception("flight recorder dump failed")
            return None
        with self._mu:
            self.dumps.append(final)
        metrics.register_flight_dump(armed["reason"])
        logger.warning("flight recorder dump written: %s", final)
        return final

    # ------------------------------------------------------------------
    def last_record(self):
        with self._mu:
            return self._ring[-1] if self._ring else None

    def records(self) -> list:
        with self._mu:
            return list(self._ring)

    def stats(self) -> Dict:
        with self._mu:
            return {
                "capacity": self.ring_cap,
                "cycles_recorded": self.cycles_recorded,
                "cycles_resident": len(self._ring),
                "post_cycles": self.post_cycles,
                "armed": len(self._armed),
                "triggers": list(self.triggers),
                "dumps": list(self.dumps),
            }
