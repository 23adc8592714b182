"""Guard trip-rate SLO alerting, mirroring ``kube_batch_tpu/obs/alerts.py``.

The guard plane (``guard/``) counts integrity trips per fast
path and per action; this evaluator turns those series into ALERTS: a
path (or the aggregate) whose trip count within the last
``KB_ALERT_WINDOW`` cycles reaches ``KB_ALERT_GUARD_TRIPS`` is FIRING.
One trip is an incident the breaker already handled; a trip RATE is a
systemic signal (flapping hardware, a persistently divergent fast path)
that demands an operator — exactly the distinction a gauge on raw
``volcano_guard_trips_total`` cannot make without server-side rate rules.

Evaluation runs on the guard plane's own cycle clock (the Scheduler calls
it right after ``GuardPlane.end_cycle``), so firing decisions are
deterministic under any injected clock.  Surfaces: :meth:`AlertEvaluator.state`
(the JAX package serves it at ``GET /v1/alerts``; the port's server is not
written yet) and the ``volcano_alerts_firing`` gauge.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.utils.switches import env_int

logger = logging.getLogger("kube_batch_tpu_torch")


#: the aggregate series (any action, any path)
AGGREGATE = "guard_trips"


class AlertEvaluator:
    """Sliding-window trip-rate thresholds over the guard plane's trip
    log.  Alert names: ``guard_trips`` (aggregate) and
    ``guard_trips:<path>`` per demoted fast path."""

    def __init__(self, threshold: Optional[int] = None,
                 window: Optional[int] = None):
        self.threshold = (
            threshold if threshold is not None
            else max(1, env_int("KB_ALERT_GUARD_TRIPS", 1))
        )
        self.window = (
            window if window is not None
            else max(1, env_int("KB_ALERT_WINDOW", 64))
        )
        self._mu = threading.Lock()
        self._seen_trips = 0  # trip_log prefix already ingested
        # alert name → trip cycle numbers still inside the window
        self._recent: Dict[str, List[int]] = {}
        self.firing: Dict[str, bool] = {}
        self.fired_total: Dict[str, int] = {}
        self.last_cycle = -1

    def evaluate(self, guard) -> Dict[str, bool]:
        """Ingest new trips from ``guard.trip_log`` and re-derive every
        alert's firing state at the guard's current cycle clock."""
        with self._mu:
            cycle, new, self._seen_trips = guard.trip_series(self._seen_trips)
            self.last_cycle = cycle
            for trip in new:
                t_cycle = int(trip.get("cycle", cycle))
                names = [AGGREGATE] + [
                    f"{AGGREGATE}:{p}" for p in trip.get("demoted", ())
                ]
                for name in names:
                    self._recent.setdefault(name, []).append(t_cycle)
            lo = cycle - self.window
            out: Dict[str, bool] = {}
            for name, cycles in list(self._recent.items()):
                cycles[:] = [c for c in cycles if c >= lo]
                firing = len(cycles) >= self.threshold
                was = self.firing.get(name, False)
                if firing and not was:
                    self.fired_total[name] = self.fired_total.get(name, 0) + 1
                    logger.error(
                        "ALERT firing: %s — %d guard trips within %d cycles "
                        "(threshold %d)", name, len(cycles), self.window,
                        self.threshold,
                    )
                elif was and not firing:
                    logger.info("ALERT resolved: %s", name)
                self.firing[name] = firing
                out[name] = firing
                metrics.set_alert_firing(name, int(firing))
        return out

    def state(self) -> Dict:
        with self._mu:
            return {
                "threshold_trips": self.threshold,
                "window_cycles": self.window,
                "evaluated_at_cycle": self.last_cycle,
                "alerts": {
                    name: {
                        "firing": self.firing.get(name, False),
                        "trips_in_window": len(self._recent.get(name, ())),
                        "fired_total": self.fired_total.get(name, 0),
                    }
                    for name in sorted(
                        set(self.firing) | set(self._recent)
                    )
                },
            }


_ATTACH_LOCK = threading.Lock()


def alerts_of(cache) -> AlertEvaluator:
    """The per-cache alert evaluator (the guard_of idiom)."""
    ev = getattr(cache, "alert_evaluator", None)
    if ev is None:
        with _ATTACH_LOCK:
            ev = getattr(cache, "alert_evaluator", None)
            if ev is None:
                ev = AlertEvaluator()
                cache.alert_evaluator = ev
    return ev
