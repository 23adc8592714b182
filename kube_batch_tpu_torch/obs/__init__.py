"""Observability plane — structured cycle tracing, the anomaly-triggered
flight recorder and guard-trip SLO alerting, mirroring
``kube_batch_tpu/obs``.

- :mod:`kube_batch_tpu_torch.obs.trace` — the span recorder: context-manager
  spans with nesting over every stage of the (pipelined) scheduling cycle,
  wall time through the ``telemetry`` seam, virtual time through an
  injected clock, resident-cache attribution on device spans.
- :mod:`kube_batch_tpu_torch.obs.recorder` — the flight recorder: a bounded
  ring of complete per-cycle trace trees that dumps the cycles around an
  anomaly (guard trip, budget shed, arrival→decision SLO breach) as Chrome
  trace-event JSON.
- :mod:`kube_batch_tpu_torch.obs.alerts` — the guard trip-rate SLO
  evaluator feeding the ``volcano_alerts_firing`` gauge.

Everything attaches lazily per cache (the ``guard_of`` idiom), so several
schedulers in one process never cross wires.
"""

from kube_batch_tpu_torch.obs.alerts import AlertEvaluator, alerts_of  # noqa: F401
from kube_batch_tpu_torch.obs.recorder import FlightRecorder  # noqa: F401
from kube_batch_tpu_torch.obs.trace import Tracer, tracer_of  # noqa: F401
