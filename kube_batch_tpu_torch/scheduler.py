"""Scheduler — the L1 loop (pkg/scheduler/scheduler.go:38-102).

Mirrors the serial form of ``kube_batch_tpu/scheduler.py`` (its
``KB_PIPELINE=0`` oracle): each cycle opens an exclusive session, runs the
configured actions in order, and closes the session (plugin close hooks,
the job-status pass, the unwinding of session-only placements, and the
deferred ingest).  Binds are dispatched inline during the cycle, so the
state after ``run_once`` is the state the JAX package reaches after its
binder drain.

    sched = Scheduler(cache, conf=parse_scheduler_conf(text), device="cpu")
    sched.run_once()

``device=None`` means CUDA and raises without a card.  After each cycle
the guard plane's breaker clock advances (``GuardPlane.end_cycle``).  Not
ported: the pipelined event-driven loop, conf hot-reload, the cycle
budget, the resync drain and the tracing plane.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

from kube_batch_tpu_torch import actions as _actions  # noqa: F401 — registers actions
from kube_batch_tpu_torch import plugins as _plugins  # noqa: F401 — registers plugins
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.framework.conf import SchedulerConfiguration, load_scheduler_conf
from kube_batch_tpu_torch.framework.interface import Action, get_action
from kube_batch_tpu_torch.framework.session import close_session, open_session

logger = logging.getLogger("kube_batch_tpu_torch")


class Scheduler:
    def __init__(
        self,
        cache: SchedulerCache,
        conf: Optional[SchedulerConfiguration] = None,
        conf_path: Optional[str] = None,
        schedule_period: float = 1.0,
        device=None,
    ):
        self.cache = cache
        self.conf = conf if conf is not None else load_scheduler_conf(conf_path)
        # resolve actions at construction — unknown names raise (util.go:63-70)
        self.actions: List[Action] = [get_action(n) for n in self.conf.actions]
        self.device = resolve_device(device)
        self.schedule_period = schedule_period
        # wall-clock ms of the last cycle's stages: open, action:<name>, close
        self.last_cycle_ms: Dict[str, float] = {}
        self._stop = False

    def run_once(self) -> None:
        """One serial cycle (scheduler.go:88-102)."""
        cycle: Dict[str, float] = {}
        t0 = time.perf_counter()
        ssn = open_session(self.cache, self.conf.tiers, self.device)
        # the configured pipeline, for actions whose behaviour depends on
        # what runs after them (reclaim's idle-fit claimant gate)
        ssn.action_names = [a.name for a in self.actions]
        t1 = time.perf_counter()
        cycle["open"] = (t1 - t0) * 1e3
        try:
            for action in self.actions:
                ta = time.perf_counter()
                action.execute(ssn)
                cycle["action:" + action.name] = (time.perf_counter() - ta) * 1e3
        finally:
            tc = time.perf_counter()
            close_session(ssn)
            cycle["close"] = (time.perf_counter() - tc) * 1e3
            self.last_cycle_ms = cycle
        # the guard plane's breaker clock counts scheduling cycles
        guard = getattr(self.cache, "guard_plane", None)
        if guard is not None:
            guard.end_cycle()

    def run_forever(self) -> None:
        """The reference's wait.Until(runOnce, period): a cycle every
        ``schedule_period`` seconds until :meth:`stop`.  A failed cycle is
        logged and the next one runs."""
        self._stop = False
        while not self._stop:
            tick = time.monotonic()
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — the loop must keep ticking
                logger.exception("scheduling cycle failed")
            time.sleep(max(self.schedule_period - (time.monotonic() - tick), 0.0))

    def stop(self) -> None:
        """End :meth:`run_forever` after its current cycle."""
        self._stop = True

    def close(self) -> None:
        """Stop the loop.  The serial scheduler starts no worker, so there is
        nothing else to retire."""
        self.stop()
