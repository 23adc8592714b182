"""MicroBatcher — the what-if front end's amortization engine.

Mirrors ``kube_batch_tpu/serve/batcher.py``.  Concurrent callers
:meth:`MicroBatcher.submit` and block on a future; one worker thread
collects requests into a batch and hands it to the flush callback (the
query plane's probe dispatch).  A flush fires when the batch bucket fills
or when the oldest queued request's window has elapsed, so a lone request
pays at most ``window`` of extra latency while a burst rides one dispatch.

Knobs (each overridable per instance; the environment gives defaults):

- ``KB_WHATIF_BATCH``     — requests per dispatch, default 16
- ``KB_WHATIF_WINDOW_MS`` — flush deadline from the first enqueue, default 5 ms
- ``KB_WHATIF_QUEUE``     — bounded queue depth; an overflow rejects the
  request at once instead of building a backlog

The clock is injected: a stubbed clock and :meth:`tick` drive the flush
logic deterministically without the thread.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

from kube_batch_tpu_torch.utils.switches import env_int


def env_float(name: str, default: float) -> float:
    """A float knob; unset or unparsable keeps ``default``."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class QueueFull(Exception):
    """The bounded request queue is at capacity: shed, don't buffer."""


class MicroBatcher:
    def __init__(
        self,
        flush: Callable[[List[Tuple[object, Future]]], None],
        max_batch: Optional[int] = None,
        window_s: Optional[float] = None,
        max_queue: Optional[int] = None,
        clock=time,
        start_thread: bool = True,
    ):
        self._flush = flush
        self.max_batch = max_batch if max_batch is not None else env_int(
            "KB_WHATIF_BATCH", 16)
        self.window_s = window_s if window_s is not None else env_float(
            "KB_WHATIF_WINDOW_MS", 5.0) / 1e3
        self.max_queue = max_queue if max_queue is not None else env_int(
            "KB_WHATIF_QUEUE", 1024)
        self.clock = clock
        self._cond = threading.Condition()
        self._pending: deque = deque()  # (request, future, enqueue time)
        self._stopped = False
        self.rejected = 0
        self._thread: Optional[threading.Thread] = None
        if start_thread:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="whatif-batcher")
            self._thread.start()

    # ---- producer side ---------------------------------------------------
    def submit(self, request) -> Future:
        """Enqueue one request; the future resolves with the flush
        callback's answer for it, or at once with QueueFull when the queue
        is at capacity or the batcher has stopped."""
        fut: Future = Future()
        with self._cond:
            if self._stopped:
                fut.set_exception(QueueFull("batcher stopped"))
                return fut
            if len(self._pending) >= self.max_queue:
                self.rejected += 1
                fut.set_exception(QueueFull(
                    f"whatif queue at capacity ({self.max_queue})"))
                return fut
            self._pending.append((request, fut, self.clock.monotonic()))
            self._cond.notify_all()
        return fut

    def depth(self) -> int:
        with self._cond:
            return len(self._pending)

    # ---- flush logic (the thread in production, tick() in tests) --------
    def _due(self, now: float) -> bool:
        """Flush condition, under the lock: bucket full or window elapsed."""
        if not self._pending:
            return False
        if len(self._pending) >= self.max_batch:
            return True
        return now - self._pending[0][2] >= self.window_s

    def _take(self) -> List[Tuple[object, Future]]:
        n = min(self.max_batch, len(self._pending))
        out = []
        for _ in range(n):
            req, fut, _t = self._pending.popleft()
            out.append((req, fut))
        return out

    def tick(self, now: Optional[float] = None) -> int:
        """Flush if due; returns the number of requests flushed."""
        now = self.clock.monotonic() if now is None else now
        with self._cond:
            if not self._due(now):
                return 0
            batch = self._take()
        self._run_flush(batch)
        return len(batch)

    def _run_flush(self, batch: List[Tuple[object, Future]]) -> None:
        try:
            self._flush(batch)
        except Exception as e:  # noqa: BLE001 — a failed dispatch fails its batch only
            for _req, fut in batch:
                if not fut.done():
                    fut.set_exception(e)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stopped:
                    self._cond.wait()
                if self._stopped:
                    break
                # wait until _due (the one flush policy) holds: submit
                # notifies on fill, the timed wait tracks the deadline
                while not self._due(self.clock.monotonic()) and not self._stopped:
                    remaining = (self._pending[0][2] + self.window_s
                                 - self.clock.monotonic())
                    self._cond.wait(max(remaining, 0.0))
                if self._stopped:
                    break
                batch = self._take()
            self._run_flush(batch)
        # stopped: fail whatever is still queued
        with self._cond:
            leftovers = list(self._pending)
            self._pending.clear()
        for _req, fut, _t in leftovers:
            if not fut.done():
                fut.set_exception(QueueFull("batcher stopped"))

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
