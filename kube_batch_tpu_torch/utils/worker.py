"""A one-thread ordered executor for the cache's bind dispatcher and the
scheduler's writeback stage.

The JAX package runs both on ``ThreadPoolExecutor(max_workers=1)``.  Here
the worker is a daemon thread, so a process whose owner never called
``stop()`` / ``close()`` can still exit; the owners join it with a bound
on their shutdown paths all the same.  Submitted callables run in order;
``submit`` returns a ``concurrent.futures.Future``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Optional

_STOP = object()


class SerialWorker:
    def __init__(self, name: str):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            self._run(*item)
            # an idle worker must not hold its last job: the callable's
            # closure keeps its owner (a cache, a scheduler) alive, and with
            # it every host and device buffer the owner holds
            del item

    @staticmethod
    def _run(fut: Future, fn, args) -> None:
        if not fut.set_running_or_notify_cancel():
            return
        try:
            result = fn(*args)
        except BaseException as e:  # noqa: BLE001 — handed to the future
            fut.set_exception(e)
        else:
            fut.set_result(result)

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn, args))
        return fut

    def shutdown(self, timeout: Optional[float] = None) -> bool:
        """Run what was submitted, then stop; True when the thread ended
        within ``timeout`` seconds."""
        self._q.put(_STOP)
        self._thread.join(timeout)
        return not self._thread.is_alive()
