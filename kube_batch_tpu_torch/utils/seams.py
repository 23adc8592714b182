"""The seams through which the device-program audit
(``analysis/recorder.py``) watches a program run.  Both are no-ops while
no recorder is installed on the calling thread:

- :func:`round_end` is the once-per-round readback of a bidding loop ("did
  anything land?"), so that a recorder can read its counts per round;
- :func:`opaque` marks a kernel wrapper (K1, K2, the enqueue gate), which a
  recorder sees as one call whose outputs it charges, as the JAX audit sees
  a ``pallas_call`` as one equation: the plain version that runs on a CPU
  tensor is not the program the card runs.
"""

from __future__ import annotations

import functools
import threading

#: the installed recorder and the thread it records, or None
_installed = None


def install(recorder) -> None:
    """Route the seams of the calling thread to ``recorder`` (None: off)."""
    global _installed
    _installed = None if recorder is None else (threading.get_ident(), recorder)


def _current():
    inst = _installed
    if inst is not None and inst[0] == threading.get_ident():
        return inst[1]
    return None


def round_end(flag) -> bool:
    """``bool(flag)``: the round's readback; tells a recorder the round
    ended."""
    out = bool(flag)
    rec = _current()
    if rec is not None:
        rec.round_end()
    return out


def opaque(fn):
    """Decorate a kernel wrapper so that a recorder sees it as one call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        rec = _current()
        if rec is None:
            return fn(*args, **kwargs)
        return rec.opaque_call(fn.__name__, fn, args, kwargs)

    return wrapper
