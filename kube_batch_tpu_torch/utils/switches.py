"""On-by-default switches read from the environment (the JAX package's
kill switches: ``KB_SNAPSHOT_DELTA``, ``KB_DEVICE_CACHE``,
``KB_DELTA_CLOSE``)."""

from __future__ import annotations

import os

OFF = ("0", "false", "off", "no")


def switch_on(name: str) -> bool:
    """False when the variable ``name`` reads 0, false, off or no."""
    return os.environ.get(name, "").strip().lower() not in OFF
