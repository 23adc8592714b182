"""Switches and knobs read from the environment: the JAX package's
on-by-default kill switches (``KB_SNAPSHOT_DELTA``, ``KB_DEVICE_CACHE``,
``KB_DELTA_CLOSE``, ``KB_GUARD``) and its integer knobs
(``KB_AUDIT_EVERY``, ``KB_GUARD_COOLDOWN``)."""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("kube_batch_tpu_torch")

OFF = ("0", "false", "off", "no")


def switch_on(name: str) -> bool:
    """False when the variable ``name`` reads 0, false, off or no."""
    return os.environ.get(name, "").strip().lower() not in OFF


def env_int(name: str, default: int) -> int:
    """An integer knob; unset or unparsable (logged) keeps ``default``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("unparsable %s=%r; using %d", name, raw, default)
        return default
