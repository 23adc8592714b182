"""Switches and knobs read from the environment: the JAX package's
on-by-default kill switches (``KB_SNAPSHOT_DELTA``, ``KB_DEVICE_CACHE``,
``KB_DELTA_CLOSE``, ``KB_GUARD``), its flags with a default either way
(``KB_TRACE`` on, ``KB_TRACE_COLLECTIVES`` off) and its integer knobs
(``KB_AUDIT_EVERY``, ``KB_GUARD_COOLDOWN``, ``KB_TRACE_RING``)."""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("kube_batch_tpu_torch")

OFF = ("0", "false", "off", "no")


def switch_on(name: str) -> bool:
    """False when the variable ``name`` reads 0, false, off or no."""
    return os.environ.get(name, "").strip().lower() not in OFF


def env_flag(name: str, default: bool) -> bool:
    """A boolean knob (``kube_batch_tpu/envutil.py:38``): unset or empty
    keeps ``default``; anything but 0, false, off or no is True."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw not in OFF


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
