"""Invariant assertions with an opt-out env switch.

Mirrors ``kube_batch_tpu/utils/assertions.py`` (the reference's
pkg/scheduler/util/assert/assert.go:11-36): a broken invariant raises by
default; ``PANIC_ON_ERROR=false`` downgrades it to a logged error so a
loop can carry on and self-correct next cycle.
"""

from __future__ import annotations

import logging
import os
import traceback

logger = logging.getLogger("kube_batch_tpu_torch")


class InvariantError(AssertionError):
    """Raised when a scheduler invariant (e.g. resource underflow) breaks."""


def graft_assert(condition: bool, message: str = "invariant violated") -> None:
    """Assert a scheduler invariant (assert.go:25-36)."""
    if condition:
        return
    if os.environ.get("PANIC_ON_ERROR", "true").lower() != "false":
        raise InvariantError(message)
    logger.error("invariant violated: %s\n%s", message,
                 "".join(traceback.format_stack()))
