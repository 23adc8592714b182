"""The egress breaker's error, mirroring
``kube_batch_tpu/k8s/transport.py``.

Only :class:`CircuitOpenError` is here for now: the cache's async binder,
its evict path and the resync queue tell a breaker refusal from a real
failure by it.  The rest of ``k8s/`` (the classified retry transport, the
circuit breaker itself, bind, translate and watch) comes with ROADMAP
item 8."""

from __future__ import annotations


class CircuitOpenError(OSError):
    """Raised instead of dialing when the breaker is open.  An OSError, so
    handlers that classify "unreachable" (the resync repair path) treat it
    as the transient outage it represents; the resync queue parks such a
    decision without charging its poison budget."""
