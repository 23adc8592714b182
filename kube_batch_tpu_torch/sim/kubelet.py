"""Simulated kubelet: the Binder/Evictor seam plus the pod lifecycle
state machine, mirroring the stub apiserver's semantics
(``testing/e2e.py`` ``StubApiServer``): a Binding ack eventually
transitions the pod to Running on its node; an eviction terminates it after a grace delay.

Threading contract: the cache dispatches binder calls on its async
kb-dispatch worker (cache.go:478's goroutines), so `bind`/`bind_many`
only RECORD acks under a lock. The runner — single-threaded over the
virtual clock — drains the acks after each cycle's `flush_binds` and
schedules the lifecycle follow-ups on the event heap. Every cache
mutation therefore happens on the runner thread, in deterministic order.

The lifecycle transitions themselves are module functions over the
cache's own pod store: each builds a fresh `Pod` (informer-event style)
and feeds it through `cache.update_pod`, exactly the ingest path a live
watch stream uses.

Mirrors ``kube_batch_tpu/sim/kubelet.py``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

from kube_batch_tpu_torch.api.pod import Pod
from kube_batch_tpu_torch.api.types import PodPhase


class SimBindFailure(Exception):
    """Injected binder failure (the BIND_FAIL fault): exercises the
    cache's resync repair path (cache.go:559-581)."""


class SimKubelet:
    """Binder + Evictor backend recording acks for the runner to drain."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bind_acks: List[Tuple[str, str]] = []   # (pod key, node)
        self._evict_acks: List[str] = []              # pod key
        self._fail_binds = 0  # pending injected per-pod bind failures
        self._brownout = False  # apiserver brownout: every call fails
        self.binds_total = 0
        self.bind_failures = 0

    # ---- fault injection -------------------------------------------------
    def fail_next_binds(self, n: int) -> None:
        with self._lock:
            self._fail_binds += int(n)

    def set_brownout(self, active: bool) -> None:
        """The APISERVER_BROWNOUT window: while active, EVERY egress call
        fails (the apiserver unreachable/overloaded) — upstream, the
        circuit breaker opens and the degraded cycle parks decisions."""
        with self._lock:
            self._brownout = active

    def _maybe_fail(self, what: str) -> None:
        # lock held by caller
        if self._brownout:
            self.bind_failures += 1
            raise SimBindFailure(f"apiserver brownout: {what}")

    # ---- Binder seam -----------------------------------------------------
    def bind(self, pod: Pod, hostname: str) -> None:
        with self._lock:
            self._maybe_fail(f"bind {pod.key()}")
            if self._fail_binds > 0:
                self._fail_binds -= 1
                self.bind_failures += 1
                raise SimBindFailure(f"injected bind failure for {pod.key()}")
            self._bind_acks.append((pod.key(), hostname))
            self.binds_total += 1

    def bind_many(self, pairs) -> None:
        """All-or-nothing batch (cache._dispatch_async retries per-task
        through bind() on failure). A failed batch consumes ONE unit of the
        injected budget — one failed API call — so the budget drains even
        when the circuit breaker blocks the per-task fallback and the next
        attempts are half-open bind_many probes."""
        with self._lock:
            self._maybe_fail("bind_many")
            if self._fail_binds > 0:
                self._fail_binds -= 1
                self.bind_failures += 1
                raise SimBindFailure("injected bind_many failure")
            for pod, hostname in pairs:
                self._bind_acks.append((pod.key(), hostname))
                self.binds_total += 1

    # ---- Evictor seam ----------------------------------------------------
    def evict(self, pod: Pod) -> None:
        with self._lock:
            self._maybe_fail(f"evict {pod.key()}")
            self._evict_acks.append(pod.key())

    # ---- runner drain ----------------------------------------------------
    def drain(self) -> Tuple[List[Tuple[str, str]], List[str]]:
        with self._lock:
            binds, self._bind_acks = self._bind_acks, []
            evicts, self._evict_acks = self._evict_acks, []
        return binds, evicts


# ---- lifecycle transitions over the cache's pod store ---------------------


def _stored(cache, key: str) -> Optional[Pod]:
    return cache.pods.get(key)


def set_running(cache, key: str, node: str) -> bool:
    """Binding ack matured: the kubelet runs the pod (StubApiServer.bind_pod
    sets spec.nodeName + status.phase=Running in one MODIFIED event)."""
    pod = _stored(cache, key)
    if pod is None or pod.phase != PodPhase.PENDING:
        return False  # deleted or superseded while the start latency elapsed
    cache.update_pod(dataclasses.replace(pod, phase=PodPhase.RUNNING,
                                         node_name=node))
    return True


def set_succeeded(cache, key: str) -> bool:
    pod = _stored(cache, key)
    if pod is None or pod.phase != PodPhase.RUNNING:
        return False
    cache.update_pod(dataclasses.replace(pod, phase=PodPhase.SUCCEEDED))
    return True


def delete_pod(cache, key: str) -> bool:
    pod = _stored(cache, key)
    if pod is None:
        return False
    cache.delete_pod(pod)
    return True


def replace_pending(cache, key: str, uid: str, creation_index: int) -> bool:
    """The job controller's part: a terminated (evicted / crash-lost)
    replica is deleted and recreated as a fresh Pending pod of the same
    name — what a Job/ReplicaSet controller does for kube-batch's gangs.
    `uid` must be deterministic (the runner derives it from a reincarnation
    counter), never the process-global auto-uid."""
    pod = _stored(cache, key)
    if pod is None:
        return False
    cache.delete_pod(pod)
    fresh = dataclasses.replace(
        pod, uid=uid, phase=PodPhase.PENDING, node_name=None,
        creation_index=creation_index,
    )
    cache.add_pod(fresh)
    return True
