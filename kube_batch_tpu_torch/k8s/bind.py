"""Binding/eviction writeback to a Kubernetes API server, mirroring
``kube_batch_tpu/k8s/bind.py``.

The egress half of the front end (the reference's default binder/evictor,
cache.go:110-150): placements POST the pods/binding subresource, evictions
DELETE the pod.  Errors raise, which routes the task into the cache's resync
repair queue exactly like a failed client-go call (cache.go:478-484)."""

from __future__ import annotations

import logging
import urllib.error
from typing import Optional

from kube_batch_tpu_torch.k8s.transport import ApiTransport

logger = logging.getLogger("kube_batch_tpu_torch")


class K8sBackend:
    """Binder + Evictor against an apiserver (duck-typed for both cache
    seams; per-pod calls are idempotent, so no bind_many is exposed — see
    the Binder contract in cache/interface.py)."""

    def __init__(
        self,
        api_server: str,
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure: bool = False,
    ):
        self.transport = ApiTransport(
            api_server, token=token, token_file=token_file,
            ca_file=ca_file, insecure=insecure, role="writeback",
        )

    # ---- Binder seam ---------------------------------------------------
    def bind(self, pod, hostname: str) -> None:
        """POST the Binding subresource (the defaultBinder, cache.go:115-126).

        A 409 Conflict is idempotent success: the pod is already bound —
        almost always by our OWN earlier request that timed out client-side
        but landed server-side (the retrying transport makes this window
        routine). Raising would loop the task through resync for a bind
        that already happened; mirrors the evict 404 handling below."""
        try:
            self.transport.request(
                "POST",
                f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}/binding",
                {
                    "apiVersion": "v1",
                    "kind": "Binding",
                    "metadata": {"name": pod.name, "namespace": pod.namespace,
                                 "uid": pod.uid},
                    "target": {"apiVersion": "v1", "kind": "Node",
                               "name": hostname},
                },
            )
        except urllib.error.HTTPError as e:
            if e.code == 409:
                logger.info("bind of %s/%s: already bound (409) — treating "
                            "as success", pod.namespace, pod.name)
                return
            raise

    def degraded(self) -> bool:
        """True while the transport's writeback breaker is failing fast —
        the cache's degraded-cycle checks (status shedding) read this."""
        return self.transport.degraded()

    # ---- Evictor seam --------------------------------------------------
    def evict(self, pod) -> None:
        """DELETE the pod (the defaultEvictor, cache.go:128-140)."""
        try:
            self.transport.request(
                "DELETE",
                f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}",
            )
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return  # already gone — eviction's goal is met
            raise

    # ---- StatusUpdater seam --------------------------------------------
    # Status writes are independent per object, so the cache's close-time
    # jobUpdater pool (job_updater.go:18,51-53) may fan them out over
    # threads; the transport opens a connection per request.
    parallel_safe = True

    def update_pod_group(self, pg) -> None:
        """PATCH the PodGroup status subresource (the defaultStatusUpdater's
        UpdatePodGroup, cache.go:176-187; CRD group per config/crds)."""
        if getattr(pg, "shadow", False):
            return  # synthesized for a plain pod — no CRD object exists
        self.transport.request(
            "PATCH",
            "/apis/scheduling.incubator.k8s.io/v1alpha1/namespaces/"
            f"{pg.namespace}/podgroups/{pg.name}/status",
            {
                "status": {
                    "phase": pg.phase.value if pg.phase is not None else None,
                    "running": pg.running,
                    "succeeded": pg.succeeded,
                    "failed": pg.failed,
                    "conditions": [
                        {
                            "type": c.type,
                            "status": c.status,
                            "transitionID": c.transition_id,
                            "reason": c.reason,
                            "message": c.message,
                        }
                        for c in pg.conditions
                    ],
                }
            },
            content_type="application/merge-patch+json",
        )

    def update_pod_condition(self, pod, cond: dict) -> None:
        """PATCH the pod's PodScheduled condition (taskUnschedulable,
        cache.go:500-525)."""
        self.transport.request(
            "PATCH",
            f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}/status",
            {"status": {"conditions": [cond]}},
            content_type="application/strategic-merge-patch+json",
        )

    def update_queue_status(self, name: str, counts: dict) -> None:
        """PATCH the Queue CRD's podgroup-phase counts (QueueStatus,
        types.go:195-204). BEYOND the reference: kube-batch declares the
        status fields but nothing populates them (the filler controller
        arrived later, in Volcano) — writing them here makes
        `kb-ctl queue --master ... list` show live counts."""
        self.transport.request(
            "PATCH",
            "/apis/scheduling.incubator.k8s.io/v1alpha1/queues/"
            f"{name}/status",
            {"status": counts},
            content_type="application/merge-patch+json",
        )
