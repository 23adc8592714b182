"""The Kubernetes front end (``kube_batch_tpu/k8s/``): JSON translation,
the list+watch adapter, the apiserver binder (``bind.py``) and the
retrying transport (``transport.py``)."""

from kube_batch_tpu_torch.k8s.translate import (
    apply_event,
    node_from_k8s,
    parse_quantity,
    pdb_from_k8s,
    pod_from_k8s,
    pod_group_from_k8s,
    priority_class_from_k8s,
    queue_from_k8s,
)
from kube_batch_tpu_torch.k8s.watch import RESOURCES, WatchAdapter

__all__ = [
    "apply_event",
    "node_from_k8s",
    "parse_quantity",
    "pdb_from_k8s",
    "pod_from_k8s",
    "pod_group_from_k8s",
    "priority_class_from_k8s",
    "queue_from_k8s",
    "RESOURCES",
    "WatchAdapter",
]
