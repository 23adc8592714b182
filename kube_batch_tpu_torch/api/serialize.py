"""JSON (de)serialization for the ingest object model, mirroring
``kube_batch_tpu/api/serialize.py`` over the port's ``api/pod.py`` types:
a dict made by either package's ``*_to_dict`` loads into the other's
objects and serializes back to the same dict.

The reference's ingest protocol is the Kubernetes API server's watch/write
JSON (cache.go:256-336). The standalone analog is this module: every object
the cache consumes (Pod, PodGroup, Queue, Node, PriorityClass) round-trips
through plain JSON dicts, used by the HTTP ingest API (cmd/server.py) and the
queue CLI (cli/queue.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from kube_batch_tpu_torch.api.pod import (
    Affinity,
    Node,
    Pod,
    PodAffinityTerm,
    PodGroup,
    PodGroupCondition,
    PriorityClass,
    Queue,
    Taint,
    Toleration,
)
from kube_batch_tpu_torch.api.types import PodGroupPhase, PodPhase


def _clean(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in d.items() if v not in (None, {}, [], (), "")}


def pod_to_dict(pod: Pod) -> Dict[str, Any]:
    d = dataclasses.asdict(pod)
    d["phase"] = pod.phase.value if pod.phase else None
    if pod.affinity is not None:
        d["affinity"] = {
            "node_terms": [
                [[k, op, list(vals)] for (k, op, vals) in term]
                for term in pod.affinity.node_terms
            ],
            "pod_affinity": [dataclasses.asdict(t) for t in pod.affinity.pod_affinity],
            "pod_anti_affinity": [
                dataclasses.asdict(t) for t in pod.affinity.pod_anti_affinity
            ],
            "preferred_node_terms": [
                [w, [[k, op, list(vals)] for (k, op, vals) in term]]
                for (w, term) in pod.affinity.preferred_node_terms
            ],
            "preferred_pod_affinity": [
                [w, dataclasses.asdict(t)]
                for (w, t) in pod.affinity.preferred_pod_affinity
            ],
            "preferred_pod_anti_affinity": [
                [w, dataclasses.asdict(t)]
                for (w, t) in pod.affinity.preferred_pod_anti_affinity
            ],
        }
    d["host_ports"] = list(pod.host_ports)
    return _clean(d)


def pod_from_dict(d: Dict[str, Any]) -> Pod:
    d = dict(d)
    if "phase" in d:
        d["phase"] = PodPhase(d["phase"])
    if "tolerations" in d:
        d["tolerations"] = [Toleration(**t) for t in d["tolerations"]]
    if "affinity" in d and d["affinity"] is not None:
        d["affinity"] = Affinity(
            node_terms=[
                [(k, op, tuple(vals)) for (k, op, vals) in term]
                for term in d["affinity"].get("node_terms", [])
            ],
            pod_affinity=[
                PodAffinityTerm(**t) for t in d["affinity"].get("pod_affinity", [])
            ],
            pod_anti_affinity=[
                PodAffinityTerm(**t)
                for t in d["affinity"].get("pod_anti_affinity", [])
            ],
            preferred_node_terms=[
                (w, [(k, op, tuple(vals)) for (k, op, vals) in term])
                for (w, term) in d["affinity"].get("preferred_node_terms", [])
            ],
            preferred_pod_affinity=[
                (w, PodAffinityTerm(**t))
                for (w, t) in d["affinity"].get("preferred_pod_affinity", [])
            ],
            preferred_pod_anti_affinity=[
                (w, PodAffinityTerm(**t))
                for (w, t) in d["affinity"].get("preferred_pod_anti_affinity", [])
            ],
        )
    if "host_ports" in d:
        d["host_ports"] = tuple(d["host_ports"])
    if "volume_claims" in d:
        d["volume_claims"] = tuple(d["volume_claims"])
    return Pod(**d)


def node_to_dict(node: Node) -> Dict[str, Any]:
    return _clean(dataclasses.asdict(node))  # _clean keeps booleans


def node_from_dict(d: Dict[str, Any]) -> Node:
    d = dict(d)
    if "taints" in d:
        d["taints"] = [Taint(**t) for t in d["taints"]]
    return Node(**d)


def pod_group_to_dict(pg: PodGroup) -> Dict[str, Any]:
    d = dataclasses.asdict(pg)
    d["phase"] = pg.phase.value if pg.phase is not None else None
    return _clean(d)


def pod_group_from_dict(d: Dict[str, Any]) -> PodGroup:
    d = dict(d)
    if d.get("phase") is not None:
        d["phase"] = PodGroupPhase(d["phase"])
    if "conditions" in d:
        d["conditions"] = [PodGroupCondition(**c) for c in d["conditions"]]
    return PodGroup(**d)


def queue_to_dict(q: Queue) -> Dict[str, Any]:
    return _clean(dataclasses.asdict(q))


def queue_from_dict(d: Dict[str, Any]) -> Queue:
    return Queue(**d)


def priority_class_from_dict(d: Dict[str, Any]) -> PriorityClass:
    return PriorityClass(**d)
