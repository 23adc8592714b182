"""Kubernetes API JSON → framework objects, mirroring
``kube_batch_tpu/k8s/translate.py`` function for function.

The reference is wired to a live cluster through 10 informers
(cache.go:256-339) consuming v1.Pod / v1.Node / the scheduling.incubator.k8s.io
PodGroup and Queue CRDs / policy PDBs / scheduling.k8s.io PriorityClasses.
This module is the standalone rebuild's equivalent seam: it translates the
raw JSON those watch streams carry into the framework's ingest dataclasses
(api/pod.py), unit-for-unit compatible with the reference's readings —
cpu in millicores (resource_info.go:99-111 value.MilliValue), memory in
bytes, scalar resources in milli units, quantities parsed with Kubernetes
suffix semantics.

`apply_event` dispatches a (kind, watch-event-type, object) triple into the
SchedulerCache's handlers — the informer AddFunc/UpdateFunc/DeleteFunc
analog (event_handlers.go).  ``k8s/watch.py`` drives it from live
list+watch streams.
"""

from __future__ import annotations

import datetime
import logging
from typing import Dict, List, Optional, Tuple

from kube_batch_tpu_torch.api.pod import (
    Affinity,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodAffinityTerm,
    PodDisruptionBudget,
    PodGroup,
    PriorityClass,
    Queue,
    Taint,
    Toleration,
)
from kube_batch_tpu_torch.api.types import PodGroupPhase, PodPhase

logger = logging.getLogger("kube_batch_tpu_torch")

_SUFFIX = {
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}


def parse_quantity(q) -> float:
    """A Kubernetes resource.Quantity string → float (base units).
    Handles sub-unit ('100m', '500u', '50n' — the apiserver canonicalizes
    sub-milli values to u/n), binary ('1Gi') and decimal ('2G') suffixes,
    plain and exponent forms ('0.5', '1e3')."""
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    if not s:
        return 0.0
    if s.endswith("n"):
        return float(s[:-1]) / 1e9
    if s.endswith("u"):
        return float(s[:-1]) / 1e6
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    for suf in ("Ki", "Mi", "Gi", "Ti", "Pi", "Ei"):
        if s.endswith(suf):
            return float(s[: -len(suf)]) * _SUFFIX[suf]
    if s[-1] in _SUFFIX:
        return float(s[:-1]) * _SUFFIX[s[-1]]
    return float(s)


def _requests_to_framework(requests: Dict[str, str]) -> Dict[str, float]:
    """k8s requests map → framework units: cpu→millicores, memory→bytes,
    every other (scalar) resource→milli units (resource_info.go:99-127)."""
    out: Dict[str, float] = {}
    for name, q in (requests or {}).items():
        v = parse_quantity(q)
        if name == "cpu":
            out["cpu"] = out.get("cpu", 0.0) + v * 1000.0
        elif name == "memory":
            out["memory"] = out.get("memory", 0.0) + v
        elif name == "pods":
            out["pods"] = out.get("pods", 0.0) + v
        else:
            out[name] = out.get(name, 0.0) + v * 1000.0
    return out


def _sum_requests(containers: List[dict]) -> Dict[str, float]:
    total: Dict[str, float] = {}
    for c in containers or []:
        for name, v in _requests_to_framework(
            (c.get("resources") or {}).get("requests") or {}
        ).items():
            total[name] = total.get(name, 0.0) + v
    return total


def _max_requests(containers: List[dict]) -> Dict[str, float]:
    """Per-dimension max over init containers (pod_info.go:53-73)."""
    out: Dict[str, float] = {}
    for c in containers or []:
        for name, v in _requests_to_framework(
            (c.get("resources") or {}).get("requests") or {}
        ).items():
            out[name] = max(out.get(name, 0.0), v)
    return out


def creation_index_of(meta: dict) -> int:
    """creationTimestamp → monotone int (epoch seconds)."""
    ts = (meta or {}).get("creationTimestamp")
    if not ts:
        return 0
    try:
        return int(
            datetime.datetime.fromisoformat(ts.replace("Z", "+00:00")).timestamp()
        )
    except ValueError:
        return 0


def _controller_uid(meta: dict) -> Optional[str]:
    for ref in (meta or {}).get("ownerReferences") or []:
        if ref.get("controller"):
            return ref.get("uid") or ref.get("name")
    # ownerless pods are a valid spec state (bare pods), not unrecognized
    # input; None means "no controller", never a guess
    # kbt: allow[KBT004] ownerless pods are a valid spec state (bare pods),
    # not unrecognized input; None means "no controller", never a guess
    return None


def _match_expressions(term: dict) -> List[Tuple[str, str, Tuple[str, ...]]]:
    out = []
    for e in term.get("matchExpressions") or []:
        out.append((e.get("key", ""), e.get("operator", "In"),
                    tuple(e.get("values") or ())))
    # matchFields (metadata.name) are encoded as In terms on the hostname
    # label, which every kubelet sets — a sound approximation the host
    # predicate re-validates
    for e in term.get("matchFields") or []:
        if e.get("key") == "metadata.name":
            out.append(("kubernetes.io/hostname", e.get("operator", "In"),
                        tuple(e.get("values") or ())))
    return out


def _pod_terms(spec: dict, key: str) -> List[PodAffinityTerm]:
    out = []
    for t in (spec or {}).get(key) or []:
        sel = (t.get("labelSelector") or {}).get("matchLabels") or {}
        out.append(PodAffinityTerm(
            match_labels=dict(sel),
            topology_key=t.get("topologyKey", "kubernetes.io/hostname"),
        ))
    return out


def _weighted_pod_terms(spec: dict, key: str):
    out = []
    for t in (spec or {}).get(key) or []:
        term = t.get("podAffinityTerm") or {}
        sel = (term.get("labelSelector") or {}).get("matchLabels") or {}
        out.append((float(t.get("weight", 1)), PodAffinityTerm(
            match_labels=dict(sel),
            topology_key=term.get("topologyKey", "kubernetes.io/hostname"),
        )))
    return out


def _affinity_from_k8s(aff: Optional[dict]) -> Optional[Affinity]:
    if not aff:
        # an absent affinity stanza is an unconstrained pod by the k8s
        # spec; None is the documented "no affinity" value, not a default
        # kbt: allow[KBT004] absent affinity stanza = unconstrained pod by
        # k8s spec; None is the documented "no affinity" value, not a default
        return None
    out = Affinity()
    node_aff = aff.get("nodeAffinity") or {}
    required = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    for term in required.get("nodeSelectorTerms") or []:
        reqs = _match_expressions(term)
        if reqs:
            out.node_terms.append(reqs)
    for pref in node_aff.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
        reqs = _match_expressions(pref.get("preference") or {})
        if reqs:
            out.preferred_node_terms.append((float(pref.get("weight", 1)), reqs))
    pod_aff = aff.get("podAffinity") or {}
    out.pod_affinity = _pod_terms(
        pod_aff, "requiredDuringSchedulingIgnoredDuringExecution"
    )
    out.preferred_pod_affinity = _weighted_pod_terms(
        pod_aff, "preferredDuringSchedulingIgnoredDuringExecution"
    )
    anti = aff.get("podAntiAffinity") or {}
    out.pod_anti_affinity = _pod_terms(
        anti, "requiredDuringSchedulingIgnoredDuringExecution"
    )
    out.preferred_pod_anti_affinity = _weighted_pod_terms(
        anti, "preferredDuringSchedulingIgnoredDuringExecution"
    )
    if (
        not out.node_terms and not out.pod_affinity and not out.pod_anti_affinity
        and not out.has_preferences()
    ):
        # an affinity stanza that parses to zero terms is an empty
        # selector (matches everything) per MatchNodeSelector semantics,
        # predicates.go:194-205 — open IS the reference behavior
        # kbt: allow[KBT004] an affinity stanza that parses to zero terms is
        # an empty selector (matches everything) per MatchNodeSelector
        # semantics, predicates.go:194-205 — open IS the reference behavior
        return None
    return out


def pod_from_k8s(obj: dict) -> Pod:
    """v1.Pod JSON → framework Pod."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    containers = spec.get("containers") or []
    host_ports = tuple(
        int(p["hostPort"])
        for c in containers
        for p in c.get("ports") or []
        if p.get("hostPort")
    )
    tolerations = [
        Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Equal"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
        )
        for t in spec.get("tolerations") or []
    ]
    volume_claims = tuple(
        v["persistentVolumeClaim"]["claimName"]
        for v in spec.get("volumes") or []
        if v.get("persistentVolumeClaim", {}).get("claimName")
    )
    try:
        phase = PodPhase(status.get("phase", "Pending"))
    except ValueError:
        phase = PodPhase.UNKNOWN
    return Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", ""),
        requests=_sum_requests(containers),
        init_requests=_max_requests(spec.get("initContainers")),
        node_name=spec.get("nodeName") or None,
        phase=phase,
        deleting=bool(meta.get("deletionTimestamp")),
        priority=int(spec.get("priority") or 0),
        priority_class=spec.get("priorityClassName", ""),
        labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}),
        node_selector=dict(spec.get("nodeSelector") or {}),
        tolerations=tolerations,
        affinity=_affinity_from_k8s(spec.get("affinity")),
        host_ports=host_ports,
        scheduler_name=spec.get("schedulerName", "default-scheduler"),
        creation_index=creation_index_of(meta),
        volume_claims=volume_claims,
        owner=_controller_uid(meta),
    )


def node_from_k8s(obj: dict) -> Node:
    """v1.Node JSON → framework Node."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    taints = [
        Taint(key=t.get("key", ""), value=t.get("value", ""),
              effect=t.get("effect", "NoSchedule"))
        for t in spec.get("taints") or []
    ]
    ready = True
    conditions: Dict[str, bool] = {}
    for c in status.get("conditions") or []:
        truthy = c.get("status") == "True"
        if c.get("type") == "Ready":
            ready = truthy
        else:
            conditions[c.get("type", "")] = truthy
    return Node(
        name=meta.get("name", ""),
        allocatable=_requests_to_framework(status.get("allocatable") or {}),
        capacity=_requests_to_framework(status.get("capacity") or {}),
        labels=dict(meta.get("labels") or {}),
        taints=taints,
        ready=ready,
        unschedulable=bool(spec.get("unschedulable")),
        conditions=conditions,
    )


def pod_group_from_k8s(obj: dict) -> PodGroup:
    """PodGroup CRD JSON (scheduling.incubator.k8s.io/v1alpha1,
    types.go:93-171) → framework PodGroup."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    min_resources = spec.get("minResources")
    phase = None
    if status.get("phase"):
        try:
            phase = PodGroupPhase(status["phase"])
        except ValueError:
            phase = None
    return PodGroup(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", ""),
        min_member=int(spec.get("minMember") or 1),
        queue=spec.get("queue", ""),
        priority_class=spec.get("priorityClassName", ""),
        min_resources=(
            _requests_to_framework(min_resources) if min_resources else None
        ),
        phase=phase,
        running=int(status.get("running") or 0),
        succeeded=int(status.get("succeeded") or 0),
        failed=int(status.get("failed") or 0),
        creation_index=creation_index_of(meta),
    )


def queue_from_k8s(obj: dict) -> Queue:
    """Queue CRD JSON (types.go:178-223) → framework Queue."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    capability = spec.get("capability")
    return Queue(
        name=meta.get("name", ""),
        uid=meta.get("uid", ""),
        weight=int(spec.get("weight") or 1),
        capability=(
            _requests_to_framework(capability) if capability else None
        ),
    )


def pdb_from_k8s(obj: dict) -> Optional[PodDisruptionBudget]:
    """policy PodDisruptionBudget JSON → framework PDB (the legacy gang
    source, event_handlers.go:484-594). Only integer minAvailable is a gang
    signal; percentage PDBs are skipped like unparseable ones."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    min_available = spec.get("minAvailable")
    if not isinstance(min_available, int):
        # a percentage or unparseable minAvailable is not a gang signal;
        # skipping matches the reference (event_handlers.go:484-594) and
        # only forgoes gang semantics, never placement safety
        # kbt: allow[KBT004] percentage/unparseable minAvailable is not a
        # gang signal; skipping matches the reference (event_handlers.go:
        # 484-594) and only forgoes gang semantics, never placement safety
        return None
    return PodDisruptionBudget(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        min_available=min_available,
        owner=_controller_uid(meta),
        creation_index=creation_index_of(meta),
    )


def priority_class_from_k8s(obj: dict) -> PriorityClass:
    meta = obj.get("metadata") or {}
    return PriorityClass(
        name=meta.get("name", ""),
        value=int(obj.get("value") or 0),
        global_default=bool(obj.get("globalDefault")),
    )


# Sentinel "node" for a PV whose required nodeAffinity exists but isn't a
# recognizable single-node pin: it never equals a real hostname, so a ledger
# with no label knowledge treats the PV as reachable from NO node
# (fail-closed). The full nodeSelectorTerms now ride along on
# PersistentVolume.node_terms, and the ledger evaluates them against
# candidate node labels (the reference volumebinder's behavior) — the
# sentinel only bites when labels for the candidate are unknown, keeping
# the fail-closed floor without its zonal over-restriction.
PV_NODE_RESTRICTED_UNKNOWN = "__pv-node-affinity-unrecognized__"


def _pv_node_affinity(spec: dict) -> Tuple[Optional[str], tuple]:
    """A PV's (single-node pin, full required terms) from
    spec.nodeAffinity.required.

    The pin fast path reads the kubernetes.io/hostname / metadata.name In
    expression local-storage provisioning writes, so the common local-PV
    case never needs node labels. Terms are returned whenever required
    affinity exists — OR'd, in Affinity.node_terms shape — and the ledger
    evaluates them against candidate node labels; with affinity but no
    recognized pin the `node` field gets the fail-closed sentinel."""
    required = ((spec.get("nodeAffinity") or {}).get("required") or {})
    raw_terms = required.get("nodeSelectorTerms") or []
    if not raw_terms:
        # no required affinity: a network volume reachable from every
        # node (spec semantics, not unrecognized input)
        return None, ()
    terms = tuple(
        tuple(reqs) for reqs in (_match_expressions(t) for t in raw_terms) if reqs
    )
    pin = None
    for term in terms:
        # the pin fast path must only bypass term evaluation when the term
        # is NOTHING BUT the single-node expression: requirements within a
        # term are AND'd, so a term pairing a hostname pin with e.g. a zone
        # requirement pins conditionally and must evaluate in full — taking
        # the hostname alone would fail open on a node whose other labels
        # don't match
        if len(term) != 1:
            continue
        key, op, values = term[0]
        # _match_expressions folds matchFields metadata.name In onto the
        # hostname label (every kubelet sets it to the node name); some
        # provisioners put metadata.name in matchExpressions instead
        if (
            key in ("kubernetes.io/hostname", "metadata.name")
            and op == "In"
            and values
        ):
            pin = values[0]
            break
    return (pin if pin is not None else PV_NODE_RESTRICTED_UNKNOWN), terms


def pv_from_k8s(obj: dict) -> PersistentVolume:
    """v1.PersistentVolume JSON → ledger PV (cache.go:189-209 pv informer)."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    claim_ref = spec.get("claimRef") or {}
    claim = None
    if claim_ref.get("name"):
        claim = f"{claim_ref.get('namespace', 'default')}/{claim_ref['name']}"
    node, node_terms = _pv_node_affinity(spec)
    return PersistentVolume(
        name=meta.get("name", ""),
        node=node,
        claim=claim,
        storage_class=spec.get("storageClassName", ""),
        node_terms=node_terms,
    )


def pvc_from_k8s(obj: dict) -> PersistentVolumeClaim:
    """v1.PersistentVolumeClaim JSON → ledger claim (pvc informer)."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    return PersistentVolumeClaim(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        volume_name=spec.get("volumeName") or None,
        storage_class=spec.get("storageClassName", ""),
        phase=status.get("phase", "Pending"),
    )


# (binder type, method) pairs whose missing-ingest drop already logged —
# one loud line per combination, not one per event storm
_MISSING_INGEST_WARNED: set = set()


def _volume_ingest(binder, method: str, *args) -> None:
    """Dispatch one PV/PVC/StorageClass ingest event to the volume-binder
    seam.  The surface is declared on cache/interface.VolumeBinder; a
    binder lacking the method cannot ingest the event, and that is a REAL
    drop (a standalone ledger fed --master PVC events loses bindings), so
    it logs loudly once per (binder type, method) instead of silently
    failing open."""
    # the one seam probe: a miss is logged below (an observable drop),
    # never silently swallowed
    # kbt: allow[KBT008] the one audited seam probe: a miss is logged below
    # (observable drop), never silently swallowed
    fn = getattr(binder, method, None)
    if fn is None:
        key = (type(binder).__name__, method)
        if key not in _MISSING_INGEST_WARNED:
            _MISSING_INGEST_WARNED.add(key)
            logger.warning(
                "volume binder %s has no %s(); dropping these ingest "
                "events (volume topology decisions will not see them)",
                type(binder).__name__, method,
            )
        return
    fn(*args)


def apply_event(cache, kind: str, event_type: str, obj: dict) -> None:
    """Dispatch one watch event into the cache — the informer handler seam
    (event_handlers.go). `kind` is the lowercase resource (pods, nodes,
    podgroups, queues, poddisruptionbudgets, priorityclasses); `event_type`
    is ADDED | MODIFIED | DELETED."""
    deleted = event_type == "DELETED"
    if kind == "pods":
        pod = pod_from_k8s(obj)
        if deleted:
            cache.delete_pod(pod)
        elif event_type == "ADDED":
            cache.add_pod(pod)
        else:
            cache.update_pod(pod)
    elif kind == "nodes":
        if deleted:
            cache.delete_node((obj.get("metadata") or {}).get("name", ""))
        else:
            cache.add_node(node_from_k8s(obj))
    elif kind == "podgroups":
        pg = pod_group_from_k8s(obj)
        if deleted:
            cache.delete_pod_group(pg.key())
        else:
            cache.add_pod_group(pg)
    elif kind == "queues":
        q = queue_from_k8s(obj)
        if deleted:
            cache.delete_queue(q.name)
        else:
            cache.add_queue(q)
    elif kind == "poddisruptionbudgets":
        pdb = pdb_from_k8s(obj)
        if pdb is None:
            return
        if deleted:
            cache.delete_pdb(pdb)
        else:
            cache.add_pdb(pdb)
    elif kind == "priorityclasses":
        if deleted:
            cache.delete_priority_class(
                (obj.get("metadata") or {}).get("name", "")
            )
        else:
            cache.add_priority_class(priority_class_from_k8s(obj))
    elif kind == "persistentvolumes":
        # PV ledger seam (cache.go:189-209), dispatched through
        # _volume_ingest so a binder without the method drops LOUDLY
        binder = cache.volume_binder
        if deleted:
            _volume_ingest(
                binder, "delete_pv", (obj.get("metadata") or {}).get("name", "")
            )
        else:
            _volume_ingest(binder, "add_pv", pv_from_k8s(obj))
    elif kind == "persistentvolumeclaims":
        binder = cache.volume_binder
        pvc = pvc_from_k8s(obj)
        if deleted:
            _volume_ingest(binder, "delete_pvc", pvc.key())
        else:
            _volume_ingest(binder, "add_pvc", pvc)
    elif kind == "storageclasses":
        binder = cache.volume_binder
        name = (obj.get("metadata") or {}).get("name", "")
        if deleted:
            _volume_ingest(binder, "delete_storage_class", name)
        else:
            _volume_ingest(
                binder, "add_storage_class", name, obj.get("provisioner", "")
            )
    else:
        logger.warning("unknown watch kind %r ignored", kind)
