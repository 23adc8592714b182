"""The ingest object model: Pod, PodGroup, Queue, Node specs.

Mirrors ``kube_batch_tpu/api/pod.py`` field for field (the reference's
v1.Pod / v1.Node and the PodGroup and Queue CRDs,
pkg/apis/scheduling/v1alpha1/types.go:93-223), so one list of constructor
keyword arguments builds the same cluster in either package, the
PodDisruptionBudget gang source and the volume objects (PersistentVolume,
PersistentVolumeClaim) included.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Tuple

from kube_batch_tpu_torch.api.types import PodGroupPhase, PodPhase

# Annotation linking a Pod to its PodGroup (apis/scheduling/v1alpha1/labels.go:21).
GROUP_NAME_ANNOTATION = "scheduling.k8s.io/group-name"

_uid_counter = itertools.count()


def _auto_uid(prefix: str) -> str:
    return f"{prefix}-{next(_uid_counter)}"


@dataclasses.dataclass
class Toleration:
    """Pod toleration (subset of v1.Toleration the predicates read)."""

    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclasses.dataclass
class Taint:
    """Node taint (v1.Taint subset; effects NoSchedule/PreferNoSchedule/NoExecute)."""

    key: str
    value: str = ""
    effect: str = "NoSchedule"


HOSTNAME_TOPOLOGY = "kubernetes.io/hostname"


def node_selector_terms_match(
    terms, labels: Mapping[str, str]
) -> bool:
    """Evaluate v1.NodeSelectorTerms against a node's labels: terms are OR'd,
    the (key, operator, values) requirements within a term are AND'd — the
    vendored MatchNodeSelector semantics (predicates.go:194-205). Used by
    the host predicate (plugins/predicates.py).

    Operators: In / NotIn / Exists / DoesNotExist / Gt / Lt. An operator
    outside that set fails its requirement (fail closed) — the reference's
    selector constructor errors on unknown operators rather than matching."""

    def _req_ok(key: str, op: str, values) -> bool:
        present = key in labels
        val = labels.get(key)
        if op == "In":
            return val in values
        if op == "NotIn":
            return val not in values
        if op == "Exists":
            return present
        if op == "DoesNotExist":
            return not present
        if op in ("Gt", "Lt"):
            if not present or not values:
                return False
            try:
                lv, rv = int(val), int(values[0])
            except (TypeError, ValueError):
                return False
            return lv > rv if op == "Gt" else lv < rv
        return False

    return any(
        all(_req_ok(key, op, values) for key, op, values in term)
        for term in terms
    )


@dataclasses.dataclass
class PodAffinityTerm:
    """Required inter-pod (anti-)affinity term (the
    InterPodAffinityMatches predicate's input, predicates.go:278-296):
    match_labels select existing pods; topology_key partitions nodes into
    domains (hostname ⇒ per-node; any other key ⇒ nodes sharing that node
    label's value)."""

    match_labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    topology_key: str = HOSTNAME_TOPOLOGY

    def matches(self, labels: Mapping[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in self.match_labels.items())


@dataclasses.dataclass
class Affinity:
    """Required-node-affinity as match-expression terms, plus required
    inter-pod affinity/anti-affinity.

    Each node term is a list of (key, operator, values) requirements; terms
    are OR'd, requirements within a term are AND'd — the same shape as
    v1.NodeSelectorTerms consumed by the vendored MatchNodeSelector predicate
    (predicates.go:194-205).
    """

    node_terms: List[List[Tuple[str, str, Tuple[str, ...]]]] = dataclasses.field(
        default_factory=list
    )
    pod_affinity: List[PodAffinityTerm] = dataclasses.field(default_factory=list)
    pod_anti_affinity: List[PodAffinityTerm] = dataclasses.field(default_factory=list)
    # preferred (soft) terms, each (weight, term) — the Priority-function
    # inputs (CalculateNodeAffinityPriorityMap / InterPodAffinityPriority,
    # nodeorder.go:188-247): matching terms add weight to the node's score
    preferred_node_terms: List[
        Tuple[float, List[Tuple[str, str, Tuple[str, ...]]]]
    ] = dataclasses.field(default_factory=list)
    preferred_pod_affinity: List[Tuple[float, PodAffinityTerm]] = dataclasses.field(
        default_factory=list
    )
    preferred_pod_anti_affinity: List[Tuple[float, PodAffinityTerm]] = (
        dataclasses.field(default_factory=list)
    )

    def has_preferences(self) -> bool:
        return bool(
            self.preferred_node_terms
            or self.preferred_pod_affinity
            or self.preferred_pod_anti_affinity
        )


@dataclasses.dataclass
class PodDisruptionBudget:
    """The legacy gang source (event_handlers.go:484-594): a PDB owned by
    the same controller as a set of pods turns that owner's job into a gang
    of min_available, always in the default queue. Jobs defined only by a
    PDB get events-only status updates (job_updater.go:108-111)."""

    name: str
    namespace: str = "default"
    min_available: int = 1
    # controller/owner UID linking the PDB to its pods' job
    owner: Optional[str] = None
    creation_index: int = 0


@dataclasses.dataclass
class PersistentVolume:
    """Standalone PersistentVolume analog (the reference wraps the k8s
    volumebinder over PV/PVC/StorageClass informers, cache.go:189-209). A
    named volume, optionally reachable from a single node only (local PV),
    optionally pre-bound to a claim (static provisioning)."""

    name: str
    node: Optional[str] = None   # None = accessible from every node
    claim: Optional[str] = None  # pre-bound PVC name; None = matches any claim
    # k8s mode: PVs bind only claims of the same storage class; standalone
    # ingest leaves it empty (matches empty-class claims)
    storage_class: str = ""
    # full spec.nodeAffinity.required nodeSelectorTerms (same (key, op,
    # values) shape as Affinity.node_terms): carried whenever the PV has
    # required affinity, so the ledger can evaluate zonal/regional topology
    # against candidate node labels instead of failing closed on anything
    # beyond a single-node pin (`node` stays the recognized-pin fast path)
    node_terms: Tuple = ()


@dataclasses.dataclass
class PersistentVolumeClaim:
    """The claim side of the PV ledger in --master mode: carries the durable
    PVC→PV binding (spec.volumeName) and the storage class that decides
    whether an unbound claim is dynamically provisionable
    (cache.go:258-269 feeds the k8s volumebinder from the pvc informer)."""

    name: str
    namespace: str = "default"
    volume_name: Optional[str] = None  # spec.volumeName — bound PV
    storage_class: str = ""
    phase: str = "Pending"

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass
class Pod:
    """The scheduler-visible slice of a pod spec + status."""

    name: str
    namespace: str = "default"
    uid: str = ""
    # resource requests: sum over app containers; init-containers folded into
    # InitResreq by TaskInfo (pod_info.go:53-73)
    requests: Dict[str, float] = dataclasses.field(default_factory=dict)
    init_requests: Dict[str, float] = dataclasses.field(default_factory=dict)
    node_name: Optional[str] = None
    phase: PodPhase = PodPhase.PENDING
    deleting: bool = False  # DeletionTimestamp set
    priority: int = 0
    priority_class: str = ""
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    tolerations: List[Toleration] = dataclasses.field(default_factory=list)
    affinity: Optional[Affinity] = None
    host_ports: Tuple[int, ...] = ()
    scheduler_name: str = "volcano"
    creation_index: int = 0  # monotone stand-in for CreationTimestamp
    # names of PersistentVolumeClaims the pod mounts (the standalone analog
    # of pod.spec.volumes[*].persistentVolumeClaim.claimName), handed to
    # the cache's volume binder seam (cache.go:189-209)
    volume_claims: Tuple[str, ...] = ()
    # controller/owner UID (metav1.GetControllerOf analog): pods sharing an
    # owner share a job when no group-name annotation is set
    # (cache/util.go:42-46, apis/utils/utils.go:25-37)
    owner: Optional[str] = None

    def __post_init__(self):
        if not self.uid:
            self.uid = _auto_uid(f"pod-{self.namespace}-{self.name}")

    @property
    def group_name(self) -> Optional[str]:
        return self.annotations.get(GROUP_NAME_ANNOTATION)

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass
class PodGroup:
    """PodGroup CRD (apis/scheduling/v1alpha1/types.go:93-171)."""

    name: str
    namespace: str = "default"
    uid: str = ""
    min_member: int = 1
    queue: str = ""
    priority_class: str = ""
    min_resources: Optional[Dict[str, float]] = None
    # None = zero-value phase: a PodGroup created without status passes the
    # allocate action's Pending-phase gate (allocate.go:50-52 only skips an
    # explicit PodGroupPending; the enqueue action only promotes explicit
    # Pending to Inqueue, enqueue.go:66,115)
    phase: Optional[PodGroupPhase] = None
    conditions: List["PodGroupCondition"] = dataclasses.field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    creation_index: int = 0
    shadow: bool = False  # synthesized for a plain pod (cache/util.go:42-60)

    def __post_init__(self):
        if not self.uid:
            self.uid = _auto_uid(f"pg-{self.namespace}-{self.name}")

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "PodGroup":
        # copy.copy + manual deep bits: dataclasses.replace re-runs field
        # resolution and __post_init__ (~10x slower; hot in cache.snapshot)
        pg = copy.copy(self)
        pg.conditions = [copy.copy(c) for c in self.conditions]
        pg.min_resources = dict(self.min_resources) if self.min_resources else None
        return pg


@dataclasses.dataclass
class PodGroupCondition:
    """(types.go:55-73)"""

    type: str
    status: str = "True"
    transition_id: str = ""
    reason: str = ""
    message: str = ""


@dataclasses.dataclass
class Queue:
    """Queue CRD (types.go:178-223): weighted share + optional capability cap."""

    name: str
    uid: str = ""
    weight: int = 1
    capability: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if not self.uid:
            self.uid = _auto_uid(f"queue-{self.name}")


@dataclasses.dataclass
class Node:
    """The scheduler-visible slice of a v1.Node."""

    name: str
    allocatable: Dict[str, float] = dataclasses.field(default_factory=dict)
    capacity: Dict[str, float] = dataclasses.field(default_factory=dict)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    taints: List[Taint] = dataclasses.field(default_factory=list)
    ready: bool = True
    unschedulable: bool = False
    conditions: Dict[str, bool] = dataclasses.field(default_factory=dict)
    # conditions: e.g. {"MemoryPressure": True}; consumed by the optional
    # pressure predicates (predicates.go:233-276)

    def __post_init__(self):
        if not self.capacity:
            self.capacity = dict(self.allocatable)


@dataclasses.dataclass
class PriorityClass:
    name: str
    value: int
    global_default: bool = False
