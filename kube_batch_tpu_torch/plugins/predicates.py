"""predicates plugin (plugins/predicates/predicates.go) — node filtering.

The device solve evaluates these same predicates as bitset tensor ops
(ops/feasibility.py); this host fn is the authoritative per-(task, node)
form used by the host-path actions (preempt/reclaim/backfill) and by tests.

Checks, mirroring predicates.go:154-298:
  max-pods (:162-166), CheckNodeCondition/Unschedulable (:169-192),
  MatchNodeSelector incl. required node-affinity terms (:194-205),
  PodFitsHostPorts (:207-218), PodToleratesNodeTaints (:220-231), and the
  optional Memory/Disk/PID pressure gates driven by plugin arguments
  (:233-276; arg keys :34-41), and required inter-pod affinity/anti-affinity
  with the affinity-only fast path (:278-296). The device mask carries a
  snapshot-time approximation of the inter-pod terms (the snapshot's
  correction rows); this host predicate re-validates every proposed
  placement against LIVE session state, so two anti-affine tasks placed in
  one device round can't both commit.  Mirrors
``kube_batch_tpu/plugins/predicates.py``.
"""

from __future__ import annotations

from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.pod import node_selector_terms_match
from kube_batch_tpu_torch.api.snapshot import HARD_TAINT_EFFECTS
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework import session as fw

# plugin argument keys (predicates.go:34-41)
MEMORY_PRESSURE_KEY = "predicate.MemoryPressureEnable"
DISK_PRESSURE_KEY = "predicate.DiskPressureEnable"
PID_PRESSURE_KEY = "predicate.PIDPressureEnable"


def match_node_selector(task: TaskInfo, node: NodeInfo) -> bool:
    labels = node.node.labels if node.node else {}
    for k, v in task.pod.node_selector.items():
        if labels.get(k) != v:
            return False
    if task.pod.affinity is not None:
        terms = task.pod.affinity.node_terms
        # shared evaluator (api/pod.py) — also the PV ledger's reachability
        # check; adds Gt/Lt and fails closed on unknown operators (the old
        # inline check silently passed them)
        if terms and not node_selector_terms_match(terms, labels):
            return False
    return True


def tolerates_taints(task: TaskInfo, node: NodeInfo) -> bool:
    for taint in node.node.taints if node.node else []:
        if taint.effect not in HARD_TAINT_EFFECTS:
            continue
        if not any(tol.tolerates(taint) for tol in task.pod.tolerations):
            return False
    return True


def _topology_domain(node: NodeInfo, topology_key: str, all_nodes) -> list:
    """Nodes in `node`'s topology domain (hostname ⇒ just the node)."""
    from kube_batch_tpu_torch.api.pod import HOSTNAME_TOPOLOGY

    if topology_key == HOSTNAME_TOPOLOGY:
        return [node]
    labels = node.node.labels if node.node else {}
    value = labels.get(topology_key)
    if value is None:
        return [node]
    return [
        n for n in all_nodes
        if n.node is not None and n.node.labels.get(topology_key) == value
    ]


def pod_affinity_ok(task: TaskInfo, node: NodeInfo, all_nodes) -> bool:
    """InterPodAffinityMatches (predicates.go:278-296): required affinity
    terms need a matching existing pod in the node's topology domain —
    unless NO pod matches anywhere (the affinity-only fast path, letting a
    group's first pod land); anti-affinity terms must have no match in the
    domain. Placements made earlier in this session count — node.tasks is
    live session state."""
    aff = task.pod.affinity
    if aff is None:
        return True
    for term in aff.pod_affinity:
        domain = _topology_domain(node, term.topology_key, all_nodes)
        if any(
            term.matches(t.pod.labels)
            for n in domain for t in n.tasks.values()
        ):
            continue
        # fast path: a term no pod satisfies cluster-wide doesn't block
        if any(
            term.matches(t.pod.labels)
            for n in all_nodes for t in n.tasks.values()
        ):
            return False
    for term in aff.pod_anti_affinity:
        domain = _topology_domain(node, term.topology_key, all_nodes)
        if any(
            term.matches(t.pod.labels) and t.key() != task.key()
            for n in domain for t in n.tasks.values()
        ):
            return False
    return True


def fits_host_ports(task: TaskInfo, node: NodeInfo) -> bool:
    wanted = set(task.pod.host_ports)
    if not wanted:
        return True
    for other in node.tasks.values():
        if wanted & set(other.pod.host_ports):
            return False
    return True


class PredicatesPlugin(Plugin):
    name = "predicates"

    def on_session_open(self, ssn: fw.Session) -> None:
        check_mem = self.arguments.get_bool(MEMORY_PRESSURE_KEY, False)
        check_disk = self.arguments.get_bool(DISK_PRESSURE_KEY, False)
        check_pid = self.arguments.get_bool(PID_PRESSURE_KEY, False)
        # pressure gates are task-independent node vetoes
        # (predicates.go:233-276): encode them as a session-level node
        # exclusion the snapshot folds into node_sched — the device
        # mask stays exact and no job is demoted to the host replay for them
        if check_mem or check_disk or check_pid:
            for node in ssn.nodes.values():
                obj = node.node
                if obj is None:
                    continue
                conds = obj.conditions
                if (
                    (check_mem and conds.get("MemoryPressure"))
                    or (check_disk and conds.get("DiskPressure"))
                    or (check_pid and conds.get("PIDPressure"))
                ):
                    ssn.session_excluded_nodes.add(node.name)

        def predicate(task: TaskInfo, node: NodeInfo) -> None:
            if node.node is None or not node.node.ready:
                raise fw.FitFailure("node(s) were not ready")
            if node.node.unschedulable:
                raise fw.FitFailure("node(s) were unschedulable")
            if node.pod_count + 1 > int(node.allocatable.pods):
                raise fw.FitFailure("node(s) pod number exceeded")
            if not match_node_selector(task, node):
                raise fw.FitFailure("node(s) didn't match node selector")
            if not fits_host_ports(task, node):
                raise fw.FitFailure("node(s) didn't have free ports")
            if not tolerates_taints(task, node):
                raise fw.FitFailure("node(s) had taints that the pod didn't tolerate")
            if not pod_affinity_ok(task, node, ssn.nodes.values()):
                raise fw.FitFailure(
                    "node(s) didn't satisfy inter-pod affinity/anti-affinity"
                )
            conds = node.node.conditions
            if check_mem and conds.get("MemoryPressure"):
                raise fw.FitFailure("node(s) had memory pressure")
            if check_disk and conds.get("DiskPressure"):
                raise fw.FitFailure("node(s) had disk pressure")
            if check_pid and conds.get("PIDPressure"):
                raise fw.FitFailure("node(s) had pid pressure")

        ssn.add_fn(fw.PREDICATE, self.name, predicate)
