"""nodeorder plugin (plugins/nodeorder/nodeorder.go) — weighted node scoring.

Configures the device score rows (ops/scoring.py) via session.score_weights
and registers the host per-(task, node) scorer used by preempt/reclaim.
Weights come from plugin arguments (nodeorder.go:34-43), default 1 each.
Mirrors ``kube_batch_tpu/plugins/nodeorder.py``.
"""

from __future__ import annotations

import numpy as np

from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework import session as fw

NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"

MAX_PRIORITY = 10.0


def minmax_scale_rows(raw):
    """Min-max reduce score rows to the 0..10 priority scale, per row (k8s
    InterPodAffinityPriority's reduce): 10·(v−min)/(max−min), all-zero when a
    row is constant. `raw` is [K, N]; returns same shape. Single definition
    shared by the host scorer below and the device snapshot rows
    (api/columns.py) so the two can't diverge."""
    mn = raw.min(axis=1, keepdims=True)
    rng = raw.max(axis=1, keepdims=True) - mn
    return np.where(
        rng > 0, MAX_PRIORITY * (raw - mn) / np.where(rng > 0, rng, 1.0), 0.0
    )


def least_requested_score(task: TaskInfo, node: NodeInfo) -> float:
    total = 0.0
    for i in (0, 1):  # cpu, memory
        alloc = node.allocatable.vec[i]
        if alloc <= 0:
            continue
        free = alloc - node.used.vec[i] - task.resreq.vec[i]
        total += max(min(free / alloc, 1.0), 0.0) * MAX_PRIORITY
    return total / 2.0


def balanced_resource_score(task: TaskInfo, node: NodeInfo) -> float:
    fracs = []
    for i in (0, 1):
        alloc = node.allocatable.vec[i]
        want = node.used.vec[i] + task.resreq.vec[i]
        fracs.append(min(want / alloc, 1.0) if alloc > 0 else 1.0)
    return (1.0 - abs(fracs[0] - fracs[1])) * MAX_PRIORITY


def _term_matches(term, labels) -> bool:
    for key, op, values in term:
        has = key in labels
        if op == "In" and labels.get(key) not in values:
            return False
        if op == "NotIn" and labels.get(key) in values:
            return False
        if op == "Exists" and not has:
            return False
        if op == "DoesNotExist" and has:
            return False
    return True


def preferred_node_affinity_score(task: TaskInfo, node: NodeInfo) -> float:
    """CalculateNodeAffinityPriorityMap analog (nodeorder.go:188-205): sum of
    weights of matching preferred terms. Raw weighted sum — the reference
    normalizes to 0..10 over the batch, a monotone rescale that never changes
    the argmax."""
    aff = task.pod.affinity
    if aff is None or not aff.preferred_node_terms:
        return 0.0
    labels = node.node.labels if node.node else {}
    return float(sum(
        w for w, term in aff.preferred_node_terms if _term_matches(term, labels)
    ))


def preferred_pod_affinity_score(task: TaskInfo, node: NodeInfo, all_nodes) -> float:
    """InterPodAffinityPriority analog (nodeorder.go:229-247): each preferred
    pod-affinity term adds its weight when a matching pod exists in the
    node's topology domain; anti-affinity terms subtract."""
    from kube_batch_tpu_torch.plugins.predicates import _topology_domain

    aff = task.pod.affinity
    if aff is None:
        return 0.0
    score = 0.0
    for sign, terms in (
        (1.0, aff.preferred_pod_affinity),
        (-1.0, aff.preferred_pod_anti_affinity),
    ):
        for w, term in terms:
            domain = _topology_domain(node, term.topology_key, all_nodes)
            if any(
                term.matches(t.pod.labels)
                for n in domain for t in n.tasks.values()
            ):
                score += sign * w
    return score


class NodeOrderPlugin(Plugin):
    name = "nodeorder"

    def on_session_open(self, ssn: fw.Session) -> None:
        w_least = self.arguments.get_int(LEAST_REQUESTED_WEIGHT, 1)
        w_balanced = self.arguments.get_int(BALANCED_RESOURCE_WEIGHT, 1)
        w_affinity = self.arguments.get_int(NODE_AFFINITY_WEIGHT, 1)
        w_pod_aff = self.arguments.get_int(POD_AFFINITY_WEIGHT, 1)

        ssn.score_weights = ssn.score_weights._replace(
            least_requested=float(w_least),
            balanced_resource=float(w_balanced),
            node_affinity=float(w_affinity),
            pod_affinity=float(w_pod_aff),
        )

        # per-task normalized pod-affinity rows, memoized for the session —
        # InterPodAffinityPriority min-max reduces raw ±weight sums to the
        # 0..10 priority scale across the node batch before weighting, so a
        # large term weight (k8s allows 100) can't dominate the bounded
        # least-requested/balanced rows. Memo trades exactness under
        # mid-session placement churn for O(N) instead of O(N²) host scoring
        # (scores are preferences, and the reference's batch scorer is
        # likewise computed once per PrioritizeNodes call).
        pod_aff_rows: dict = {}

        def normalized_pod_affinity(task: TaskInfo, node: NodeInfo) -> float:
            aff = task.pod.affinity
            if aff is None or not (
                aff.preferred_pod_affinity or aff.preferred_pod_anti_affinity
            ):
                return 0.0
            row = pod_aff_rows.get(task.key())
            if row is None:
                node_objs = list(ssn.nodes.values())
                raw = np.array(
                    [[preferred_pod_affinity_score(task, n, node_objs)
                      for n in node_objs]]
                )
                scaled = minmax_scale_rows(raw)[0]
                row = {n.name: float(s) for n, s in zip(node_objs, scaled)}
                pod_aff_rows[task.key()] = row
            return row.get(node.name, 0.0)

        def node_order(task: TaskInfo, node: NodeInfo) -> float:
            return (
                w_least * least_requested_score(task, node)
                + w_balanced * balanced_resource_score(task, node)
                + w_affinity * preferred_node_affinity_score(task, node)
                + w_pod_aff * normalized_pod_affinity(task, node)
            )

        ssn.add_fn(fw.NODE_ORDER, self.name, node_order)
