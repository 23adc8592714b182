"""binpack plugin — weighted-resource packing score.

Absent from the reference snapshot (it arrived later in Volcano) but named by
the rebuild's north star (SURVEY.md §2.4 note): prefer filling nodes to
spreading, so large gangs find contiguous capacity. Configures the device
binpack score row; also registers a host scorer.  Mirrors
``kube_batch_tpu/plugins/binpack.py``."""

from __future__ import annotations

from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework import session as fw

BINPACK_WEIGHT = "binpack.weight"
MAX_PRIORITY = 10.0


def binpack_score(task: TaskInfo, node: NodeInfo) -> float:
    total = 0.0
    for i in (0, 1):
        alloc = node.allocatable.vec[i]
        if alloc <= 0:
            continue
        want = node.used.vec[i] + task.resreq.vec[i]
        total += min(want / alloc, 1.0) * MAX_PRIORITY
    return total / 2.0


class BinpackPlugin(Plugin):
    name = "binpack"

    def on_session_open(self, ssn: fw.Session) -> None:
        weight = self.arguments.get_int(BINPACK_WEIGHT, 1)
        ssn.score_weights = ssn.score_weights._replace(binpack=float(weight))

        def node_order(task: TaskInfo, node: NodeInfo) -> float:
            return weight * binpack_score(task, node)

        ssn.add_fn(fw.NODE_ORDER, self.name, node_order)
