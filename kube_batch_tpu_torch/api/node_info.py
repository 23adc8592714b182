"""NodeInfo — per-node resource accounting with the three-way status algebra.

Mirrors ``kube_batch_tpu/api/node_info.py`` (the reference's
node_info.go:28-222).  A task's effect on the node's (Idle, Used,
Releasing) triple depends on its status:

    Releasing task:  Releasing += r ; Idle -= r ; Used += r
    Pipelined task:  Releasing -= r            ; Used += r
    other allocated: Idle -= r                 ; Used += r

so "fits in Releasing" means: the request fits in resources on their way
back.  The node stores the caller's task object and records the status it
was accounted under (``_acct``), so ``remove_task`` reverses exactly what
``add_task`` did even after the task's status moved.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from kube_batch_tpu_torch.api.pod import Node
from kube_batch_tpu_torch.api.resources import Resource, ResourceSpec
from kube_batch_tpu_torch.api.task_info import TaskInfo
from kube_batch_tpu_torch.api.types import TaskStatus, is_allocated
from kube_batch_tpu_torch.utils.assertions import graft_assert


def _node_resource(node: Node, spec: ResourceSpec, which: str) -> Resource:
    src = node.allocatable if which == "allocatable" else node.capacity
    r = spec.empty()
    for name, v in src.items():
        if name in spec:
            r.vec[spec.index(name)] = float(v)
    return r


class NodeInfo:
    def __init__(self, node: Optional[Node], spec: ResourceSpec):
        self.spec = spec
        self.name: str = node.name if node else ""
        self.node: Optional[Node] = node
        self.tasks: Dict[str, TaskInfo] = {}
        if node is not None:
            self.allocatable = _node_resource(node, spec, "allocatable")
            self.capability = _node_resource(node, spec, "capacity")
        else:
            self.allocatable = spec.empty()
            self.capability = spec.empty()
        self.idle = self.allocatable.clone()
        self.used = spec.empty()
        self.releasing = spec.empty()
        # status each resident task was ACCOUNTED under
        self._acct: Dict[str, TaskStatus] = {}
        # ColumnStore binding (api/columns.py): when bound, the five ledger
        # Resources are views into the store's [N, R] matrices
        self._cols = None
        self._row: int = -1
        self._set_state()

    # -- state machine (node_info.go:110-134) -----------------------------
    def _set_state(self) -> None:
        """setNodeState: UnInitialized without a node object, OutOfSync when
        resident pods use more than allocatable, else Ready/NotReady.  The
        state is stored and recomputed only on set_node."""
        if self.node is None:
            self._state = "UnInitialized"
        elif not self.used.less_equal(self.allocatable):
            self._state = "OutOfSync"
        elif not self.node.ready:
            self._state = "NotReady"
        else:
            self._state = "Ready"

    @property
    def ready(self) -> bool:
        return self._state == "Ready"

    def set_node(self, node: Node) -> None:
        """Update the node object, rebuilding (Idle, Used, Releasing) from the
        new allocatable and replaying every resident task's algebra
        (node_info.go:137-162 SetNode).  The replay clamps Idle at zero; an
        over-used node reports OutOfSync and leaves the snapshot."""
        self.name = node.name
        self.node = node
        alloc = _node_resource(node, self.spec, "allocatable")
        cap = _node_resource(node, self.spec, "capacity")
        idle_v = alloc.vec.copy()
        used_v = self.spec.empty().vec
        rel_v = self.spec.empty().vec
        acct = self._acct
        for key, t in self.tasks.items():
            r = t.resreq.vec
            acct[key] = t.status  # re-account under the live status
            if t.status == TaskStatus.RELEASING:
                rel_v += r
                idle_v -= r
                used_v += r
            elif t.status == TaskStatus.PIPELINED:
                rel_v -= r
                used_v += r
            elif is_allocated(t.status):
                idle_v -= r
                used_v += r
            t.node_name = node.name
        np.maximum(idle_v, 0.0, out=idle_v)
        np.maximum(rel_v, 0.0, out=rel_v)
        if self._cols is None:
            self.allocatable, self.capability = alloc, cap
            self.idle = Resource(idle_v, self.spec)
            self.used = Resource(used_v, self.spec)
            self.releasing = Resource(rel_v, self.spec)
        else:
            # column-bound: write through the ledger views in place; an
            # actual allocatable change invalidates the resident n_alloc
            if not np.array_equal(self.allocatable.vec, alloc.vec):
                self._cols.bump_node_features()
            self._note_ledger()
            self.allocatable.vec[:] = alloc.vec
            self.capability.vec[:] = cap.vec
            self.idle.vec[:] = idle_v
            self.used.vec[:] = used_v
            self.releasing.vec[:] = rel_v
        self._set_state()
        if self._cols is not None:
            self._cols.sync_node_meta(self)

    def demote_to_placeholder(self) -> None:
        """Forget the Node object but keep the resident task registrations
        (a node deleted while pods are still bound to it): accounting zeroes
        out, the node leaves the snapshot, and a re-add replays everything
        through set_node."""
        self.node = None
        if self._cols is None:
            self.allocatable = self.spec.empty()
            self.capability = self.spec.empty()
            self.idle = self.spec.empty()
            self.used = self.spec.empty()
            self.releasing = self.spec.empty()
        else:
            for res in (self.idle, self.used, self.releasing,
                        self.allocatable, self.capability):
                res.vec[:] = 0.0
            # n_alloc is a resident feature column, and sync_node_meta
            # returns early without a Node object
            self._cols.bump_node_features()
            self._note_ledger()
        self._set_state()
        if self._cols is not None:
            self._cols.sync_node_meta(self)

    def _note_ledger(self) -> None:
        """The ledger choke point: every (Idle, Used, Releasing,
        Allocatable) write marks this node's row, so the snapshot's float32
        twins refresh exactly the touched rows (``columns.node_ledgers32``)."""
        if self._cols is not None:
            self._cols.note_node_ledger(self._row)

    # -- task algebra (node_info.go:165-222) ------------------------------
    def add_task(self, task: TaskInfo) -> None:
        key = task.key()
        graft_assert(key not in self.tasks, f"duplicate task {key} on node {self.name}")
        status = task.status
        if self.node is not None:
            self._note_ledger()
            r = task.resreq
            if status == TaskStatus.RELEASING:
                self.releasing.add_(r)
                self.idle.sub_(r)
                self.used.add_(r)
            elif status == TaskStatus.PIPELINED:
                self.releasing.sub_(r)
                self.used.add_(r)
            elif is_allocated(status):
                self.idle.sub_(r)
                self.used.add_(r)
        task.node_name = self.name
        self.tasks[key] = task
        self._acct[key] = status

    def remove_task(self, task: TaskInfo) -> None:
        key = task.key()
        existing = self.tasks.get(key)
        graft_assert(existing is not None, f"task {key} not on node {self.name}")
        if existing is not None:
            status = self._acct.pop(key, existing.status)
            if self.node is not None:
                self._note_ledger()
                r = existing.resreq
                if status == TaskStatus.RELEASING:
                    self.releasing.sub_(r)
                    self.idle.add_(r)
                    self.used.sub_(r)
                elif status == TaskStatus.PIPELINED:
                    self.releasing.add_(r)
                    self.used.sub_(r)
                elif is_allocated(status):
                    self.idle.add_(r)
                    self.used.sub_(r)
        self.tasks.pop(key, None)

    def update_task(self, task: TaskInfo) -> None:
        """Re-account a task under its current status (node_info.go:225-233)."""
        self.remove_task(task)
        self.add_task(task)

    def bulk_add_tasks(self, alloc_tasks, pipe_tasks, alloc_sum, pipe_sum) -> None:
        """add_task for a batch, for the object-session allocate replay:
        ``alloc_tasks`` carry an allocated status, ``pipe_tasks`` are
        Pipelined, and ``alloc_sum`` / ``pipe_sum`` are their presummed
        Resources, so the status algebra is two vector ops per group."""
        tasks = self.tasks
        acct = self._acct
        name = self.name
        for group in (alloc_tasks, pipe_tasks):
            for task in group:
                key = task._key
                if key in tasks:
                    graft_assert(False, f"duplicate task {key} on node {name}")
                task.node_name = name
                tasks[key] = task
                acct[key] = task.status
        if self.node is not None:
            self._note_ledger()
            self.idle.sub_(alloc_sum)
            self.used.add_(alloc_sum)
            self.used.add_(pipe_sum)
            self.releasing.sub_(pipe_sum)

    def bulk_register_tasks(self, alloc_tasks, pipe_tasks) -> None:
        """Task-dict / ``_acct`` registration only, for the columnar
        allocate replay: the ledger algebra was already applied to this
        node's rows by whole-matrix column ops."""
        tasks = self.tasks
        acct = self._acct
        name = self.name
        for group, status in ((alloc_tasks, TaskStatus.BINDING),
                              (pipe_tasks, TaskStatus.PIPELINED)):
            for task in group:
                key = task._key
                if key in tasks:
                    graft_assert(False, f"duplicate task {key} on node {name}")
                task._node_name = name
                tasks[key] = task
                acct[key] = status

    def clone(self) -> "NodeInfo":
        """A copy for an isolated session: never column-bound, the ledger
        triple copied rather than replayed, the resident tasks cloned (the
        session moves their statuses in place)."""
        n = NodeInfo.__new__(NodeInfo)
        n._cols = None
        n._row = -1
        n.spec = self.spec
        n.name = self.name
        n.node = self.node
        # a bound node's allocatable / capability are column views that
        # set_node writes in place: the clone needs value semantics
        if self._cols is None:
            n.allocatable = self.allocatable
            n.capability = self.capability
        else:
            n.allocatable = self.allocatable.clone()
            n.capability = self.capability.clone()
        n.idle = self.idle.clone()
        n.used = self.used.clone()
        n.releasing = self.releasing.clone()
        n.tasks = {key: t.clone() for key, t in self.tasks.items()}
        n._acct = dict(self._acct)
        n._state = self._state
        return n

    @property
    def pod_count(self) -> int:
        return len(self.tasks)

    def __repr__(self) -> str:
        return (f"NodeInfo({self.name} idle={self.idle} used={self.used} "
                f"releasing={self.releasing})")
