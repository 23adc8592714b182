"""Status enums and phase mappings.

Mirrors ``kube_batch_tpu/api/types.py`` (the reference's
pkg/scheduler/api/types.go:24-58, helpers.go:35-71 and
pkg/apis/scheduling/v1alpha1/types.go:28-73); the integer values of
``TaskStatus`` are identical, so a snapshot's ``task_status`` column means
the same thing in both packages.
"""

from __future__ import annotations

import enum


class TaskStatus(enum.IntEnum):
    """Task lifecycle states (types.go:24-58)."""

    PENDING = 0      # not scheduled
    ALLOCATED = 1    # resources assigned this session, not yet dispatched
    PIPELINED = 2    # assigned onto resources that are still being released
    BINDING = 3      # bind RPC in flight
    BOUND = 4        # bind acknowledged
    RUNNING = 5
    RELEASING = 6    # eviction/deletion in flight
    SUCCEEDED = 7
    FAILED = 8
    UNKNOWN = 9


# Statuses that occupy real (not future) node resources, helpers.go:63-71.
ALLOCATED_STATUSES = frozenset(
    {TaskStatus.BOUND, TaskStatus.BINDING, TaskStatus.RUNNING, TaskStatus.ALLOCATED}
)


def is_allocated(status: TaskStatus) -> bool:
    return status in ALLOCATED_STATUSES


class PodPhase(str, enum.Enum):
    """The subset of pod phases the cache consumes (helpers.go:35-61)."""

    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


def pod_phase_to_status(phase: PodPhase, node_name, deleting: bool = False) -> TaskStatus:
    """An ingested pod's phase + nodeName + DeletionTimestamp as a TaskStatus
    (helpers.go:35-61 getTaskStatus): the deletion override applies only to
    Running and Pending pods."""
    if phase == PodPhase.RUNNING:
        return TaskStatus.RELEASING if deleting else TaskStatus.RUNNING
    if phase == PodPhase.PENDING:
        if deleting:
            return TaskStatus.RELEASING
        return TaskStatus.BOUND if node_name else TaskStatus.PENDING
    if phase == PodPhase.SUCCEEDED:
        return TaskStatus.SUCCEEDED
    if phase == PodPhase.FAILED:
        return TaskStatus.FAILED
    return TaskStatus.UNKNOWN


# conformance's critical-pod rule (conformance.go:42-59) — shared by the
# host plugin and the snapshot's task_critical bit
CRITICAL_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")
CRITICAL_NAMESPACE = "kube-system"


class PodGroupPhase(str, enum.Enum):
    """PodGroup lifecycle (apis/scheduling/v1alpha1/types.go:28-43)."""

    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"


def queue_phase_counts() -> dict:
    """A zeroed QueueStatus phase-count dict (types.go:195-204)."""
    return {p.value.lower(): 0 for p in PodGroupPhase}
