"""Node scoring — the NodeOrderFn tier as additive [T, N] score rows.

Mirrors ``kube_batch_tpu/ops/scoring.py``: least-requested,
balanced-resource, binpack, the sparse preferred-affinity rows and the
custom rows registered through ``Session.add_score_row``, summed under
``ScoreWeights`` (session_plugins.go:392-412).  The two semantic
columns (cpu, memory) are unrolled, so the largest intermediate is [T, N];
the arithmetic is the JAX package's, operation for operation, so the f32
scores are equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot

MAX_PRIORITY = 10.0


class ScoreWeights(NamedTuple):
    """Per-row weights (nodeorder.go:34-43 plus binpack).

    ``extra_rows`` is the score-row extension seam (the reference's
    NodeOrderFn / BatchNodeOrderFn registration, session_plugins.go:392-492):
    a tuple of ``(name, fn, weight)``, where ``fn(snap) -> [T, N]`` float32
    on the snapshot's device is summed like the built-in rows.  ``snap`` may
    be the compacted solve's row-gathered view, so a row reads its task
    count from ``snap.task_req``.  Register through
    ``Session.add_score_row``, with a module-level function: the row set is
    part of the solve's configuration, and a custom row turns the warm
    carry and the replay's columnar host placement off."""

    least_requested: float = 1.0
    balanced_resource: float = 1.0
    node_affinity: float = 1.0
    pod_affinity: float = 1.0
    binpack: float = 0.0
    extra_rows: tuple = ()


def _fractions(snap: DeviceSnapshot, r: int, fill: float, free: bool):
    """[T, N] f32 fraction on semantic column ``r``: (alloc − used − req) /
    alloc when ``free``, else (used + req) / alloc; ``fill`` where the node
    has none of the resource."""
    alloc = snap.node_alloc[None, :, r]
    if free:
        num = alloc - snap.node_used[None, :, r] - snap.task_req[:, r, None]
    else:
        num = snap.node_used[None, :, r] + snap.task_req[:, r, None]
    return torch.where(alloc > 0, num / alloc, fill)


def least_requested(snap: DeviceSnapshot) -> torch.Tensor:
    """LeastRequestedPriority (nodeorder.go:188-205): mean over {cpu, mem}
    of (allocatable − used − req) / allocatable, × 10."""
    f0 = _fractions(snap, 0, 0.0, True).clamp(0.0, 1.0)
    f1 = _fractions(snap, 1, 0.0, True).clamp(0.0, 1.0)
    return (f0 + f1) / 2 * MAX_PRIORITY


def balanced_resource(snap: DeviceSnapshot) -> torch.Tensor:
    """BalancedResourceAllocation (nodeorder.go:207-227): 10 − |cpuFraction
    − memFraction| · 10."""
    f0 = _fractions(snap, 0, 1.0, False).clamp(0.0, 1.0)
    f1 = _fractions(snap, 1, 1.0, False).clamp(0.0, 1.0)
    return (1.0 - (f0 - f1).abs()) * MAX_PRIORITY


def binpack(snap: DeviceSnapshot) -> torch.Tensor:
    """Binpack: mean over {cpu, mem} of (used + req) / allocatable, × 10."""
    f0 = _fractions(snap, 0, 0.0, False).clamp(0.0, 1.0)
    f1 = _fractions(snap, 1, 0.0, False).clamp(0.0, 1.0)
    return (f0 + f1) / 2 * MAX_PRIORITY


def _scatter_pref(snap: DeviceSnapshot, rows: torch.Tensor) -> torch.Tensor:
    """[T, N] from the sparse [Kp, N] preference rows: padding (-1) clips
    onto row 0 with a zero update."""
    T = snap.task_req.shape[0]
    N = snap.node_alloc.shape[0]
    idx = snap.task_pref_idx.long()
    upd = torch.where((idx >= 0)[:, None], rows, 0.0)
    out = torch.zeros((T, N), dtype=torch.float32, device=rows.device)
    return out.index_add_(0, idx.clamp(0, T - 1), upd)


def node_affinity_preferred(snap: DeviceSnapshot) -> torch.Tensor:
    return _scatter_pref(snap, snap.task_pref_node)


def pod_affinity_preferred(snap: DeviceSnapshot) -> torch.Tensor:
    return _scatter_pref(snap, snap.task_pref_pod)


def score_matrix(snap: DeviceSnapshot, w: ScoreWeights) -> torch.Tensor:
    """Σ_k weight_k · row_k — Session.NodeOrderFn (session_plugins.go:392-412)."""
    s = torch.zeros((snap.task_req.shape[0], snap.node_alloc.shape[0]),
                    dtype=torch.float32, device=snap.task_req.device)
    if w.least_requested:
        s = s + w.least_requested * least_requested(snap)
    if w.balanced_resource:
        s = s + w.balanced_resource * balanced_resource(snap)
    if w.binpack:
        s = s + w.binpack * binpack(snap)
    if w.node_affinity:
        s = s + w.node_affinity * node_affinity_preferred(snap)
    if w.pod_affinity:
        s = s + w.pod_affinity * pod_affinity_preferred(snap)
    # kbt: allow[KBT005] one row per configured extra plugin, a static tuple
    # (the JAX package's trace-time unroll)
    for _name, fn, weight in w.extra_rows:
        if weight:
            s = s + weight * fn(snap)
    return s
