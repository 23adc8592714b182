"""Feasibility masks — the PredicateFn tier as one [T, N] boolean program.

Mirrors ``kube_batch_tpu/ops/feasibility.py``: epsilon-tolerant resource
fit (resource_info.go:269-284 LessEqual), node health, node-selector label
bits, taint/toleration bits, and the sparse inter-pod-affinity rows.
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot


def fits(req: torch.Tensor, budget: torch.Tensor,
         quanta: torch.Tensor) -> torch.Tensor:
    """req [T, R] vs budget [N, R] → [T, N] bool: every dimension passes
    ``req ≤ budget + quanta``.  Unrolled over the (small) resource axis so
    no [T, N, R] tensor is ever materialized."""
    bq = budget + quanta  # [N, R], the same f32 sum the JAX package forms
    ok = req[:, 0, None] <= bq[None, :, 0]
    # kbt: allow[KBT005] one compare per resource dimension (the small static R, the
    # JAX package's vmapped compare): no [T, N, R] tensor is materialized
    for r in range(1, req.shape[1]):
        ok &= req[:, r, None] <= bq[None, :, r]
    return ok


def static_predicates(snap: DeviceSnapshot) -> torch.Tensor:
    """[T, N] non-resource predicate conjunction."""
    node_ok = snap.node_valid & snap.node_sched  # [N]
    T = snap.task_sel_bits.shape[0]
    N = snap.node_label_bits.shape[0]

    # selector: every required label bit present; taints: every hard taint
    # tolerated.  Word by word, so no [T, N, W] tensor is materialized.
    ok = node_ok[None, :].expand(T, N).clone()
    # kbt: allow[KBT005] one pass per 32-bit label word (a static few): no [T, N, W]
    # tensor is materialized
    for w in range(snap.task_sel_bits.shape[1]):
        sel = snap.task_sel_bits[:, w, None]
        ok &= (sel & snap.node_label_bits[None, :, w]) == sel
    ok &= ~snap.task_sel_impossible[:, None]
    # kbt: allow[KBT005] one pass per 32-bit taint word (a static few): no [T, N, W]
    # tensor is materialized
    for w in range(snap.task_tol_bits.shape[1]):
        ok &= (snap.node_taint_bits[None, :, w]
               & ~snap.task_tol_bits[:, w, None]) == 0

    # sparse inter-pod-affinity rows: padding rows (-1) clip onto row 0 with
    # an all-True update; a min-reduce (not an indexed assignment, whose
    # order among duplicate indices is undefined) keeps row 0's own update
    idx = snap.task_aff_idx.long()
    upd = torch.where((idx >= 0)[:, None], snap.task_aff_mask, True)
    rows = idx.clamp(0, T - 1)[:, None].expand(-1, N)
    okb = ok.to(torch.uint8).scatter_reduce_(0, rows, upd.to(torch.uint8), "amin")
    return okb.bool()


# Reason codes for fit-error diagnostics (unschedule_info.go:11-19); the host
# renders them into FitErrors strings for unplaced tasks only.
REASON_NODE_UNHEALTHY = 0
REASON_SELECTOR = 1
REASON_TAINT = 2
REASON_RESOURCE = 3
N_REASONS = 4

#: the message of each reason class, in code order
REASON_MESSAGES = (
    "node(s) were not ready or unschedulable",
    "node(s) didn't match node selector",
    "node(s) had taints that the pod didn't tolerate",
    "Insufficient resources",
)


def _selector_taint_ok(snap: DeviceSnapshot):
    """([T, N] selector ok, [T, N] taints ok), word by word."""
    T = snap.task_sel_bits.shape[0]
    N = snap.node_label_bits.shape[0]
    sel_ok = torch.ones((T, N), dtype=torch.bool, device=snap.node_valid.device)
    # kbt: allow[KBT005] one pass per 32-bit label word (a static few): no [T, N, W]
    # tensor is materialized
    for w in range(snap.task_sel_bits.shape[1]):
        sel = snap.task_sel_bits[:, w, None]
        sel_ok &= (sel & snap.node_label_bits[None, :, w]) == sel
    sel_ok &= ~snap.task_sel_impossible[:, None]
    taints_ok = torch.ones_like(sel_ok)
    # kbt: allow[KBT005] one pass per 32-bit taint word (a static few): no [T, N, W]
    # tensor is materialized
    for w in range(snap.task_tol_bits.shape[1]):
        taints_ok &= (snap.node_taint_bits[None, :, w]
                      & ~snap.task_tol_bits[:, w, None]) == 0
    return sel_ok, taints_ok


def failure_histogram(snap: DeviceSnapshot, static_ok: torch.Tensor,
                      fit: torch.Tensor) -> torch.Tensor:
    """[T, N_REASONS] i32: per task, how many valid nodes failed each
    predicate class — the device analog of FitErrors' reason histogram.
    ``static_ok`` is :func:`static_predicates`, ``fit`` the fit in Idle or
    Releasing."""
    node_ok = snap.node_valid & snap.node_sched
    nodes = snap.node_valid[None, :]
    sel_ok, taints_ok = _selector_taint_ok(snap)
    T = snap.task_req.shape[0]
    unhealthy = (snap.node_valid & ~node_ok).sum().expand(T)  # task-independent
    healthy = nodes & node_ok[None, :]
    return torch.stack([
        unhealthy,
        (healthy & ~sel_ok).sum(dim=1),
        (healthy & sel_ok & ~taints_ok).sum(dim=1),
        (nodes & static_ok & ~fit).sum(dim=1),
    ], dim=1).to(torch.int32)
