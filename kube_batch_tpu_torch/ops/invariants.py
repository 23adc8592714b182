"""Cycle invariant sentinel — the result-integrity check that follows every
device solve (the guard plane's first tier).

Mirrors ``kube_batch_tpu/ops/invariants.py``.  Each solve gains a tail of
tensor ops that re-derives the lawfulness of its own result from the
snapshot it consumed:

- per-node committed allocation fits the cycle-start budget and the node's
  capacity (the capacity cross-check catches a corrupted resident ledger:
  the solve's own fit math trusts the corrupt budget, but idle + used ≤
  allocatable is redundant state the corruption breaks);
- no task is placed that was not an eligible pending row;
- every placement was statically feasible at its node (a row-wise gather,
  never a [T, N] recompute);
- committed gangs meet MinAvailable;
- victims are valid Running residents within gang slack that cover their
  claimant (eviction solves);
- every f32 input and result ledger is finite.

The tail returns one verdict (i32, 0 = lawful), a violation histogram
(i32, one slot per ``INVARIANT_NAMES`` entry) and an eligibility
checksum, all on the device; the action packs them into the readback it
already makes, so the guard adds no transfer.  On a nonzero verdict the action fails closed
(``kube_batch_tpu_torch/guard``).  Torch runs the solve and its tail as
one sequence of launches on the solve's stream, where the JAX package
fuses them into one program.
"""

from __future__ import annotations

import numpy as np
import torch

from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.ops.admission import enqueue_gate
from kube_batch_tpu_torch.ops.assignment import (
    AllocateConfig,
    AllocateResult,
    _segment_sum,
    _warm_allocate_solve,
    allocate_solve,
    allocate_topk_solve,
)
from kube_batch_tpu_torch.ops.eviction import (
    EvictConfig,
    EvictResult,
    evict_solve,
    gang_slack0,
    victim_running,
)

#: violation classes, one histogram slot each, shared by every sentinel
INVARIANT_NAMES = (
    "assign_ineligible",   # placement/claim on a non-eligible-pending row
    "assign_infeasible",   # static predicates fail at the assigned node,
    #                        or an index out of range
    "node_overcommit",     # committed allocation exceeds budget/capacity,
    #                        or the cycle-start ledgers are inconsistent
    "gang_violation",      # committed gang below min_available / slack
    "victim_ineligible",   # evicted row is not a valid RUNNING resident
    "claim_uncovered",     # a claim's victims do not cover the claimant
    "nonfinite",           # non-finite ledger/score/budget value
    "admit_ineligible",    # enqueue-gate admission of a non-candidate
)

I32 = torch.int32


def _i32sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=I32)


def _nonfinite_count(*arrays) -> torch.Tensor:
    total = torch.zeros((), dtype=I32, device=arrays[0].device)
    # kbt: allow[KBT005] one reduction per field over a fixed small tuple of
    # snapshot fields (the JAX package's trace-time unroll)
    for a in arrays:
        total = total + _i32sum(~torch.isfinite(a))
    return total


def _snapshot_nonfinite(snap: DeviceSnapshot) -> torch.Tensor:
    """All-finite sweep over every f32 input the solves consume."""
    return _nonfinite_count(
        snap.task_req, snap.task_resreq,
        snap.node_idle, snap.node_releasing, snap.node_used, snap.node_alloc,
        snap.job_allocated,
        snap.queue_weight, snap.queue_capability, snap.queue_alloc,
        snap.queue_request,
        snap.total, snap.quanta,
    )


def _eligible_pending(snap: DeviceSnapshot) -> torch.Tensor:
    """[T] bool — exactly the solves' claimant/bidder eligibility."""
    tj = snap.task_job.long()
    return (snap.task_pending & snap.task_valid & snap.job_valid[tj]
            & snap.job_schedulable[tj])


#: the victim-checksum multiplier as a wrapped int32
_CK = 0x9E3779B1 - (1 << 32)


def eligibility_checksum(snap: DeviceSnapshot) -> torch.Tensor:
    """[] i32 checksum of the device's bidder eligibility and victim pool:
    the device-against-host divergence probe.  A flipped resident status,
    pending or node word changes which rows are eligible, which the
    device-side invariants cannot see (they re-derive from the same
    corrupted columns); the host recomputes it from its own columns
    (:func:`host_eligibility_checksum`).  int32 sums and products wrap."""
    T = snap.task_req.shape[0]
    idx = torch.arange(T, dtype=I32, device=snap.task_req.device) + 1
    elig = _i32sum(torch.where(_eligible_pending(snap), idx, 0))
    run = _i32sum(torch.where(victim_running(snap), idx * _CK, 0))
    return elig ^ run


def host_eligibility_checksum(snap) -> int:
    """The host twin of :func:`eligibility_checksum` over the host-backed
    (numpy) snapshot, in wrapped mod-2^32 arithmetic, as an unsigned int."""
    tj, valid, pending, status, node, jvalid, jsched = [
        # kbt: allow[KBT005] the host twin reads the HOST-backed (numpy) snapshot
        # the checksum is compared against; no tensor is read
        np.asarray(a) for a in (
            snap.task_job, snap.task_valid, snap.task_pending,
            snap.task_status, snap.task_node, snap.job_valid,
            snap.job_schedulable,
        )
    ]
    elig_mask = pending & valid & jvalid[tj] & jsched[tj]
    run_mask = (valid & (status == int(TaskStatus.RUNNING)) & (node >= 0)
                & jvalid[tj])
    idx = np.arange(elig_mask.shape[0], dtype=np.int64) + 1
    elig = int(np.sum(np.where(elig_mask, idx, 0), dtype=np.int64)) & 0xFFFFFFFF
    ck = _CK & 0xFFFFFFFF
    run = int(np.sum(np.where(run_mask, (idx * ck) & 0xFFFFFFFF, 0),
                     dtype=np.int64)) & 0xFFFFFFFF
    return (elig ^ run) & 0xFFFFFFFF


def _static_feasible_at(snap: DeviceSnapshot, node_idx: torch.Tensor,
                        active: torch.Tensor) -> torch.Tensor:
    """[T] bool — the static predicates re-checked row-wise at
    ``node_idx`` (node health, selector bits, taint toleration, the sparse
    affinity rows); inactive rows pass."""
    T = snap.task_req.shape[0]
    N = snap.node_label_bits.shape[0]
    safe = node_idx.long().clamp(0, N - 1)
    labels = snap.node_label_bits[safe]                       # [T, W]
    taints = snap.node_taint_bits[safe]
    sel_ok = ((snap.task_sel_bits & labels) == snap.task_sel_bits).all(dim=-1) \
        & ~snap.task_sel_impossible
    tol_ok = ((taints & ~snap.task_tol_bits) == 0).all(dim=-1)
    node_ok = snap.node_valid[safe] & snap.node_sched[safe]
    ok = node_ok & sel_ok & tol_ok
    # sparse affinity rows: the mask at the row's chosen node must hold;
    # padding rows (-1) and inactive rows contribute True
    rows = snap.task_aff_idx.long().clamp(0, T - 1)
    chosen = node_idx[rows].long().clamp(0, N - 1)
    aff_at = snap.task_aff_mask.gather(1, chosen[:, None])[:, 0]
    upd = torch.where((snap.task_aff_idx >= 0) & active[rows], aff_at, True)
    ok = ok.to(torch.uint8).scatter_reduce_(0, rows, upd.to(torch.uint8), "amin")
    return ok.bool() | ~active


def allocate_invariants(snap: DeviceSnapshot, res: AllocateResult,
                        config: AllocateConfig):
    """(verdict [] i32, hist i32 per ``INVARIANT_NAMES`` entry) for one
    allocate-shaped result; verdict 0 ⇔ every invariant holds."""
    N = snap.node_idle.shape[0]
    J = snap.job_min_avail.shape[0]
    tj = snap.task_job.long()
    assigned, pipelined = res.assigned, res.pipelined
    placed = assigned >= 0

    # (1) only eligible pending rows may place
    n_inel = _i32sum(placed & ~_eligible_pending(snap))

    # (2) bounds + static feasibility at the assigned node
    in_range = (assigned >= -1) & (assigned < N)
    feas = _static_feasible_at(snap, assigned, placed)
    n_infeas = _i32sum(~in_range) + _i32sum(placed & ~feas)

    # (3) per-node budget and capacity; pipelined occupancy (a task
    # borrowing a dying victim's share) may lawfully take used past
    # allocatable by exactly the pipelined resreq on the node
    seg = torch.where(placed, assigned.clamp(0, N - 1), N)
    alloc_delta = _segment_sum(
        torch.where((placed & ~pipelined)[:, None], snap.task_resreq, 0.0),
        seg, N + 1)[:N]
    pipe_delta = _segment_sum(
        torch.where((placed & pipelined)[:, None], snap.task_resreq, 0.0),
        seg, N + 1)[:N]
    pipe_here = (snap.task_valid
                 & (snap.task_status == int(TaskStatus.PIPELINED))
                 & (snap.task_node >= 0))
    pipe_resident = _segment_sum(
        torch.where(pipe_here[:, None], snap.task_resreq, 0.0),
        torch.where(pipe_here, snap.task_node, N), N + 1)[:N]
    q = snap.quanta
    cap = snap.node_alloc + pipe_resident
    nv = snap.node_valid
    over = (
        (alloc_delta > snap.node_idle + q).any(dim=-1)
        | (pipe_delta > snap.node_releasing + q).any(dim=-1)
        | (nv & (res.node_used > cap + pipe_delta + q).any(dim=-1))
        | (nv & (snap.node_idle + snap.node_used > cap + q).any(dim=-1))
        | (nv & (snap.node_idle < -q).any(dim=-1))
    )
    n_over = _i32sum(over)

    # (4) committed gangs meet min_available
    if config.gang:
        new_alloc = _segment_sum((placed & ~pipelined).to(I32), tj, J)
        new_any = _segment_sum(placed.to(I32), tj, J)
        n_gang = _i32sum((new_any > 0)
                         & ((snap.job_ready + new_alloc) < snap.job_min_avail))
    else:
        n_gang = torch.zeros((), dtype=I32, device=assigned.device)

    # (5) all-finite sweep: result ledgers + every f32 snapshot input
    n_fin = _snapshot_nonfinite(snap) + _nonfinite_count(
        res.node_idle, res.node_releasing, res.node_used, res.deserved)

    zero = torch.zeros((), dtype=I32, device=assigned.device)
    hist = torch.stack([n_inel, n_infeas, n_over, n_gang, zero, zero, n_fin,
                        zero]).to(I32)
    return hist.sum(dtype=I32), hist


def evict_invariants(snap: DeviceSnapshot, res: EvictResult,
                     config: EvictConfig):
    """(verdict, hist) for one eviction-shaped result (reclaim or
    preempt)."""
    T = snap.task_req.shape[0]
    N = snap.node_alloc.shape[0]
    J = snap.job_min_avail.shape[0]
    claim_node, evicted, victim_claimant = (
        res.claim_node, res.evicted, res.victim_claimant)
    claimed = claim_node >= 0

    # claimants: eligible pending rows, statically feasible at the claimed
    # node, in range
    n_inel = _i32sum(claimed & ~_eligible_pending(snap))
    in_range = ((claim_node >= -1) & (claim_node < N)
                & (victim_claimant >= -1) & (victim_claimant < T))
    feas = _static_feasible_at(snap, claim_node, claimed)
    n_infeas = _i32sum(~in_range) + _i32sum(claimed & ~feas)

    # victims: valid Running residents, victim ↔ claimant consistent
    running = victim_running(snap)
    n_victim = (_i32sum(evicted & ~running)
                + _i32sum(evicted != (victim_claimant >= 0)))

    # gang slack: only jobs that lost victims are judged
    if config.victim_gang:
        evict_cnt = _segment_sum(evicted.to(I32), snap.task_job, J)
        n_gang = _i32sum((evict_cnt > 0) & (evict_cnt > gang_slack0(snap, config)))
    else:
        n_gang = torch.zeros((), dtype=I32, device=claim_node.device)

    # coverage: every claim's victims cover the claimant's request
    vseg = torch.where(evicted & (victim_claimant >= 0),
                       victim_claimant.clamp(0, T - 1), T)
    cover = _segment_sum(torch.where(evicted[:, None], snap.task_resreq, 0.0),
                         vseg, T + 1)[:T]
    n_cover = _i32sum(claimed & (snap.task_req > cover + snap.quanta).any(dim=-1))

    n_fin = _snapshot_nonfinite(snap)
    zero = torch.zeros((), dtype=I32, device=claim_node.device)
    hist = torch.stack([n_inel, n_infeas, zero, n_gang, n_victim, n_cover,
                        n_fin, zero]).to(I32)
    return hist.sum(dtype=I32), hist


def enqueue_gate_invariants(admitted, cand, min_res, idle0, quanta):
    """(verdict, hist) for the enqueue admission scan: an admitted row must
    have been a candidate, and the budget inputs must be finite."""
    n_admit = _i32sum(admitted & ~cand)
    n_fin = _nonfinite_count(min_res, idle0, quanta)
    zero = torch.zeros((), dtype=I32, device=admitted.device)
    hist = torch.stack([zero, zero, zero, zero, zero, zero, n_fin,
                        n_admit]).to(I32)
    return hist.sum(dtype=I32), hist


# --------------------------------------------------------------------------
# the sentinel solves: each solve followed by its invariant tail, on the
# solve's device; the dispatch sites read the tail back with the result
# --------------------------------------------------------------------------


def allocate_sentinel_solve(snap: DeviceSnapshot, config: AllocateConfig):
    """allocate_solve + tail → (result, verdict, hist, checksum)."""
    res = allocate_solve(snap, config)
    verdict, hist = allocate_invariants(snap, res, config)
    return res, verdict, hist, eligibility_checksum(snap)


def allocate_topk_sentinel_solve(snap: DeviceSnapshot, pend_rows,
                                 config: AllocateConfig):
    """The compacted solve + tail; the invariants read the scattered-back
    [T] result, so a bucket mis-scatter is in scope."""
    res = allocate_topk_solve(snap, pend_rows, config)
    verdict, hist = allocate_invariants(snap, res, config)
    return res, verdict, hist, eligibility_checksum(snap)


def warm_allocate_sentinel_solve(snap, pend_rows, table, plan,
                                 config: AllocateConfig, k_min: int):
    """The warm solve + tail → (result, verdict, hist, checksum, table',
    eroded): a carry fault that merges a stale key into a wrong placement
    is in scope like a compaction mis-scatter."""
    t_idx, t_skey, t_hash, t_trunc = table
    row_map, changed, rr, rslots = plan
    res, table2, eroded = _warm_allocate_solve(
        snap, pend_rows, t_idx, t_skey, t_hash, t_trunc, row_map, changed,
        rr, rslots, config, k_min)
    verdict, hist = allocate_invariants(snap, res, config)
    return res, verdict, hist, eligibility_checksum(snap), table2, eroded


def evict_sentinel_solve(snap: DeviceSnapshot, config: EvictConfig):
    """evict_solve (reclaim or preempt) + tail → (result, rounds, verdict,
    hist, checksum)."""
    res, rounds = evict_solve(snap, config)
    verdict, hist = evict_invariants(snap, res, config)
    return res, rounds, verdict, hist, eligibility_checksum(snap)


def enqueue_gate_sentinel_solve(min_res, cand, idle0, quanta, n_rows=None):
    """The admission gate (its CUDA kernel for CUDA tensors) + the tail on
    its output → (admitted, verdict, hist)."""
    admitted = enqueue_gate(min_res, cand, idle0, quanta, n_rows)
    verdict, hist = enqueue_gate_invariants(admitted, cand, min_res, idle0, quanta)
    return admitted, verdict, hist
