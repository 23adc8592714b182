"""The eviction solve — reclaim and preempt phase 1 as bidding rounds.

Mirrors ``kube_batch_tpu/ops/eviction.py`` (see its docstring for the
derivation).  The reference's reclaim (reclaim.go:107-199) and preempt
phase 1 (preempt.go:110-137, 180-260) are host loops over claimant tasks,
nodes and Running victims.  Here both are rounds on the device:

  round:  each eligible claimant bids for its best node among those that
          carry enough evictable victim resource for its queue
          (cross-queue victims for reclaim, same queue and another job for
          preempt); the lowest-ranked bidder wins each node;
  pick:   per claimed node, victims are taken in reverse task order (the
          reference's victimsQueue pops !TaskOrderFn, preempt.go:219-224)
          until the winner's InitResreq is covered — a segmented prefix;
  caps:   gang slack (a job never drops below MinAvailable, gang.go:71-94),
          the proportion queue budget (proportion.go:171-196) and, for
          preempt, DRF share dominance (drf.go:85-110); a claim whose
          victims a cap dropped below coverage cancels entirely.

The host action replays each claim through the plugins' real victim
verdicts (``actions/reclaim.py``, ``actions/preempt.py``).  The bid head
stays plain PyTorch, as the JAX package keeps it (``_best_node``, not K1):
its feasibility is per-(queue, node) victim capacity, not node budgets.
The ``while_loop`` is a Python loop with one host sync per round (the
"did any claim land?" test).  ``.at[].min`` / ``.at[].max`` scatters are
``scatter_reduce_`` with ``include_self=True``; ``segment_sum`` is
``index_add_``, exact while the sums are multiples of their quanta below
2^24, whatever order CUDA's atomics add in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.ops import fairness, ordering
from kube_batch_tpu_torch.ops.assignment import _best_node, _segment_sum, _scatter_perm
from kube_batch_tpu_torch.ops.feasibility import fits, static_predicates
from kube_batch_tpu_torch.ops.kernels import NEG, _tie_break_hash
from kube_batch_tpu_torch.ops.ordering import run_starts, segmented_prefix
from kube_batch_tpu_torch.ops.scoring import ScoreWeights, score_matrix

BIG = 1 << 30
SHARE_DELTA = 1e-6  # drf.go:23 shareDelta


class EvictConfig(NamedTuple):
    """Eviction-solve configuration.  The victim gates follow the tiered
    Evictable dispatch (session_plugins.go:100-182): only the plugins of
    the first tier with a voter constrain victims.  The claimant-side
    flags shape the rank, the overused gate and the commit gate as in the
    allocate solve."""

    mode: str = "reclaim"     # "reclaim" (cross-queue) | "preempt" (same queue)
    rounds: int = 8
    # reclaim only: skip claimants that fit free Idle, which allocate places
    # later this cycle (set only when allocate runs after reclaim)
    idle_gate: bool = False
    gang: bool = True
    drf: bool = True
    proportion: bool = True
    victim_gang: bool = True
    victim_conformance: bool = True
    victim_proportion: bool = False
    victim_drf: bool = False
    weights: ScoreWeights = ScoreWeights()


class EvictResult(NamedTuple):
    claim_node: torch.Tensor       # [T] i32 — node the claimant pipelines onto, -1
    evicted: torch.Tensor          # [T] bool — task chosen as victim
    victim_claimant: torch.Tensor  # [T] i32 — claimant a victim serves, -1


def victim_running(snap: DeviceSnapshot) -> torch.Tensor:
    """[T] bool — base victim eligibility: valid Running tasks on a node
    whose job is in the session."""
    return (snap.task_valid
            & (snap.task_status == int(TaskStatus.RUNNING))
            & (snap.task_node >= 0)
            & snap.job_valid[snap.task_job.long()])


def gang_slack0(snap: DeviceSnapshot, config: EvictConfig) -> torch.Tensor:
    """[J] i32 — evictions a job absorbs while staying at MinAvailable;
    MinAvailable ≤ 1 is no gang (always evictable).  BIG everywhere when
    the gang victim gate is off."""
    J = snap.job_min_avail.shape[0]
    if not config.victim_gang:
        return torch.full((J,), BIG, dtype=torch.int32, device=snap.job_min_avail.device)
    return torch.where(snap.job_min_avail > 1,
                       snap.job_ready - snap.job_min_avail, BIG).to(torch.int32)


def claim_winners(has, best, rank, n_nodes: int):
    """One winner per node, the lowest-rank bidder: (is_winner [C] bool,
    winner_idx [N] i32 — bidder index or -1, node_has_claim [N] bool)."""
    N = n_nodes
    dev = has.device
    idx = torch.arange(has.shape[0], dtype=torch.int32, device=dev)
    bid_node = torch.where(has, best, N).long()
    win_rank = torch.full((N + 1,), BIG, dtype=torch.int32, device=dev).scatter_reduce_(
        0, bid_node, torch.where(has, rank, BIG), "amin", include_self=True)[:N]
    is_winner = has & (rank == win_rank[best.long().clamp(0, N - 1)])
    winner_idx = torch.full((N,), -1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, torch.where(is_winner, best, 0).long(), torch.where(is_winner, idx, -1),
        "amax", include_self=True)
    return is_winner, winner_idx, winner_idx >= 0


def _capped(take, segment, n_segments, victim_rank, keep_fn):
    """``take`` re-decided per segment in victim-rank order: ``keep_fn``
    sees the sorted view (segment ids, start flags, order) and returns the
    rows to keep."""
    seg = torch.where(take, segment, n_segments)
    order = ordering.sort_by_segment_then_rank(seg, victim_rank, n_segments + 1)
    segs = seg[order].long()
    keep = take[order] & keep_fn(segs, run_starts(segs), order)
    return _scatter_perm(order, keep)


def pick_victims(snap: DeviceSnapshot, vmask, node_req, node_has_claim,
                 victim_rank, slack_rem, config: EvictConfig, n_nodes: int,
                 *, qbudget_rem=None, task_queue=None):
    """One round's victims on the claimed nodes: reverse task order until
    the winner's request is covered, then the gang-slack and (when
    ``qbudget_rem`` is given) the queue-budget caps, then the coverage
    recheck that cancels claims a cap broke.  Returns (final_take [T]
    bool, covered [N] bool)."""
    N = n_nodes
    J = snap.job_min_avail.shape[0]
    Q = snap.queue_weight.shape[0]
    vn = snap.task_node.long().clamp(0, N - 1)

    seg = torch.where(vmask, snap.task_node, N)
    order = ordering.sort_by_segment_then_rank(seg, victim_rank, N + 1)
    seg_s = seg[order].long()
    req_s = torch.where(vmask[order, None], snap.task_resreq[order], 0.0)
    prefix = segmented_prefix(req_s, run_starts(seg_s))          # exclusive
    need_s = node_req[seg_s.clamp(0, N - 1)]
    covered_before = (prefix >= need_s - snap.quanta).all(dim=-1)
    take = _scatter_perm(order, vmask[order] & (seg_s < N) & ~covered_before)

    if config.victim_gang:
        # position among the job's taken victims < its remaining slack
        def keep_slack(js, j_start, jorder):
            pos = segmented_prefix(take[jorder].float()[:, None], j_start)[:, 0]
            return pos.to(torch.int32) < slack_rem[js.clamp(0, J - 1)]
        take = _capped(take, snap.task_job, J, victim_rank, keep_slack)
    if qbudget_rem is not None:
        # cumulative eviction per victim queue within its remaining budget
        def keep_budget(qs, q_start, qorder):
            qreq_s = torch.where(take[qorder, None], snap.task_resreq[qorder], 0.0)
            qprefix = segmented_prefix(qreq_s, q_start)
            return (qprefix + qreq_s
                    <= qbudget_rem[qs.clamp(0, Q - 1)] + snap.quanta).all(dim=-1)
        take = _capped(take, task_queue, Q, victim_rank, keep_budget)

    got = _segment_sum(torch.where(take[:, None], snap.task_resreq, 0.0),
                       torch.where(take, snap.task_node, N), N + 1)[:N]
    covered = node_has_claim & (got >= node_req - snap.quanta).all(dim=-1)
    return take & covered[vn], covered


def local_evict_bids(snap: DeviceSnapshot, config: EvictConfig, static_ok):
    """The per-round bid head ``bids(victim_ok, claimant_ok) -> (best,
    has)``: per-(queue, node) evictable capacity, the claimant's fit
    against its queue's row, and the lexicographic argmax over the score
    matrix with the tie hash.  ``static_ok`` is the snapshot's static
    predicate matrix, shared with the idle gate."""
    T, R = snap.task_req.shape
    N = snap.node_alloc.shape[0]
    Q = snap.queue_weight.shape[0]
    preempt = config.mode == "preempt"
    task_queue = snap.job_queue[snap.task_job.long()].long()
    score = score_matrix(snap, config.weights)
    tie_hash = _tie_break_hash(T, N, device=score.device)
    # a queue index outside [0, Q) has no capacity row: infeasible
    q_ok = (task_queue >= 0) & (task_queue < Q)
    tq = task_queue.clamp(0, Q - 1)
    vnode = snap.task_node.long().clamp(0, N - 1)

    def bids(victim_ok, claimant_ok):
        vreq = torch.where(victim_ok[:, None], snap.task_resreq, 0.0)
        tot_v = _segment_sum(vreq, torch.where(victim_ok, snap.task_node, N), N + 1)[:N]
        per_qn = _segment_sum(vreq, tq * N + vnode, Q * N).view(Q, N, R)
        # same-queue victims for preempt (the own job is over-counted here
        # and dropped in the victim selection); cross-queue for reclaim
        cap = per_qn if preempt else tot_v[None] - per_qn
        # the JAX package gathers the claimant's queue row with an exact
        # one-hot product; a gather selects the same values
        capq = cap + snap.quanta
        feas = static_ok & (claimant_ok & q_ok)[:, None]
        for r in range(R):
            feas &= snap.task_req[:, r, None] <= capq[:, :, r][tq]
        return _best_node(torch.where(feas, score, NEG), tie_hash)

    return bids


def local_idle_fit_any(snap: DeviceSnapshot, static_ok) -> torch.Tensor:
    """[T] bool — the task fits some schedulable node's cycle-start Idle
    (``static_ok`` is the snapshot's static predicate matrix)."""
    return (fits(snap.task_req, snap.node_idle, snap.quanta) & static_ok).any(dim=1)


def evict_rounds(snap: DeviceSnapshot, config: EvictConfig, bids_fn,
                 fits_idle_any=None) -> EvictResult:
    """The rounds: eligibility, ranks, one winner per node, victim picking
    with its caps and coverage, and preempt's commit gate.  ``bids_fn``
    supplies the [T, N]-scale bids; ``fits_idle_any`` is the idle gate's
    probe (required when ``config.idle_gate`` is set for reclaim)."""
    T, R = snap.task_req.shape
    N = snap.node_alloc.shape[0]
    J = snap.job_min_avail.shape[0]
    Q = snap.queue_weight.shape[0]
    dev = snap.task_req.device
    i32 = torch.int32
    preempt = config.mode == "preempt"
    tj = snap.task_job.long()
    task_queue = snap.job_queue[tj]
    tql = task_queue.long()
    running = victim_running(snap)
    subrank = ordering.task_subranks(snap.task_prio, snap.task_creation)
    # victims pop in reverse task order (!TaskOrderFn, preempt.go:219-224)
    victim_rank = ordering.multisort_ranks([snap.task_prio, -snap.task_creation])

    deserved = fairness.proportion_deserved(
        snap.total, snap.queue_weight, snap.queue_request, snap.queue_valid)
    slack0 = gang_slack0(snap, config)
    # what a queue can lose while staying at its deserved share
    qbudget0 = (snap.queue_alloc - deserved).clamp(min=0.0)

    claimant_base = (snap.task_pending & snap.task_valid & snap.job_valid[tj]
                     & snap.job_schedulable[tj])
    if config.idle_gate and not preempt:
        # a claimant that fits free Idle is left to allocate (a declared
        # improvement over reclaim.go); claimants with host-only
        # constraints are exempt, their device fit being approximate
        claimant_base = claimant_base & ~(fits_idle_any & ~snap.task_needs_host)
    sem = fairness.semantic_cols(R)
    vn = snap.task_node.long().clamp(0, N - 1)

    claim_node = torch.full((T,), -1, dtype=i32, device=dev)
    evicted = torch.zeros(T, dtype=torch.bool, device=dev)
    victim_claimant = torch.full((T,), -1, dtype=i32, device=dev)
    i = 0
    progress = True
    while i < config.rounds and progress:
        placed = claim_node >= 0
        # ---- live fairness state -------------------------------------
        placed_req = torch.where(placed[:, None], snap.task_resreq, 0.0)
        evicted_req = torch.where(evicted[:, None], snap.task_resreq, 0.0)
        job_delta = _segment_sum(placed_req - evicted_req, tj, J)
        job_alloc_now = snap.job_allocated + job_delta
        queue_alloc_now = snap.queue_alloc + _segment_sum(job_delta, snap.job_queue, Q)
        slack_rem = slack0 - _segment_sum(evicted.to(i32), tj, J)
        qbudget_rem = qbudget0 - _segment_sum(evicted_req, task_queue, Q)
        pipe_cnt = _segment_sum(placed.to(i32), tj, J)
        job_pipelined_now = (snap.job_ready + pipe_cnt) >= snap.job_min_avail
        job_need = (snap.job_min_avail - (snap.job_ready + pipe_cnt)).clamp(min=0)

        # ---- victim eligibility --------------------------------------
        victim_ok = running & ~evicted
        if config.victim_conformance:
            victim_ok = victim_ok & ~snap.task_critical
        if config.victim_gang:
            victim_ok = victim_ok & (slack_rem[tj] > 0)
        if config.victim_proportion and not preempt:
            # the victim's Resreq within its queue's remaining budget over
            # the semantic dims (proportion.go:171-196)
            victim_ok = victim_ok & (
                snap.task_resreq <= qbudget_rem[tql] + snap.quanta)[:, sem].all(dim=-1)
        if preempt and config.victim_drf:
            victim_post_share = fairness.dominant_share(
                job_alloc_now[tj] - snap.task_resreq, snap.total)

        # ---- claimant eligibility and rank ---------------------------
        claimant_ok = claimant_base & ~placed
        if config.proportion and not preempt:
            # reclaim skips overused claimant queues (reclaim.go:112-116)
            q_overused = fairness.overused(deserved, queue_alloc_now, snap.quanta)
            claimant_ok = claimant_ok & ~q_overused[tql]
        rank = ordering.virtual_task_ranks(
            claimant_ok, snap.task_resreq, snap.task_job, task_queue, subrank,
            snap.job_prio, job_pipelined_now, snap.job_creation, job_alloc_now,
            queue_alloc_now, deserved, snap.total, job_need,
            gang_enabled=config.gang, drf_enabled=config.drf,
            proportion_enabled=config.proportion,
        )

        # ---- bids and one winner per node ----------------------------
        best, has = bids_fn(victim_ok, claimant_ok)
        has = has & claimant_ok
        is_winner, winner_task, node_has_claim = claim_winners(has, best, rank, N)
        wt = winner_task.long().clamp(min=0)
        node_req = torch.where(node_has_claim[:, None], snap.task_req[wt],
                               float("inf"))
        winner_job = torch.where(node_has_claim, snap.task_job[wt], -1)
        winner_queue = torch.where(node_has_claim, task_queue[wt], -1)

        # ---- victims -------------------------------------------------
        vmask = victim_ok & node_has_claim[vn]
        if preempt:
            # same queue, another job (preempt.go:113-121)
            vmask = vmask & (task_queue == winner_queue[vn]) & (snap.task_job != winner_job[vn])
            if config.victim_drf:
                # the preemptor's share after allocation stays at or below
                # the victim's after eviction (drf.go:85-110)
                winner_post_share = fairness.dominant_share(
                    job_alloc_now[winner_job.long().clamp(min=0)] + snap.task_resreq[wt],
                    snap.total)
                vmask = vmask & (winner_post_share[vn] <= victim_post_share + SHARE_DELTA)
        else:
            vmask = vmask & (task_queue != winner_queue[vn])      # cross-queue
        proportion_cap = config.victim_proportion and not preempt
        final_take, covered = pick_victims(
            snap, vmask, node_req, node_has_claim, victim_rank, slack_rem,
            config, N,
            qbudget_rem=qbudget_rem if proportion_cap else None,
            task_queue=task_queue if proportion_cap else None,
        )

        # ---- apply ---------------------------------------------------
        new_claim = is_winner & covered[best.long().clamp(0, N - 1)]
        claim_node = torch.where(new_claim, best, claim_node)
        evicted = evicted | final_take
        victim_claimant = torch.where(final_take, winner_task[vn], victim_claimant)
        i += 1
        progress = bool(new_claim.any())  # host sync, once per round

    if preempt and config.gang:
        # commit gate: the preemptor job must reach Pipelined
        # (preempt.go:127-137); failing jobs' claims revert and their
        # victims stay (Statement.Discard)
        pipe_cnt = _segment_sum((claim_node >= 0).to(i32), tj, J)
        job_ok = (snap.job_ready + pipe_cnt) >= snap.job_min_avail
        revert = (claim_node >= 0) & ~job_ok[tj]
        claim_node = torch.where(revert, -1, claim_node)
        victim_revert = (victim_claimant >= 0) & revert[victim_claimant.long().clamp(0, T - 1)]
        evicted = evicted & ~victim_revert
        victim_claimant = torch.where(victim_revert, -1, victim_claimant)

    return EvictResult(claim_node=claim_node, evicted=evicted,
                       victim_claimant=victim_claimant), i


def evict_solve(snap: DeviceSnapshot, config: EvictConfig):
    """``(EvictResult, rounds run)`` of the reclaim or preempt solve, on the
    device the snapshot's tensors lie on."""
    static_ok = static_predicates(snap)
    fia = None
    if config.idle_gate and config.mode != "preempt":
        fia = local_idle_fit_any(snap, static_ok)
    return evict_rounds(snap, config, local_evict_bids(snap, config, static_ok), fia)
