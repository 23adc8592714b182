"""The what-if probe — the query plane's solve.

Mirrors ``kube_batch_tpu/ops/probe.py`` (see its docstring for the
semantics).  The scheduler's write path answers "where does this gang
go?" by committing a Statement; the query plane (``serve/``) answers
"where WOULD it go, and what would it evict?" without committing
anything.  Each speculative gang is solved alone against the resident
snapshot with the same machinery the committed cycle runs:
:func:`ops.assignment.allocate_rounds` for placement, with the round head
:func:`ops.assignment.round_head_parts` (kernel K1 on a CUDA tensor), and
the :mod:`ops.eviction` victim machinery for the hypothetical preemption
set, restricted to a task axis of the gang's members.

The oracle contract: on a frozen cache, a gang reported feasible at nodes
X binds to exactly X when it is submitted.  It holds by construction:

- the gang view's per-element inputs (requests, selector and toleration
  bits, the appended job row, the proportion ``queue_request`` bump) are
  what the committed snapshot would carry at the gang's rows;
- the tie hash is taken at the global task rows the gang would occupy
  (``ColumnStore.peek_task_rows``): K1 takes those rows as its ``rows``
  argument, and the eviction bids hash them with
  :func:`ops.kernels.tie_break_hash_rows`;
- the rounds are the same code, ``allocate_rounds`` with a [G, N] head.

Where the JAX package vmaps one program over the batch, this module loops
over the batch's gangs: a ctypes kernel cannot be vmapped, and sharing one
``allocate_rounds`` is what makes the contract structural.  Each gang's
rounds read back once a round (the "anything placed?" test), as the
committed solve's do, and the eviction probe's ``while_loop`` is a Python
loop that reads ``progress`` back once a round, as ``evict_rounds`` does.
The eviction bids are the plain ``_best_node`` over the [G, N] masked
bids, as in the JAX package (no kernel there either).  What is the same
for every gang of a batch (the capability budget, the victims' base
eligibility and reverse task order, the gang slack) is computed once per
batch; the values are those the JAX package computes per gang.

Modeled scope, as the JAX package's: the allocate and preempt solves plus
the enqueue action's admission gate (the capability test and the queue's
``JobEnqueueable`` veto).  Best-effort members are never solver-pending,
so an all-best-effort gang reports ``feasible: false`` with an empty
histogram; the backfill path is the one gap (the plane says so per
response).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.ops import fairness, ordering
from kube_batch_tpu_torch.ops.assignment import (
    NEG,
    AllocateConfig,
    _best_node,
    _segment_sum,
    allocate_rounds,
    round_head_parts,
    tie_break_hash_rows,
)
from kube_batch_tpu_torch.ops.eviction import (
    EvictConfig,
    claim_winners,
    gang_slack0,
    pick_victims,
    victim_running,
)
from kube_batch_tpu_torch.ops.feasibility import failure_histogram, fits
from kube_batch_tpu_torch.utils.seams import round_end

#: the enqueue action's 20% overcommit (enqueue.go:74-81); the admission
#: verdict mirrors it
OVERCOMMIT_FACTOR = 1.2


class ProbeBatch(NamedTuple):
    """B speculative gangs, each padded to G members.  Every member of a
    gang shares the gang's selector and toleration bits and priority;
    requests may vary per member."""

    req: torch.Tensor             # [B, G, R] f32 — member requests
    valid: torch.Tensor           # [B, G] bool — live members
    min_avail: torch.Tensor       # [B] i32 — gang MinAvailable
    queue: torch.Tensor           # [B] i32 — queue row; -1 = unknown queue
    prio: torch.Tensor            # [B] i32
    sel_bits: torch.Tensor        # [B, W] i32 view of u32 required label bits
    sel_impossible: torch.Tensor  # [B] bool — selector wants a pair no node has
    tol_bits: torch.Tensor        # [B, Wt] i32 view of u32 tolerated taint bits
    min_res: torch.Tensor         # [B, R] f32 — PodGroup MinResources
    has_min_res: torch.Tensor     # [B] bool — absent: unconditional promotion


class ProbeResult(NamedTuple):
    assigned: torch.Tensor       # [B, G] i32 — node index, -1 unplaced
    pipelined: torch.Tensor      # [B, G] bool — placed on Releasing budget
    committed: torch.Tensor      # [B] bool — the gang commit gate's verdict
    feasible: torch.Tensor       # [B] bool — every pending member placed
    reasons: torch.Tensor        # [B, G, N_REASONS] i32 — fit-error histogram
    enqueue_ok: torch.Tensor     # [B] bool — capability gate and queue veto
    claim_node: torch.Tensor     # [B, G] i32 — eviction claim node, -1
    victims: torch.Tensor        # [B, T] bool — hypothetical eviction set
    evict_covered: torch.Tensor  # [B] bool — the claims passed the commit gate


_PROBE_BITSETS = ("sel_bits", "tol_bits")


def probe_batch_from_numpy(batch, device) -> ProbeBatch:
    """A :class:`ProbeBatch` of tensors on ``device`` from numpy arrays (a
    NamedTuple or mapping with the same fields): u32 bitsets as int32
    views, every other dtype kept."""
    src = batch._asdict() if hasattr(batch, "_asdict") else batch
    out = {}
    # kbt: allow[KBT005] one upload per ProbeBatch field: encoding the host request
    # is the batch's input transfer, not a readback
    for name in ProbeBatch._fields:
        # kbt: allow[KBT005] the request batch arrives as host numpy arrays;
        # this reads no tensor
        arr = np.asarray(src[name])
        if name in _PROBE_BITSETS:
            arr = arr.view(np.int32)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return ProbeBatch(**out)


def _gang_view(snap: DeviceSnapshot, req, valid, min_avail, queue, prio,
               sel_bits, sel_impossible, tol_bits) -> DeviceSnapshot:
    """``snap`` with the task axis replaced by the gang's G member rows and
    the speculative job appended as job row J (a fresh row, so no live row
    is changed).  ``queue_request`` gets the gang's request added at its
    queue row, as proportion's session open would after a real submission.
    The per-gang scalars are 0-d tensors."""
    G, R = req.shape
    N = snap.node_alloc.shape[0]
    Q = snap.queue_weight.shape[0]
    dev = req.device
    i32 = torch.int32

    # best effort = every semantic request below its quantum; such members
    # are never solver-pending
    sem = fairness.semantic_mask(R, dev)
    best_effort = ((req < snap.quanta) | ~sem).all(dim=1)
    pending = valid & ~best_effort
    # member creation order = submission order: only the order among the
    # gang's members matters (they are the only candidates)
    creations = snap.task_creation.max() + 1 + torch.arange(G, dtype=i32, device=dev)

    qsafe = queue.clamp(0, Q - 1)
    gang_req = torch.where(pending[:, None], req, 0.0).sum(dim=0)
    queue_request = snap.queue_request.index_add(
        0, qsafe.long().reshape(1), torch.where(queue >= 0, gang_req, 0.0)[None])

    def app(arr, value):
        # a Python value is filled on the device: never a blocking upload
        if isinstance(value, torch.Tensor):
            tail = value.to(arr.dtype).reshape(1)
        else:
            tail = torch.full((1,), value, dtype=arr.dtype, device=dev)
        return torch.cat([arr, tail])

    J = snap.job_min_avail.shape[0]  # the appended job's row
    return snap._replace(
        task_req=req,
        task_resreq=req,
        task_job=torch.full((G,), J, dtype=i32, device=dev),
        task_prio=prio.to(i32).expand(G),
        task_creation=creations,
        task_status=torch.where(valid, int(TaskStatus.PENDING),
                                int(TaskStatus.UNKNOWN)).to(i32),
        task_valid=valid,
        task_pending=pending,
        task_best_effort=best_effort,
        # i32 views of u32 words: broadcast, never cast
        task_sel_bits=sel_bits[None, :].expand(G, sel_bits.shape[0]),
        task_sel_impossible=sel_impossible.expand(G),
        task_tol_bits=tol_bits[None, :].expand(G, tol_bits.shape[0]),
        task_node=torch.full((G,), -1, dtype=i32, device=dev),
        task_critical=torch.zeros(G, dtype=torch.bool, device=dev),
        task_needs_host=torch.zeros(G, dtype=torch.bool, device=dev),
        task_aff_idx=torch.full((1,), -1, dtype=i32, device=dev),
        task_aff_mask=torch.ones((1, N), dtype=torch.bool, device=dev),
        task_pref_idx=torch.full((1,), -1, dtype=i32, device=dev),
        task_pref_node=torch.zeros((1, N), dtype=torch.float32, device=dev),
        task_pref_pod=torch.zeros((1, N), dtype=torch.float32, device=dev),
        job_min_avail=app(snap.job_min_avail, min_avail),
        job_ready=app(snap.job_ready, 0),
        job_queue=app(snap.job_queue, qsafe),
        job_prio=app(snap.job_prio, prio),
        job_creation=app(snap.job_creation, snap.job_creation.max() + 1),
        job_valid=app(snap.job_valid, queue >= 0),
        job_schedulable=app(snap.job_schedulable, True),
        job_allocated=torch.cat([snap.job_allocated, snap.job_allocated.new_zeros(
            (1, snap.job_allocated.shape[1]))]),
        queue_request=queue_request,
    )


def overcommit_idle(snap: DeviceSnapshot) -> torch.Tensor:
    """[R] — the enqueue action's capability budget: Σ allocatable × 1.2 −
    Σ used over valid nodes (enqueue.go:74-81); the same for every gang."""
    used = torch.where(snap.node_valid[:, None], snap.node_used, 0.0).sum(dim=0)
    return (snap.total * OVERCOMMIT_FACTOR - used).clamp(min=0.0)


def _admission_verdict(idle, quanta, min_res, has_min_res, queue_alloc,
                       queue_cap, queue_known):
    """The enqueue action's admission test for one speculative PodGroup:
    MinResources within the overcommitted idle budget (a sub-quantum
    excess tolerated), and the queue's ``JobEnqueueable`` veto:
    MinResources plus the queue's allocation within its capability, with
    the same tolerance.  An unknown or invalid queue skips the veto; no
    MinResources promotes unconditionally (enqueue.go:102-105)."""
    fits_cap = ((min_res <= idle) | (min_res - idle < quanta)).all()
    need = min_res + queue_alloc
    fits_queue = ((need <= queue_cap) | (need - queue_cap < quanta)).all()
    return ~has_min_res | (fits_cap & (~queue_known | fits_queue))


class _VictimBase(NamedTuple):
    """The eviction probe's gang-independent inputs, computed once per
    batch: each task's queue, the base victim eligibility, the victims'
    reverse task order and the per-job gang slack."""

    task_queue: torch.Tensor
    running: torch.Tensor
    victim_rank: torch.Tensor
    slack0: torch.Tensor


def _victim_base(snap: DeviceSnapshot, config: EvictConfig) -> _VictimBase:
    return _VictimBase(
        task_queue=snap.job_queue[snap.task_job.long()],
        running=victim_running(snap),
        victim_rank=ordering.multisort_ranks([snap.task_prio, -snap.task_creation]),
        slack0=gang_slack0(snap, config),
    )


def _evict_probe(snap: DeviceSnapshot, req, pending, queue, min_avail,
                 assigned0, bid_fn, config: EvictConfig, base: _VictimBase,
                 n_nodes=None):
    """The hypothetical preempt pass for one gang: which nodes its unplaced
    members would claim and which Running victims would go, built on the
    eviction solve's own victim machinery (``claim_winners``,
    ``pick_victims``) with the gang's members as the only claimants.  For
    a speculative job every same-queue Running task is another job's, so
    the preempt victim filter (preempt.go:113-121) is the queue test.

    ``bid_fn(claimant_ok, cap) -> (best, has)`` is the [G, N] bid head.
    ``n_nodes`` (default the snapshot's) is the node count: the sharded
    probe's tail passes it.
    Returns (claim_node [G] i32, victims [T] bool, covered [] bool)."""
    G = req.shape[0]
    T = snap.task_req.shape[0]
    N = snap.node_alloc.shape[0] if n_nodes is None else n_nodes
    J = snap.job_min_avail.shape[0]
    Q = snap.queue_weight.shape[0]
    dev = req.device
    i32 = torch.int32
    tj = snap.task_job.long()

    q_ok = (queue >= 0) & (queue < Q)
    claimant_base = pending & (assigned0 < 0) & q_ok
    # one job's claimants: the rank among them is the member index (equal
    # priority, ascending creation)
    rank_g = torch.arange(G, dtype=i32, device=dev)
    vn = snap.task_node.long().clamp(0, N - 1)

    claim_node = torch.full((G,), -1, dtype=i32, device=dev)
    evicted = torch.zeros(T, dtype=torch.bool, device=dev)
    i = 0
    progress = True
    while i < config.rounds and progress:
        placed = claim_node >= 0
        slack_rem = base.slack0 - _segment_sum(evicted.to(i32), tj, J)
        victim_ok = base.running & ~evicted
        if config.victim_conformance:
            victim_ok = victim_ok & ~snap.task_critical
        if config.victim_gang:
            victim_ok = victim_ok & (slack_rem[tj] > 0)
        vq = victim_ok & (base.task_queue == queue)

        # per-node evictable capacity for the gang's queue
        vreq = torch.where(vq[:, None], snap.task_resreq, 0.0)
        cap = _segment_sum(vreq, torch.where(vq, snap.task_node, N), N + 1)[:N]

        claimant_ok = claimant_base & ~placed
        best, has = bid_fn(claimant_ok, cap)
        has = has & claimant_ok

        # one winner per node: the lowest member rank
        is_winner, winner_member, node_has_claim = claim_winners(has, best, rank_g, N)
        node_req = torch.where(node_has_claim[:, None],
                               req[winner_member.long().clamp(min=0)], float("inf"))

        # the solve's victim machinery: reverse task order, the gang slack
        # cap (no proportion budget: preempt semantics), coverage
        vmask = vq & node_has_claim[vn]
        final_take, covered = pick_victims(snap, vmask, node_req, node_has_claim,
                                           base.victim_rank, slack_rem, config, N)

        new_claim = is_winner & covered[best.long().clamp(0, N - 1)]
        claim_node = torch.where(new_claim, best, claim_node)
        evicted = evicted | final_take
        i += 1
        progress = round_end(new_claim.any())  # host sync, once per round

    if config.gang:
        # preempt's commit gate: the allocate pass's placements plus the
        # claims must reach MinAvailable, else the claims revert and the
        # victims stay (preempt.go:127-137); one job, so wholesale
        n_ready = (assigned0 >= 0).sum(dtype=i32)
        n_pipe = (claim_node >= 0).sum(dtype=i32)
        job_ok = (n_ready + n_pipe) >= min_avail
        claim_node = torch.where(job_ok, claim_node, -1)
        evicted = evicted & job_ok
    else:
        job_ok = (claim_node >= 0).any()
    return claim_node, evicted, job_ok


def probe_solve(snap: DeviceSnapshot, batch: ProbeBatch, probe_rows: torch.Tensor,
                config: AllocateConfig,
                evict_config: EvictConfig = EvictConfig(mode="preempt"),
                with_evictions: bool = False) -> ProbeResult:
    """B gangs against one snapshot, on the device its tensors lie on: one
    gang after another, stacked into [B, ...] results.

    ``probe_rows`` [G] i32 are the global task rows the next G submitted
    pods would occupy, shared across the batch: every gang is an
    independent hypothetical from the same frozen allocator state.

    This is the one place where a thread other than the scheduling
    cycle's launches device work (the query plane's batcher, through
    ``serve/plane.py``): on the calling thread's current stream, which is
    the default stream the cycle uses too, so a swap issued after a
    probe's kernels runs after them, and the lease broker keeps the swap
    out until the probe's readback is done."""
    N = snap.node_alloc.shape[0]
    dev = snap.task_req.device
    rows = probe_rows.to(device=dev, dtype=torch.int32)
    tie_hash = tie_break_hash_rows(rows, torch.arange(N, dtype=torch.int32, device=dev))
    oc_idle = overcommit_idle(snap)
    victim_base = _victim_base(snap, evict_config) if with_evictions else None

    Q = snap.queue_valid.shape[0]
    J = snap.job_min_avail.shape[0]  # the appended job's row
    T = snap.task_req.shape[0]
    G = batch.req.shape[1]
    if not with_evictions:
        # no eviction verdict: one empty answer, shared by every gang (the
        # final stack copies it)
        no_evict = (torch.full((G,), -1, dtype=torch.int32, device=dev),
                    torch.zeros(T, dtype=torch.bool, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev))
    out = []
    # kbt: allow[KBT005] one solve per gang of the batch, where the JAX package vmaps
    # the gangs into one dispatch: each gang's bidding rounds read back
    # through round_end (tier B's budget); a one-launch batch is an open
    # item in ROADMAP.md (the probe's per-gang loop)
    for b in range(batch.req.shape[0]):
        g = ProbeBatch(*(f[b] for f in batch))
        view = _gang_view(snap, g.req, g.valid, g.min_avail, g.queue, g.prio,
                          g.sel_bits, g.sel_impossible, g.tol_bits)
        head, static_ok, score = round_head_parts(view, config, rows=rows)
        res = allocate_rounds(view, config, head, snap.node_idle, snap.node_releasing,
                              snap.node_used)
        feasible = (~view.task_pending | (res.assigned >= 0)).all()
        # an empty or all-best-effort gang is not a solver verdict: backfill,
        # not this solve, would bind sub-quanta pods
        feasible = feasible & view.task_pending.any()
        # the per-member fit-error histogram at cycle-start budgets: the
        # committed cycle's histogram for the submitted gang's rows
        fit0 = (fits(view.task_req, snap.node_idle, snap.quanta)
                | fits(view.task_req, snap.node_releasing, snap.quanta))
        # a [1] index, not a 0-d one: indexing with a 0-d tensor reads it
        # back to the host first
        q1 = g.queue.clamp(0, Q - 1).long().reshape(1)
        queue_known = (g.queue >= 0) & (g.queue < Q) & snap.queue_valid[q1][0]
        enqueue_ok = _admission_verdict(
            oc_idle, snap.quanta, g.min_res, g.has_min_res,
            snap.queue_alloc[q1][0], snap.queue_capability[q1][0], queue_known)
        if with_evictions:
            def bid_fn(claimant_ok, cap, g=g, static_ok=static_ok, score=score):
                feas = static_ok & claimant_ok[:, None] & fits(g.req, cap, snap.quanta)
                return _best_node(torch.where(feas, score, NEG), tie_hash)

            claim_node, victims, evict_ok = _evict_probe(
                snap, g.req, view.task_pending, g.queue, g.min_avail, res.assigned,
                bid_fn, evict_config, victim_base)
        else:
            claim_node, victims, evict_ok = no_evict
        out.append(ProbeResult(
            assigned=res.assigned,
            pipelined=res.pipelined,
            committed=res.committed[J],
            feasible=feasible,
            reasons=failure_histogram(view, static_ok, fit0),
            enqueue_ok=enqueue_ok,
            claim_node=claim_node,
            victims=victims,
            evict_covered=evict_ok,
        ))
    return ProbeResult(*(torch.stack([r[i] for r in out]) for i in range(len(ProbeResult._fields))))
