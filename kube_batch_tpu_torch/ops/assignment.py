"""The gang-constrained allocate solve — allocate.go + statement.go as
batched auction rounds on the device.

Mirrors ``kube_batch_tpu/ops/assignment.py`` (see its docstring for the
semantics): every unplaced task bids for its best feasible node, conflicts
on a node admit bidders in task-order rank while the node's budget lasts,
losers re-bid; after the rounds, jobs that miss MinAvailable have their
placements reverted (Statement.Discard) and an outer pass lets the others
re-bid for what was freed.

The JAX package's ``while_loop``s become Python loops.  A full solve pays
one host sync per bidding round (the "anything placed?" test) plus one per
outer pass (the "anything left to do?" test); the compacted solve adds one
per round for the exhaustion test of its candidate table.  The JAX
package's ``lax.cond`` short-cuts that only skip work whose result is
zeros are computed unconditionally (or masked with a device-side flag),
which gives the same values with no sync.

The round head is kernel K1 (``ops/kernels.py``) and the candidate-table
build kernel K2; on CPU tensors both run their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot
from kube_batch_tpu_torch.ops import fairness, ordering
from kube_batch_tpu_torch.ops.feasibility import fits, static_predicates
from kube_batch_tpu_torch.ops.kernels import (  # noqa: F401 — _tie_break_hash re-exported
    _H1,
    NEG,
    _tie_break_hash,
    f32_sort_key,
    masked_best_node_raw,
    masked_topk_blocks,
    tie_break_hash_rows,
)
from kube_batch_tpu_torch.ops.ordering import run_starts
from kube_batch_tpu_torch.ops.ordering import segmented_prefix as _segmented_prefix
from kube_batch_tpu_torch.ops.scoring import ScoreWeights, score_matrix
from kube_batch_tpu_torch.utils.seams import round_end

_I32_MIN = -(2**31)


def _segment_sum(data: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: [num_segments, ...] sums of ``data`` rows
    by ``seg``.  f32 adds may land in any order on CUDA; the snapshots'
    values are exact multiples of their quanta, so every order gives the
    same sum."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, seg.long(), data)


def _scatter_perm(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[order[i]] = vals[i] for a permutation ``order``."""
    out = torch.empty_like(vals)
    out[order] = vals
    return out


def _best_node(masked: torch.Tensor, tie_hash: torch.Tensor):
    """Lexicographic argmax: max score, then max tie hash, then the first
    index.  Returns (best [T] i32, has [T] bool)."""
    best_val = masked.amax(dim=1)
    tie = masked >= best_val[:, None]
    best = torch.where(tie, tie_hash, -1).argmax(dim=1).to(torch.int32)
    return best, best_val > NEG


class AllocateConfig(NamedTuple):
    """Solve configuration (plugin enables + round counts).  The JAX
    package's ``use_pallas`` has no counterpart: the tensors' device picks
    the kernels (CUDA) or their plain versions (CPU)."""

    rounds: int = 6          # bidding rounds per outer iteration
    outer: int = 3           # gang discard-retry iterations
    gang: bool = True        # gang plugin (JobReady commit gate)
    drf: bool = True         # drf job ordering
    proportion: bool = True  # queue overused gating + queue order
    topk: int = 0            # candidate-table width (allocate_topk_solve)
    weights: ScoreWeights = ScoreWeights()


class AllocateResult(NamedTuple):
    assigned: torch.Tensor        # [T] i32 node index, -1 = unplaced
    pipelined: torch.Tensor       # [T] bool — placed on Releasing budget
    committed: torch.Tensor       # [J] bool — job's placements were kept
    node_idle: torch.Tensor       # [N, R] post-solve
    node_releasing: torch.Tensor  # [N, R] post-solve
    node_used: torch.Tensor       # [N, R] post-solve
    deserved: torch.Tensor        # [Q, R] proportion deserved
    rounds_run: torch.Tensor      # [] i32 — bidding rounds executed
    topk_exhausted: torch.Tensor  # [] i32 — exhausted task-rounds (topk)
    topk_reentries: torch.Tensor  # [] i32 — rounds that re-entered the
    #                               full head for exhausted rows (topk)


def _queue_gate(cand, order, task_job, task_queue, resreq, qalloc, deserved,
                quanta, job_need, n_jobs: int) -> torch.Tensor:
    """Proportion admission (allocate.go:101-104, proportion.go:198-209):
    walk each queue's bidders in rank order; a bidder passes while its
    queue is not yet overused at its prefix position; an unready job's
    first ``need`` bidders (its gang chunk) pass iff the queue was not
    overused when the chunk head arrived."""
    R = resreq.shape[1]
    cs = cand[order]
    qs = task_queue.long()[order]
    js = task_job.long()[order]
    rq = torch.where(cs[:, None], resreq[order], 0.0)
    prefix = _segmented_prefix(rq, run_starts(qs))
    sem = fairness.semantic_mask(R, resreq.device)
    pos_overused = ((deserved[qs] <= qalloc[qs] + prefix + quanta) | ~sem).all(dim=-1)
    ci = cs.float()[:, None]
    pos_in_job = _segmented_prefix(ci, run_starts(js))[:, 0].to(torch.int32)
    in_chunk = cs & (pos_in_job < job_need[js])
    head = (cs & (pos_in_job == 0) & ~pos_overused).to(torch.int32)
    head_ok = _segment_sum(head, js, n_jobs) > 0
    ok = cs & (~pos_overused | (in_chunk & head_ok[js]))
    return _scatter_perm(order, ok)


def _resolve_conflicts(cand, choice, rank, fit_req, acct_req, budget, quanta):
    """Admit bidders per node in rank order while the prefix fits the
    budget: each bidder is charged its predecessors' Resreq plus its own
    InitResreq.  Returns (accept [T] bool, delta [N, R] consumed)."""
    N = budget.shape[0]
    seg = torch.where(cand, choice, N)  # non-bidders park in segment N
    order = ordering.sort_by_segment_then_rank(seg, rank, N + 1)
    seg_s = seg[order].long()
    cand_s = cand[order]
    acct_s = torch.where(cand_s[:, None], acct_req[order], 0.0)
    within_excl = _segmented_prefix(acct_s, run_starts(seg_s))
    budget_here = budget[seg_s.clamp(0, N - 1)]
    ok = (fit_req[order] + within_excl <= budget_here + quanta).all(dim=-1)
    accept_s = ok & cand_s & (seg_s < N)
    delta = _segment_sum(torch.where(accept_s[:, None], acct_s, 0.0), seg_s,
                         N + 1)[:N]
    return _scatter_perm(order, accept_s), delta


def round_head_parts(snap: DeviceSnapshot, config: AllocateConfig, rows=None):
    """``(head, static_ok, score)``: the single-program round head
    ``head(idle, releasing, pending) -> (best, has, chose_idle)`` — kernel
    K1 over the full [T, N] matrices — and its loop-invariant inputs.
    ``rows`` [T] i32 (the what-if probe's) are the global task rows the
    tie hash is taken at, in place of the snapshot's own rows; the JAX
    package's explicit ``tie_hash`` is this, computed inside K1."""
    static_ok = static_predicates(snap)
    score = score_matrix(snap, config.weights)

    def head(idle, releasing, pending):
        best, val, _hash, chose = masked_best_node_raw(
            score, static_ok, snap.task_req, idle, releasing, pending,
            snap.quanta, rows=rows,
        )
        return best, val > NEG, chose

    return head, static_ok, score


def local_round_head(snap: DeviceSnapshot, config: AllocateConfig):
    return round_head_parts(snap, config)[0]


def allocate_rounds(snap: DeviceSnapshot, config: AllocateConfig, head_fn,
                    idle0, releasing0, used0,
                    compact_head=None) -> AllocateResult:
    """The solve machinery shared by the full and compacted paths: bidding
    rounds with ``head_fn`` (or ``compact_head``, which also returns the
    exhausted-row count) supplying (best, has, chose_idle), the proportion
    gate, conflict resolution, and the gang commit/discard outer loop."""
    T, R = snap.task_req.shape
    N = idle0.shape[0]
    J = snap.job_min_avail.shape[0]
    Q = snap.queue_weight.shape[0]
    dev = idle0.device
    i32 = torch.int32
    tj = snap.task_job.long()
    task_queue = snap.job_queue[tj]

    subrank = ordering.task_subranks(snap.task_prio, snap.task_creation)
    # proportion deserved, once per cycle from the session-open state
    deserved = fairness.proportion_deserved(
        snap.total, snap.queue_weight, snap.queue_request, snap.queue_valid
    )
    eligible = (snap.task_pending & snap.task_valid & snap.job_valid[tj]
                & snap.job_schedulable[tj])

    def job_counts(mask):
        return _segment_sum(mask.to(i32), tj, J)

    idle, releasing, used = idle0, releasing0, used0
    assigned = torch.full((T,), -1, dtype=i32, device=dev)
    pipelined = torch.zeros(T, dtype=torch.bool, device=dev)
    job_failed = torch.zeros(J, dtype=torch.bool, device=dev)
    exhausted = torch.zeros((), dtype=i32, device=dev)
    reentries = 0
    rounds_run = 0
    o = 0
    more = True
    while o < config.outer and more:
        # fairness state + virtual-time rank, once per outer pass
        placed0 = assigned >= 0
        job_new0 = _segment_sum(
            torch.where(placed0[:, None], snap.task_resreq, 0.0), tj, J)
        ready0 = snap.job_ready + job_counts(placed0 & ~pipelined)
        pending0 = eligible & ~placed0 & ~job_failed[tj]
        rank = ordering.virtual_task_ranks(
            pending0, snap.task_resreq, snap.task_job, task_queue, subrank,
            snap.job_prio, ready0 >= snap.job_min_avail, snap.job_creation,
            snap.job_allocated + job_new0,
            snap.queue_alloc + _segment_sum(job_new0, snap.job_queue, Q),
            deserved, snap.total, (snap.job_min_avail - ready0).clamp(min=0),
            gang_enabled=config.gang, drf_enabled=config.drf,
            proportion_enabled=config.proportion,
        )
        # queue-major rank-minor order for the gate, static per outer pass
        qgate_order = ordering.sort_by_segment_then_rank(task_queue, rank, Q)

        i = 0
        progress = True
        while i < config.rounds and progress:
            placed = assigned >= 0
            job_new = _segment_sum(
                torch.where(placed[:, None], snap.task_resreq, 0.0), tj, J)
            queue_alloc = snap.queue_alloc + _segment_sum(
                job_new, snap.job_queue, Q)
            pending = eligible & ~placed & ~job_failed[tj]

            if compact_head is not None:
                best, has, chose_idle, exh_round, reentered = compact_head(
                    idle, releasing, pending)
                exhausted = exhausted + exh_round
                # kbt: allow[KBT005] `reentered` is already a host bool: the
                # compact head's one sync a round, inside tier B's per-round
                # budget of two
                reentries += int(reentered)
            else:
                best, has, chose_idle = head_fn(idle, releasing, pending)
            if config.proportion:
                ready = snap.job_ready + job_counts(placed & ~pipelined)
                has = has & _queue_gate(
                    has, qgate_order, snap.task_job, task_queue,
                    snap.task_resreq, queue_alloc, deserved, snap.quanta,
                    (snap.job_min_avail - ready).clamp(min=0), J,
                )
            # allocate on Idle or pipeline on Releasing (allocate.go:161-184);
            # with no pipeline bidders the second pass admits nothing and
            # adds zeros, which is what the JAX package's cond skips
            acc_a, delta_a = _resolve_conflicts(
                has & chose_idle, best, rank, snap.task_req,
                snap.task_resreq, idle, snap.quanta)
            acc_p, delta_p = _resolve_conflicts(
                has & ~chose_idle, best, rank, snap.task_req,
                snap.task_resreq, releasing, snap.quanta)
            idle = idle - delta_a
            releasing = releasing - delta_p
            used = used + delta_a + delta_p
            newly = acc_a | acc_p
            assigned = torch.where(newly, best, assigned)
            pipelined = pipelined | acc_p
            i += 1
            progress = round_end(newly.any())  # host sync, once per round
        rounds_run += i
        rounds_capped = progress and i >= config.rounds

        # gang commit/discard (vectorized Statement)
        new_alloc_cnt = job_counts((assigned >= 0) & ~pipelined)
        if config.gang:
            job_ok = (snap.job_ready + new_alloc_cnt) >= snap.job_min_avail
        else:
            job_ok = torch.ones(J, dtype=torch.bool, device=dev)
        # a reverted job is done for this cycle (allocate.go:192-196)
        job_failed = job_failed | (~job_ok & (job_counts(assigned >= 0) > 0))
        revert = (assigned >= 0) & ~job_ok[tj]
        seg = torch.where(revert, assigned, N)
        rev_req = torch.where(revert[:, None], snap.task_resreq, 0.0)
        rev_alloc = _segment_sum(
            torch.where(~pipelined[:, None], rev_req, 0.0), seg, N + 1)[:N]
        rev_pipe = _segment_sum(
            torch.where(pipelined[:, None], rev_req, 0.0), seg, N + 1)[:N]
        idle = idle + rev_alloc
        releasing = releasing + rev_pipe
        used = used - rev_alloc - rev_pipe
        assigned = torch.where(revert, -1, assigned)
        pipelined = pipelined & ~revert
        # another pass when a gang was reverted (freed capacity) or the
        # rounds hit their cap while placing, and schedulable work remains
        left = (eligible & (assigned < 0) & ~job_failed[tj]).any()
        more = bool(((revert.any() | rounds_capped) & left))  # host sync
        o += 1

    committed = job_counts(assigned >= 0) > 0
    return AllocateResult(
        assigned=assigned,
        pipelined=pipelined,
        committed=committed,
        node_idle=idle,
        node_releasing=releasing,
        node_used=used,
        deserved=deserved,
        rounds_run=torch.full((), rounds_run, dtype=i32, device=dev),
        topk_exhausted=exhausted,
        topk_reentries=torch.full((), reentries, dtype=i32, device=dev),
    )


def allocate_solve(snap: DeviceSnapshot, config: AllocateConfig) -> AllocateResult:
    """One allocate action pass over the snapshot (the full [T, N] solve)."""
    return allocate_rounds(
        snap, config, local_round_head(snap, config),
        snap.node_idle, snap.node_releasing, snap.node_used,
    )


# ==========================================================================
# Top-K candidate compaction — the O(P·K) round inner loop
# ==========================================================================
#
# The compacted solve runs its rounds on a [P] bucket of the cycle's
# pending rows against a [P, K] candidate table: each row's top-K nodes by
# the exact round-head key (score_static desc, tie hash desc, node asc)
# among the nodes feasible at the cycle-start budgets.  Budgets only
# shrink during a solve, so while any table entry still fits, the argmax
# over the fitting entries IS the full argmax; a row whose entries all
# stop fitting while its table was truncated re-enters the full head the
# same round.  Compacted == full, bit for bit, by construction.


#: the sort key of NEG, computed once on the host
# kbt: allow[KBT005] an import-time constant, computed once on a CPU tensor
_NEG_KEY = int(f32_sort_key(torch.tensor([NEG], dtype=torch.float32))[0])


def _neg_key() -> int:
    return _NEG_KEY


def lex_topk(skey: torch.Tensor, hash_: torch.Tensor, idx0: torch.Tensor,
             K: int, block: int = 64):
    """Exact per-row lexicographic top-K of (skey desc, hash desc, position
    asc) over [P, M]: per-block winner triples once, then K extraction
    steps that re-reduce only the winning block under the extracted
    threshold.  Returns ``(idx, skey, hash)`` [P, K] in descending order."""
    P, M = skey.shape
    dev = skey.device
    C = min(block, M)
    Mp = -(-M // C) * C
    pad = Mp - M
    if pad:
        F = torch.nn.functional
        skey = F.pad(skey, (0, pad), value=_I32_MIN)
        hash_ = F.pad(hash_, (0, pad), value=-1)
        idx0 = F.pad(idx0, (0, pad), value=-1)
    B = Mp // C
    s3 = skey.reshape(P, B, C)
    h3 = hash_.reshape(P, B, C)
    bval = s3.amax(dim=-1)
    hm = torch.where(s3 >= bval[..., None], h3, -2)
    bh = hm.amax(dim=-1)
    bcol = hm.argmax(dim=-1).to(torch.int32)
    carange = torch.arange(C, dtype=torch.int64, device=dev)[None, :]

    oi = torch.zeros((P, K), dtype=torch.int32, device=dev)
    os_ = torch.full((P, K), _I32_MIN, dtype=torch.int32, device=dev)
    oh = torch.full((P, K), -1, dtype=torch.int32, device=dev)
    # kbt: allow[KBT005] K static extraction steps (the JAX package's trace-time
    # unroll): a fixed few launches over [P, B] a step, once per table build
    for k in range(K):
        # global two-key argmax over the block winners; the first block
        # among full ties is the lowest position
        gv = bval.amax(dim=1)
        ghm = torch.where(bval >= gv[:, None], bh, -2)
        ghv = ghm.amax(dim=1)
        gb = ghm.argmax(dim=1)                                   # int64
        col = bcol.gather(1, gb[:, None])[:, 0].long()
        flat = gb * C + col
        oi[:, k] = idx0.gather(1, flat[:, None])[:, 0]
        os_[:, k] = gv
        oh[:, k] = ghv
        # the winning block re-reduces under the extracted threshold: keep
        # strictly lower keys, or equal keys at later positions
        cols_ = (gb * C)[:, None] + carange
        gs = skey.gather(1, cols_)
        gh2 = hash_.gather(1, cols_)
        keep = (gs < gv[:, None]) | ((gs == gv[:, None]) & (
            (gh2 < ghv[:, None])
            | ((gh2 == ghv[:, None]) & (cols_ > flat[:, None]))))
        gs = torch.where(keep, gs, _I32_MIN)
        nv = gs.amax(dim=1)
        nhm = torch.where(gs >= nv[:, None], gh2, -2)
        bval.scatter_(1, gb[:, None], nv[:, None])
        bh.scatter_(1, gb[:, None], nhm.amax(dim=1, keepdim=True))
        bcol.scatter_(1, gb[:, None],
                      nhm.argmax(dim=1, keepdim=True).to(torch.int32))
    return oi, os_, oh


def _remap_rows(sparse_idx: torch.Tensor, pend_rows: torch.Tensor) -> torch.Tensor:
    """Map sparse per-task row indices into pending-bucket slots; rows
    outside the bucket park at -1."""
    eq = sparse_idx[:, None] == pend_rows[None, :]           # [Ks, P]
    hit = eq.any(dim=1) & (sparse_idx >= 0)
    slot = eq.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(hit, slot, -1)


def pend_view(snap: DeviceSnapshot, pend_rows: torch.Tensor) -> DeviceSnapshot:
    """``snap`` with the task axis gathered to the [P] pending bucket
    (``pend_rows`` global task rows, -1 padding).  Padding slots carry row
    0's data with valid/pending forced off."""
    T = snap.task_req.shape[0]
    safe = pend_rows.long().clamp(0, T - 1)
    live = pend_rows >= 0

    def g(arr):
        return arr[safe]

    return snap._replace(
        task_req=g(snap.task_req),
        task_resreq=g(snap.task_resreq),
        task_job=g(snap.task_job),
        task_prio=g(snap.task_prio),
        task_creation=g(snap.task_creation),
        task_status=g(snap.task_status),
        task_valid=g(snap.task_valid) & live,
        task_pending=g(snap.task_pending) & live,
        task_best_effort=g(snap.task_best_effort),
        task_sel_bits=g(snap.task_sel_bits),
        task_sel_impossible=g(snap.task_sel_impossible),
        task_tol_bits=g(snap.task_tol_bits),
        task_node=g(snap.task_node),
        task_critical=g(snap.task_critical),
        task_needs_host=g(snap.task_needs_host),
        task_aff_idx=_remap_rows(snap.task_aff_idx, pend_rows),
        task_pref_idx=_remap_rows(snap.task_pref_idx, pend_rows),
    )


def compact_candidates(view_p: DeviceSnapshot, pend_rows: torch.Tensor,
                       idle0, releasing0, quanta, config: AllocateConfig,
                       n0: int = 0):
    """The per-solve candidate build: rank each bucket row's nodes by the
    exact (score_static, tie hash, index) key at the cycle-start budgets
    (kernel K2 emits the masked key plane) and keep the top
    ``config.topk``.  Returns ``(idx, skey, hash, n_feas, score_static,
    tie_hash)``."""
    K = config.topk
    P = view_p.task_req.shape[0]
    N_blk = idle0.shape[0]
    dev = idle0.device
    safe_rows = pend_rows.clamp(min=0).to(torch.int32)
    n_idx = torch.arange(N_blk, dtype=torch.int32, device=dev) + n0
    tie_hash = tie_break_hash_rows(safe_rows, n_idx)
    static_ok = static_predicates(view_p)
    score = score_matrix(view_p, config.weights)
    score_static = torch.where(static_ok, score, NEG)
    # K2's block triples are a by-product here: the extraction below
    # reduces from the key plane itself
    skey0 = masked_topk_blocks(score_static, view_p.task_req, idle0,
                               releasing0, safe_rows, quanta, n0=n0)[0]
    n_feas = (skey0 > _neg_key()).sum(dim=1, dtype=torch.int32)
    idx0 = n_idx[None, :].expand(P, N_blk)
    ki, ks, kh = lex_topk(skey0, tie_hash, idx0, K)
    return ki, ks, kh, n_feas, score_static, tie_hash


def _rel_fits(req, releasing, quanta, fit_fn):
    """The releasing fit, all-False when nothing is releasing — the JAX
    package's ``lax.cond`` on ``any(releasing > 0)``, as a device-side mask
    instead of a host branch."""
    return fit_fn(req, releasing, quanta) & (releasing > 0.0).any()


def make_compact_head(cand_idx, cand_skey, cand_hash, truncated, req_p,
                      quanta, N: int, fallback_fn):
    """The compacted round head: ``head(idle, releasing, pending) -> (best,
    has, chose_idle, exhausted_count, reentered)`` over the [P, K] table,
    re-entering ``fallback_fn`` (the full head over the bucket) for
    exhausted rows only; ``reentered`` is a host bool (one sync)."""
    valid = cand_skey > _neg_key()
    safe_idx = cand_idx.long().clamp(0, N - 1)

    def fits_k(req, budget, q):
        return (req[:, None, :] <= budget[safe_idx] + q).all(dim=-1)

    def head(idle, releasing, pending):
        fit_idle = fits_k(req_p, idle, quanta)                   # [P, K]
        fit_rel = _rel_fits(req_p, releasing, quanta, fits_k)
        fit_k = valid & (fit_idle | fit_rel) & pending[:, None]
        sk = torch.where(fit_k, cand_skey, _I32_MIN)
        best_sk = sk.amax(dim=1)
        hk = torch.where(sk >= best_sk[:, None], cand_hash, -1)
        # first position among (key, hash) ties = lowest node index
        pos = hk.argmax(dim=1, keepdim=True)
        has_p = fit_k.any(dim=1)
        best_p = cand_idx.gather(1, pos)[:, 0]
        chose_p = fit_idle.gather(1, pos)[:, 0]
        exh_p = pending & ~has_p & truncated
        reentered = bool(exh_p.any())  # host sync, once per round
        if reentered:
            fb_best, fb_has, fb_chose = fallback_fn(idle, releasing, exh_p)
            best_p = torch.where(exh_p, fb_best, best_p)
            has_p = torch.where(exh_p, fb_has, has_p)
            chose_p = torch.where(exh_p, fb_chose, chose_p)
        return (best_p, has_p, chose_p, exh_p.sum(dtype=torch.int32),
                reentered)

    return head


def scatter_bucket_result(res: AllocateResult, pend_rows: torch.Tensor,
                          T: int) -> AllocateResult:
    """Re-express a bucket-axis result on the full [T] task axis; padding
    slots land in a dropped T slot."""
    scat = torch.where(pend_rows >= 0, pend_rows, T).long()
    assigned = torch.full((T + 1,), -1, dtype=torch.int32,
                          device=pend_rows.device)
    assigned[scat] = res.assigned
    pipelined = torch.zeros(T + 1, dtype=torch.bool, device=pend_rows.device)
    pipelined[scat] = res.pipelined
    return res._replace(assigned=assigned[:T], pipelined=pipelined[:T])


def make_bucket_fallback(view_p: DeviceSnapshot, score_static_p, tie_hash_p,
                         quanta):
    """The exhaustion re-entry: the full-matrix head restricted to the [P]
    bucket, masked to the exhausted rows.  Its rows are the bucket's
    scattered global rows, so it hashes with the bucket's own tie hash
    rather than K1's arange-of-rows hash."""
    req_p = view_p.task_req

    def fallback(idle, releasing, pending_exh):
        fit_idle = fits(req_p, idle, quanta)
        fit_rel = _rel_fits(req_p, releasing, quanta, fits)
        masked = torch.where((fit_idle | fit_rel) & pending_exh[:, None],
                             score_static_p, NEG)
        best_p, has_p = _best_node(masked, tie_hash_p)
        chose_p = fit_idle.gather(1, best_p.long()[:, None])[:, 0]
        return best_p, has_p, chose_p

    return fallback


def allocate_topk_solve(snap: DeviceSnapshot, pend_rows: torch.Tensor,
                        config: AllocateConfig) -> AllocateResult:
    """The compacted allocate solve: identical outputs to
    :func:`allocate_solve` on the [P] pending bucket × [P, K] candidate
    table.  ``pend_rows`` [P] i32 must cover every schedulable-pending row
    (-1 padding); ``config.topk`` = K > 0."""
    T = snap.task_req.shape[0]
    N = snap.node_idle.shape[0]
    view_p = pend_view(snap, pend_rows)
    ki, ks, kh, n_feas, score_static_p, tie_hash_p = compact_candidates(
        view_p, pend_rows, snap.node_idle, snap.node_releasing, snap.quanta,
        config,
    )
    fallback = make_bucket_fallback(view_p, score_static_p, tie_hash_p,
                                    snap.quanta)
    head = make_compact_head(ki, ks, kh, n_feas > config.topk,
                             view_p.task_req, snap.quanta, N, fallback)
    res = allocate_rounds(view_p, config, None, snap.node_idle,
                          snap.node_releasing, snap.node_used,
                          compact_head=head)
    return scatter_bucket_result(res, pend_rows, T)


# ==========================================================================
# Warm-started compacted allocate (KB_WARM): the cross-cycle table carry
# ==========================================================================
#
# The compacted solve's candidate build re-ranks every bucket row against
# every node once per solve.  The warm path carries the [P, W] table on the
# device between solves, and each cycle only re-ranks the invalidated rows
# (new to the bucket, own features moved, eroded: a sub-bucket
# compact_candidates at a fixed rung) and merges the changed nodes' fresh
# keys ([P, C]) into every carried row.  The JAX package's module comment
# (ops/assignment.py, "Warm-started incremental allocate") has the
# exactness argument: every node absent from a row's valid entries either
# changed (its fresh key is in this merge) or keys below the row's last
# valid entry θ, and the merge cuts whatever falls below θ (or below the
# E-th fresh key φ) and marks the row truncated, so the table stays an
# exact prefix and the exhaustion re-entry covers the rest.  The planner
# is ``api/resident.WarmTableState``; ``KB_WARM=0`` keeps the cold build.


def lex_topk3(skey: torch.Tensor, hash_: torch.Tensor, idx: torch.Tensor,
              K: int, block: int = 64):
    """Exact per-row top-K of (skey desc, hash desc, idx asc) with the index
    as an explicit third key: :func:`lex_topk` breaks full ties by
    position, which equals the index order only when the columns are
    index-sorted, and the warm merge's are not.  Requires per-row-unique
    indices among valid entries.  Returns ``(idx, skey, hash)`` [P, K]."""
    P, M = skey.shape
    dev = skey.device
    C = min(block, M)
    Mp = -(-M // C) * C
    pad = Mp - M
    if pad:
        F = torch.nn.functional
        skey = F.pad(skey, (0, pad), value=_I32_MIN)
        hash_ = F.pad(hash_, (0, pad), value=-1)
        idx = F.pad(idx, (0, pad), value=1 << 30)
    B = Mp // C
    BIG = 1 << 30

    def block_reduce(s, h, i):
        bval = s.amax(dim=-1)
        t1 = s >= bval[..., None]
        bh = torch.where(t1, h, -2).amax(dim=-1)
        t2 = t1 & (h == bh[..., None])
        return bval, bh, torch.where(t2, i, BIG).amin(dim=-1)

    bval, bh, bidx = block_reduce(skey.reshape(P, B, C), hash_.reshape(P, B, C),
                                  idx.reshape(P, B, C))
    barange = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    carange = torch.arange(C, dtype=torch.int64, device=dev)[None, :]
    oi = torch.zeros((P, K), dtype=torch.int32, device=dev)
    os_ = torch.full((P, K), _I32_MIN, dtype=torch.int32, device=dev)
    oh = torch.full((P, K), -1, dtype=torch.int32, device=dev)
    # kbt: allow[KBT005] K static extraction steps (the JAX package's trace-time
    # unroll): a fixed few launches over [P, B] a step, once per table build
    for k in range(K):
        gv = bval.amax(dim=1)
        t1 = bval >= gv[:, None]
        ghv = torch.where(t1, bh, -2).amax(dim=1)
        t2 = t1 & (bh == ghv[:, None])
        gidx = torch.where(t2, bidx, BIG).amin(dim=1)
        # indices are per-row unique: exactly one block holds the winner
        gb = (t2 & (bidx == gidx[:, None])).to(torch.uint8).argmax(dim=1)
        oi[:, k] = gidx
        os_[:, k] = gv
        oh[:, k] = ghv
        # re-reduce only the winning block, keeping the entries strictly
        # lex-below the extracted (gv, ghv, gidx)
        cols_ = (gb * C)[:, None] + carange
        gs = skey.gather(1, cols_)
        gh2 = hash_.gather(1, cols_)
        gi2 = idx.gather(1, cols_)
        keep = (gs < gv[:, None]) | ((gs == gv[:, None]) & (
            (gh2 < ghv[:, None])
            | ((gh2 == ghv[:, None]) & (gi2 > gidx[:, None]))))
        nv, nh, ni = block_reduce(torch.where(keep, gs, _I32_MIN)[:, None, :],
                                  gh2[:, None, :], gi2[:, None, :])
        win = barange == gb[:, None]
        bval = torch.where(win, nv, bval)
        bh = torch.where(win, nh, bh)
        bidx = torch.where(win, ni, bidx)
    return oi, os_, oh


def node_view(snap: DeviceSnapshot, node_rows: torch.Tensor) -> DeviceSnapshot:
    """``snap`` with the node axis gathered to ``node_rows`` (-1 padding →
    dead columns: node_valid forced off).  Every live column equals the
    same column of the full matrices."""
    N = snap.node_idle.shape[0]
    safe = node_rows.long().clamp(0, N - 1)
    live = node_rows >= 0

    def g(arr):
        return arr[safe]

    def g1(arr):  # [K, N] sparse rows: the node axis is axis 1
        return arr[:, safe]

    return snap._replace(
        node_idle=g(snap.node_idle),
        node_releasing=g(snap.node_releasing),
        node_used=g(snap.node_used),
        node_alloc=g(snap.node_alloc),
        node_valid=g(snap.node_valid) & live,
        node_sched=g(snap.node_sched),
        node_label_bits=g(snap.node_label_bits),
        node_taint_bits=g(snap.node_taint_bits),
        task_aff_mask=g1(snap.task_aff_mask),
        task_pref_node=g1(snap.task_pref_node),
        task_pref_pod=g1(snap.task_pref_pod),
    )


def fresh_block_skey(view_pc: DeviceSnapshot, quanta: torch.Tensor,
                     config: AllocateConfig) -> torch.Tensor:
    """[P, C] sort keys of the changed-node columns at the current
    cycle-start budgets: ``compact_candidates``' key derivation on a node
    subset, in plain ops.  The releasing fit counts only when something in
    the view is releasing (the JAX package's ``lax.cond`` over the view's
    columns, as a device-side mask); K2 ORs it in unconditionally, so it
    would key differently for a request that fits a zero budget within
    ``quanta``."""
    static_ok = static_predicates(view_pc)
    score = score_matrix(view_pc, config.weights)
    score_static = torch.where(static_ok, score, NEG)
    fit0 = fits(view_pc.task_req, view_pc.node_idle, quanta)
    fit0_rel = _rel_fits(view_pc.task_req, view_pc.node_releasing, quanta, fits)
    return f32_sort_key(torch.where(fit0 | fit0_rel, score_static, NEG))


#: fresh candidates inserted per row per merge; rows where more changed
#: nodes belong in the top W are φ-cut (still exact, thinner, truncated)
FRESH_E = 8


def _lex_ge(s, h, i, ts, th, ti):
    """Entry (s, h, i) at or above threshold (ts, th, ti) in the table
    order (skey desc, hash desc, idx asc)."""
    return (s > ts) | ((s == ts) & ((h > th) | ((h == th) & (i <= ti))))


def warm_refresh_table(t_idx, t_skey, t_hash, t_trunc, row_map, rows_m,
                       changed_nodes, skey_c, hash_c, ri, rs, rh, trunc_i,
                       rerank_slots, N: int, k_min: int):
    """One cycle's table maintenance over the [M] live prefix (M =
    ``row_map``'s length; rows past M stay as they are): permute the
    carried table into the new bucket order (``row_map``: old slot per new
    slot, -1 = fresh row), remove the changed nodes' stale entries, merge
    in the top FRESH_E of their fresh keys (a counting merge of two sorted
    lists), cut at lexmax(θ, φ), and overwrite the re-ranked rows with
    their fresh builds at ``rerank_slots``.

    Returns new tensors ``(idx, skey, hash, trunc, eroded)``: the full
    [P, W] table and the [P] erosion flag (truncated and fewer than a
    per-row staggered floor of at least ``k_min`` valid entries)."""
    P, W = t_skey.shape
    M = row_map.shape[0]
    E = FRESH_E
    neg = _neg_key()
    BIG = 1 << 30
    dev = t_skey.device
    i32 = torch.int32
    # ---- 1. permute the live prefix into the new bucket order --------
    live = row_map >= 0
    safe = row_map.long().clamp(0, M - 1)
    idx = torch.where(live[:, None], t_idx[:M][safe], 0)
    skey = torch.where(live[:, None], t_skey[:M][safe], _I32_MIN)
    hsh = torch.where(live[:, None], t_hash[:M][safe], -1)
    # a fresh row starts truncated: its empty table claims nothing
    trunc = torch.where(live, t_trunc[:M][safe], True)
    # ---- 2. θ per row: the last valid entry, before removal ----------
    valid = skey > neg
    vcnt = valid.sum(dim=1, dtype=i32)
    last = (vcnt - 1).clamp(0, W - 1).long()[:, None]
    has_any = vcnt > 0
    th_s = torch.where(has_any, skey.gather(1, last)[:, 0], neg)
    th_h = torch.where(has_any, hsh.gather(1, last)[:, 0], 2**31 - 1)
    th_i = torch.where(has_any, idx.gather(1, last)[:, 0], -1)
    # ---- 3. remove the changed nodes' stale entries ------------------
    changed_mask = torch.zeros(N + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(changed_nodes >= 0, changed_nodes, N).long(), True)[:N]
    keep = valid & ~changed_mask[idx.long().clamp(0, N - 1)]
    skey = torch.where(keep, skey, _I32_MIN)
    # ---- 4. top-E of the fresh block (short tournament) --------------
    C = changed_nodes.shape[0]
    idx_c = changed_nodes[None, :].expand(M, C)
    fresh_ok = (changed_nodes >= 0)[None, :] & (skey_c > neg)
    fi, fs, fh = lex_topk3(torch.where(fresh_ok, skey_c, _I32_MIN), hash_c,
                           idx_c, E)
    f_valid = fs > neg
    # φ: the E-th extracted fresh key; every fresh candidate not extracted
    # is strictly lex-below it (indices are unique)
    phi_live = f_valid[:, E - 1]
    ph_s, ph_h, ph_i = fs[:, E - 1], fh[:, E - 1], fi[:, E - 1]
    # ---- 5. merge of the two sorted lists, by counting ---------------
    keep_i = keep.to(i32)
    kp = torch.cumsum(keep_i, dim=1, dtype=i32) - keep_i
    kept_cnt = keep.sum(dim=1, dtype=i32)
    jcols = torch.arange(W, dtype=i32, device=dev)[None, :]
    # stored position of the j-th kept entry (dropped entries land in a
    # spare column W that is sliced away)
    kth_kept = torch.zeros((M, W + 1), dtype=i32, device=dev).scatter_(
        1, torch.where(keep, kp, W).long(), jcols.expand(M, W).contiguous(),
    )[:, :W]
    # fresh rank of each top-E entry in the merged output: its own position
    # plus the kept entries lex-above it
    gt = _lex_ge(skey[:, :, None], hsh[:, :, None], idx[:, :, None],
                 fs[:, None, :], fh[:, None, :], fi[:, None, :])
    fresh_rank = torch.arange(E, dtype=i32, device=dev)[None, :] + (
        gt & keep[:, :, None]).sum(dim=1, dtype=i32)
    # fresh entries consumed before output j: the two list cursors
    b = (f_valid[:, None, :] & (fresh_rank[:, None, :] < jcols[:, :, None])
         ).sum(dim=2, dtype=i32)
    a = jcols - b

    def g(arr, cur, ok, fill):
        v = arr.gather(1, cur.clamp(0, arr.shape[1] - 1).long())
        return torch.where(ok, v, fill)

    s_ok = a < kept_cnt[:, None]
    sp = g(kth_kept, a, s_ok, 0)
    hs_s = g(skey, sp, s_ok, _I32_MIN)
    hs_h = g(hsh, sp, s_ok, -1)
    hs_i = g(idx, sp, s_ok, BIG)
    f_ok = (b < E) & f_valid.gather(1, b.clamp(0, E - 1).long())
    hf_s = g(fs, b, f_ok, _I32_MIN)
    hf_h = g(fh, b, f_ok, -1)
    hf_i = g(fi, b, f_ok, BIG)
    take_f = f_ok & ~(s_ok & _lex_ge(hs_s, hs_h, hs_i, hf_s, hf_h, hf_i))
    ns = torch.where(take_f, hf_s, hs_s)
    nh = torch.where(take_f, hf_h, hs_h)
    ni = torch.where(take_f, hf_i, hs_i)
    overflow = (kept_cnt + f_valid.sum(dim=1, dtype=i32)) > W
    # ---- 6. cut at lexmax(θ, φ) --------------------------------------
    ge = _lex_ge(ns, nh, ni, th_s[:, None], th_h[:, None], th_i[:, None])
    ge &= ~phi_live[:, None] | _lex_ge(
        ns, nh, ni, ph_s[:, None], ph_h[:, None], ph_i[:, None])
    cut_any = ((ns > neg) & ~ge).any(dim=1)
    ns = torch.where((ns > neg) & ge, ns, _I32_MIN)
    # a live φ means fresh candidates below it may be missing: the row can
    # no longer claim completeness even when nothing was cut
    trunc = trunc | cut_any | overflow | phi_live
    # ---- 7. overwrite the re-ranked rows -----------------------------
    scat = torch.where(rerank_slots >= 0, rerank_slots, M).long()

    def over(dst, upd):
        out = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])], 0)
        out[scat] = upd
        return out[:M]

    ni = over(ni, ri)
    ns = over(ns, rs)
    nh = over(nh, rh)
    trunc = over(trunc, trunc_i)
    # ---- 8. erosion flag (staggered per row) + full-table assembly ---
    vcnt2 = (ns > neg).sum(dim=1, dtype=i32)
    spread = max(W - k_min, 1)
    jitter = ((rows_m.clamp(min=0) * _H1) >> 16 & 0xFFFF) % spread
    eroded = trunc & (vcnt2 < k_min + jitter)
    return (torch.cat([ni, t_idx[M:]], 0), torch.cat([ns, t_skey[M:]], 0),
            torch.cat([nh, t_hash[M:]], 0), torch.cat([trunc, t_trunc[M:]], 0),
            torch.cat([eroded, eroded.new_zeros(P - M)], 0))


def make_lazy_bucket_fallback(view_p: DeviceSnapshot, pend_rows, quanta,
                              config: AllocateConfig):
    """The warm path's exhaustion re-entry: the full head over the bucket
    with the [P, N] score and hash planes built at the first round that
    re-enters (a solve that never re-enters never builds them) and kept for
    the solve's later rounds: they depend on the bucket view alone.  The
    JAX package rebuilds them inside every re-entering round's cond."""
    safe_rows = pend_rows.clamp(min=0).to(torch.int32)
    N = view_p.node_idle.shape[0]
    built = []

    def fallback(idle, releasing, pending_exh):
        if not built:
            static_ok = static_predicates(view_p)
            score = score_matrix(view_p, config.weights)
            ss = torch.where(static_ok, score, NEG)
            tie = tie_break_hash_rows(
                safe_rows, torch.arange(N, dtype=torch.int32, device=idle.device))
            built.append(make_bucket_fallback(view_p, ss, tie, quanta))
        return built[0](idle, releasing, pending_exh)

    return fallback


def _warm_allocate_solve(snap: DeviceSnapshot, pend_rows, t_idx, t_skey,
                         t_hash, t_trunc, row_map, changed_nodes, rerank_rows,
                         rerank_slots, config: AllocateConfig, k_min: int):
    """The warm-started compacted solve: the outputs of
    :func:`allocate_topk_solve` (and so of the full solve) against the
    carried table, refreshed by :func:`warm_refresh_table`.
    ``config.topk`` is the stored width W; ``k_min`` the erosion floor.
    Returns ``(AllocateResult, (idx, skey, hash, trunc), eroded)``."""
    T = snap.task_req.shape[0]
    N = snap.node_idle.shape[0]
    M = row_map.shape[0]
    view_p = pend_view(snap, pend_rows)
    # fresh keys of the changed-node columns over the [M] live prefix
    rows_m = pend_rows[:M]
    view_pc = node_view(pend_view(snap, rows_m), changed_nodes)
    skey_c = fresh_block_skey(view_pc, snap.quanta, config)
    hash_c = tie_break_hash_rows(rows_m.clamp(min=0), changed_nodes.clamp(min=0))
    # the invalidated sub-bucket's full re-rank (K2 on the card): the only
    # [·, N] work of a steady warm cycle
    view_i = pend_view(snap, rerank_rows)
    ri, rs, rh, n_feas, _ss, _tie = compact_candidates(
        view_i, rerank_rows, snap.node_idle, snap.node_releasing, snap.quanta,
        config)
    ni, ns, nh, trunc, eroded = warm_refresh_table(
        t_idx, t_skey, t_hash, t_trunc, row_map, rows_m, changed_nodes,
        skey_c, hash_c, ri, rs, rh, n_feas > config.topk, rerank_slots,
        N, k_min)
    fallback = make_lazy_bucket_fallback(view_p, pend_rows, snap.quanta, config)
    head = make_compact_head(ni, ns, nh, trunc, view_p.task_req, snap.quanta,
                             N, fallback)
    res = allocate_rounds(view_p, config, None, snap.node_idle,
                          snap.node_releasing, snap.node_used,
                          compact_head=head)
    return scatter_bucket_result(res, pend_rows, T), (ni, ns, nh, trunc), eroded


def warm_allocate_solve(snap, pend_rows, table, plan, config, k_min):
    """Dispatch-facing warm solve: ``table`` is the carried (idx, skey,
    hash, trunc) tensors, ``plan`` the planner's (row_map, changed_nodes,
    rerank_rows, rerank_slots) int32 tensors on the same device."""
    t_idx, t_skey, t_hash, t_trunc = table
    row_map, changed, rr, rslots = plan
    return _warm_allocate_solve(snap, pend_rows, t_idx, t_skey, t_hash,
                                t_trunc, row_map, changed, rr, rslots,
                                config, k_min)


def failure_histogram_solve(snap: DeviceSnapshot) -> torch.Tensor:
    """[T, N_REASONS] i32 cycle-start fit-error histogram, its own dispatch:
    the allocate action runs it only when the solve left pending tasks
    unplaced (allocate.go:151-155 builds FitErrors for failing tasks
    only)."""
    from kube_batch_tpu_torch.ops.feasibility import failure_histogram

    static_ok = static_predicates(snap)
    fit = (fits(snap.task_req, snap.node_idle, snap.quanta)
           | fits(snap.task_req, snap.node_releasing, snap.quanta))
    return failure_histogram(snap, static_ok, fit)


def failure_histogram_bucket_solve(snap: DeviceSnapshot,
                                   pend_rows: torch.Tensor) -> torch.Tensor:
    """:func:`failure_histogram_solve` over the [P] pending bucket instead of
    [T, N]: the histogram is read only at unplaced pending rows, all of
    which the bucket covers, and each row is a reduction over nodes alone —
    so the bucket rows equal the full program's and the other rows (never
    read) are zeros."""
    from kube_batch_tpu_torch.ops.feasibility import N_REASONS, failure_histogram

    T = snap.task_req.shape[0]
    view_p = pend_view(snap, pend_rows)
    static_ok = static_predicates(view_p)
    fit = (fits(view_p.task_req, snap.node_idle, snap.quanta)
           | fits(view_p.task_req, snap.node_releasing, snap.quanta))
    h = failure_histogram(view_p, static_ok, fit)
    scat = torch.where(pend_rows >= 0, pend_rows, T).long()
    out = torch.zeros((T + 1, N_REASONS), dtype=torch.int32, device=h.device)
    return out.index_copy_(0, scat, h)[:T]
