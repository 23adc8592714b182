"""Task ordering — the order-fn tiers as device-computed ranks.

Mirrors ``kube_batch_tpu/ops/ordering.py``: the queue/job/task order chain
(session_plugins.go:281-369) collapses into one total order rank[T] built
from chained stable argsorts; conflicts for a node are won by the lowest
rank.  Every argsort passes ``stable=True`` (``jnp.argsort`` is stable).

``segmented_prefix``'s ``cumsum`` adds in another order than XLA's; on
exactly representable inputs (the resource quanta the snapshots carry)
the sums agree, on arbitrary f32 data they may differ in the last bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from kube_batch_tpu_torch.ops import fairness

_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


def segmented_prefix(values_sorted: torch.Tensor,
                     is_start: torch.Tensor) -> torch.Tensor:
    """Exclusive per-segment prefix sum of already-sorted [T, R] values ≥ 0:
    each segment's base is a running max of the global exclusive cumsum
    captured at segment starts."""
    csum = torch.cumsum(values_sorted, dim=0)
    prev = csum - values_sorted
    base = torch.cummax(torch.where(is_start[:, None], prev, 0.0), dim=0).values
    return prev - base


def run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """[T] bool — True where a run of equal sorted keys begins."""
    start = torch.ones_like(sorted_keys, dtype=torch.bool)
    start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return start


def round_to_i32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.round(x).astype(int32)``: half to even, saturating at the
    int32 range as XLA's conversion does (torch's cast is undefined out of
    range)."""
    r = torch.round(x)
    inside = r.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(r >= 2147483648.0, _I32_MAX,
                       torch.where(r < -2147483648.0, _I32_MIN, inside))


def sort_by_segment_then_rank(segment: torch.Tensor, rank: torch.Tensor,
                              n_segments: int) -> torch.Tensor:
    """argsort by (segment, rank) where rank is a permutation of [0, T): one
    packed int32 key when it fits, else two chained stable argsorts."""
    T = rank.shape[0]
    t_pow = 1 << max(T - 1, 1).bit_length()
    if n_segments * t_pow < 2**31:
        return torch.argsort(segment * t_pow + rank, stable=True)
    order = torch.argsort(rank, stable=True)
    return order[torch.argsort(segment[order], stable=True)]


def multisort_ranks(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """rank[i] = position of element i under lexicographic (keys[0],
    keys[1], ...) ascending order."""
    n = keys[0].shape[0]
    dev = keys[0].device
    order = torch.arange(n, device=dev)
    # kbt: allow[KBT005] one stable sort per key over the static key list (the
    # JAX package's trace-time unroll)
    for key in reversed(list(keys)):
        order = order[torch.argsort(key[order], stable=True)]
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[order] = torch.arange(n, dtype=torch.int32, device=dev)
    return rank


def _scatter_back(order: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    """out[order[i]] = sorted_vals[i] for a permutation ``order``."""
    out = torch.empty_like(sorted_vals)
    out[order] = sorted_vals
    return out


def virtual_task_ranks(
    pending: torch.Tensor,       # [T] bool — bidders this round
    resreq: torch.Tensor,        # [T, R]
    task_job: torch.Tensor,      # [T] i32
    task_queue: torch.Tensor,    # [T] i32
    subrank: torch.Tensor,       # [T] i32 — within-job TaskOrderFn rank
    job_prio: torch.Tensor,      # [J] i32
    job_ready_now: torch.Tensor,  # [J] bool
    job_creation: torch.Tensor,  # [J] i32
    job_alloc: torch.Tensor,     # [J, R]
    queue_alloc: torch.Tensor,   # [Q, R]
    deserved: torch.Tensor,      # [Q, R]
    total: torch.Tensor,         # [R]
    job_need: torch.Tensor,      # [J] i32 — minAvailable − currently-ready
    gang_enabled: bool,
    drf_enabled: bool,
    proportion_enabled: bool,
) -> torch.Tensor:
    """[T] i32 — the total order the sequential pop loop would serve tasks
    in, as fair-queuing virtual time (see the JAX package's docstring for
    the derivation).  Key chain, outer → inner: queue virtual proportion
    share, job priority desc, gang starved-first, job virtual drf share,
    job creation, within-job subrank.  An unready job's first ``job_need``
    pending tasks (its gang chunk) stay contiguous."""
    n_jobs = job_prio.shape[0]
    n_queues = deserved.shape[0]
    tj = task_job.long()
    rq = torch.where(pending[:, None], resreq, 0.0)

    # job axis: position of each pending task within its job
    order_j = sort_by_segment_then_rank(task_job, subrank, n_jobs)
    js = tj[order_j]
    j_start = run_starts(js)
    pend_j = pending[order_j]
    ci = pend_j.float()[:, None]
    pos_in_job = segmented_prefix(ci, j_start)[:, 0].to(torch.int32)
    in_chunk_sorted = pend_j & (pos_in_job < job_need[js])
    in_chunk = _scatter_back(order_j, in_chunk_sorted)

    # virtual drf share: chunk-start share in the chunk, per-task prefix
    # share beyond it
    prefix_j = segmented_prefix(rq[order_j], j_start)
    share_start = fairness.dominant_share(job_alloc, total)
    vd_sorted = torch.where(
        in_chunk_sorted,
        share_start[js],
        fairness.dominant_share(job_alloc[js] + prefix_j, total),
    )
    v_drf = _scatter_back(order_j, vd_sorted)

    wq_keys = [-job_prio[tj]]
    if gang_enabled:
        wq_keys.append(job_ready_now[tj].to(torch.int32))  # starved first
    if drf_enabled:
        wq_keys.append(round_to_i32(v_drf * 1e6))
    wq_keys += [job_creation[tj], subrank]
    wq_rank = multisort_ranks(wq_keys)

    if not proportion_enabled:
        return multisort_ranks([task_queue, wq_rank])

    # queue-axis virtual proportion share; a gang chunk's head share is
    # broadcast job-wide with a scatter-min so the chunk stays contiguous
    order_q = sort_by_segment_then_rank(task_queue, wq_rank, n_queues)
    qs = task_queue.long()[order_q]
    q_start = run_starts(qs)
    prefix_q = segmented_prefix(rq[order_q], q_start)
    vq_sorted = fairness.queue_share(queue_alloc[qs] + prefix_q, deserved[qs])
    v_q = _scatter_back(order_q, vq_sorted)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=v_q.device)
    head_vq = torch.full((n_jobs,), float("inf"), dtype=torch.float32,
                         device=v_q.device).scatter_reduce_(
        0, tj, torch.where(in_chunk, v_q, inf), reduce="amin")
    v_q = torch.where(in_chunk, head_vq[tj], v_q)

    return multisort_ranks([round_to_i32(v_q * 1e6), wq_rank])


def task_subranks(task_prio: torch.Tensor,
                  task_creation: torch.Tensor) -> torch.Tensor:
    """[T] i32 within-job order: priority desc then creation asc."""
    return multisort_ranks([-task_prio, task_creation])
