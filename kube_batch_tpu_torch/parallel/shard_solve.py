"""The shard bodies of the sharded solves, with every cross-device byte
written out as one explicit collective.

Mirrors ``kube_batch_tpu/parallel/shard_solve.py`` (see its docstring for
the exactness argument).  Where the JAX package runs one ``shard_map``
body on every device, a body here is a Python loop over the mesh's
positions that launches each position's block work on that position's
device; launches are asynchronous, so positions on distinct cards
overlap.  Per round:

- each position computes its [T_blk, N_loc] block of the round head —
  kernel K1 at its global origin ``(t0, n0)`` on CUDA tensors, K1's plain
  version on CPU tensors — and keeps its two-key winner (value, tie hash,
  global index, chose-idle);
- :func:`_combine_best` moves each position's small payload to the mesh's
  first device, concatenates it in shard order and reduces it there
  (max value, then max hash, then the lowest global index: ``argmax``'s
  first-index semantics over the whole node axis); on a 2-D mesh
  :func:`_gather_tasks` then concatenates the task blocks.

The node ledgers are gathered once per solve (:func:`_gather_nodes`) and
the conflict-resolution and gang-commit tail runs once, on the first
device, through ``ops/assignment.allocate_rounds`` and
``ops/eviction.evict_rounds`` — the JAX package runs it replicated on
every shard; the outputs are equal.  Each round the tail's ledgers and
pending mask are sliced back to each position's device (a no-op where the
position shares the first device).  Those moves are not collectives of
the JAX package's program, whose tail runs on every shard: they are
counted apart (``Collectives.move``), per round with their bytes and
shapes, as what a mesh of distinct cards would move.

Each collective counts its result bytes, per round and per solve, under
the JAX package's definition (``utils/jitstats.collective_inventory``: a
site's result size, once per site per round): ``last_collectives[kind]``
holds the last solve's.  ``TIME_COLLECTIVES`` adds the collectives' wall
time (each synchronises the mesh's CUDA devices before and after).

Under ``parallel/distributed.py`` every rank runs the same body over the
positions it owns, and :func:`collect` exchanges the payloads through
``torch.distributed.all_gather``; the tail then runs on every rank, on the
same inputs.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from kube_batch_tpu_torch.ops import assignment as asg
from kube_batch_tpu_torch.ops import eviction as evi
from kube_batch_tpu_torch.ops.feasibility import failure_histogram, fits, static_predicates
from kube_batch_tpu_torch.ops.kernels import (
    NEG,
    _tie_break_hash,
    f32_sort_key,
    masked_best_node_raw,
    tie_break_hash_rows,
)
from kube_batch_tpu_torch.ops.scoring import score_matrix

BIG = 1 << 30
i32 = torch.int32

#: the last solve's collective record per body kind ("allocate", "topk",
#: "warm", "evict", "histogram", "histogram_bucket", "probe")
last_collectives: Dict[str, "Collectives"] = {}

#: synchronise around each collective and add its wall ms to the record
TIME_COLLECTIVES = False


class Collectives:
    """One solve's collectives: per phase ("per_round", "per_solve") and
    primitive, the count and the result bytes; the rounds run; and, when
    ``TIME_COLLECTIVES`` is set, their wall ms.  ``sites`` lists every
    collective and every move of the tail back to a position, one dict
    each (kind, phase, round, bytes, shape); the moves are not in
    ``ops``."""

    def __init__(self, mesh, kind: str):
        self.mesh = mesh
        self.kind = kind
        self.ops = {"per_round": {}, "per_solve": {}}
        self.sites: List[dict] = []
        self.rounds = 0
        self.ms = {"per_round": 0.0, "per_solve": 0.0}
        self.timing = TIME_COLLECTIVES
        last_collectives[kind] = self

    def note(self, phase: str, prim: str, out: torch.Tensor) -> None:
        """One collective whose result is ``out``."""
        rec = self.ops[phase].setdefault(prim, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += _nbytes(out)
        self._site(prim, phase, out)

    def move(self, t: torch.Tensor, d) -> torch.Tensor:
        """``t`` from the first device to a position's device ``d`` inside
        the round loop, counted whether or not ``d`` is another device."""
        self._site("move", "per_round", t)
        return t.to(d)

    def _site(self, kind: str, phase: str, t: torch.Tensor) -> None:
        self.sites.append({"kind": kind, "phase": phase, "round": self.rounds,
                           "bytes": _nbytes(t), "shape": tuple(t.shape)})

    def _sync(self) -> None:
        for d in self.mesh.distinct():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def timed(self, phase: str, fn):
        if not self.timing:
            return fn()
        self._sync()
        t = time.perf_counter()
        out = fn()
        self._sync()
        self.ms[phase] += (time.perf_counter() - t) * 1e3
        return out

    def summary(self) -> dict:
        """Bytes and ms per solve, and per round (the round total over the
        rounds run)."""
        rb = sum(r["bytes"] for r in self.ops["per_round"].values())
        return {
            "rounds": self.rounds,
            "per_round_bytes": rb // self.rounds if self.rounds else 0,
            "per_round_bytes_total": rb,
            "per_solve_bytes": sum(r["bytes"] for r in self.ops["per_solve"].values()),
            "per_round_ms": self.ms["per_round"] / self.rounds if self.rounds else 0.0,
            "per_round_ms_total": self.ms["per_round"],
            "per_solve_ms": self.ms["per_solve"],
            "ops": self.ops,
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collect(mesh, local: Dict, dev0, row: int = 0) -> List[torch.Tensor]:
    """Node shard by node shard (positions ``(row, j)``), each position's
    tensor on ``dev0``, in shard order.  ``local`` maps this process's
    positions to their tensors; under ``distributed`` the rest arrive
    through ``torch.distributed.all_gather`` (every rank owns the same
    number of positions per row; gloo exchanges through the CPU)."""
    positions = [(row, j) for j in range(mesh.node_shards)]
    if not mesh.distributed:
        return [local[p].to(dev0) for p in positions]
    import torch.distributed as dist

    mine = [p for p in positions if mesh.is_local(*p)]
    stacked = torch.stack([local[p] for p in mine])
    gloo = dist.get_backend(mesh.group) == "gloo"
    if gloo:
        stacked = stacked.cpu()
    bufs = [torch.empty_like(stacked) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(bufs, stacked.contiguous(), group=mesh.group)
    out = []
    for p in positions:
        owner = mesh.ranks[p[0] * mesh.node_shards + p[1]]
        k = [q for q in positions if mesh.ranks[q[0] * mesh.node_shards + q[1]] == owner].index(p)
        out.append(bufs[owner][k].to(dev0))
    return out


def _gather_nodes(acct: Collectives, local: Dict, dev0, dim: int = 0, row: int = 0):
    """The once-per-solve reassembly of a node-sharded column on the first
    device (counted when the node axis is split)."""
    parts = acct.timed("per_solve", lambda: collect(acct.mesh, local, dev0, row))
    if len(parts) == 1:
        return parts[0]
    out = torch.cat(parts, dim)
    acct.note("per_solve", "all_gather", out)
    return out


def _gather_tasks(acct: Collectives, blocks: List[torch.Tensor]):
    """The task blocks of a 2-D mesh, concatenated (counted when the task
    axis is split).  The blocks already lie on the first device."""
    if len(blocks) == 1:
        return blocks[0]
    out = torch.cat(blocks)
    acct.note("per_round", "all_gather", out)
    return out


def _psum(acct: Collectives, phase: str, local: Dict, dev0, row: int = 0):
    """An integer (exact) or f32 sum over the node shards, in shard order,
    on the first device; counted at one part's size (the JAX psum's
    result)."""
    parts = acct.timed(phase, lambda: collect(acct.mesh, local, dev0, row))
    acct.note(phase, "psum", parts[0])
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _block_view(snap, t0: int, T_blk: int, task_shards: int):
    """``snap`` restricted to the task block [t0, t0 + T_blk): task columns
    sliced, the sparse affinity and preference row indices remapped into
    block coordinates (rows outside the block park at -1)."""
    if task_shards == 1:
        return snap

    def ts(x):
        return x[t0:t0 + T_blk]

    def remap(idx):
        return torch.where((idx >= t0) & (idx < t0 + T_blk), idx - t0, -1).to(idx.dtype)

    return snap._replace(
        task_req=ts(snap.task_req), task_resreq=ts(snap.task_resreq),
        task_job=ts(snap.task_job), task_prio=ts(snap.task_prio),
        task_creation=ts(snap.task_creation), task_status=ts(snap.task_status),
        task_valid=ts(snap.task_valid), task_pending=ts(snap.task_pending),
        task_best_effort=ts(snap.task_best_effort), task_sel_bits=ts(snap.task_sel_bits),
        task_sel_impossible=ts(snap.task_sel_impossible), task_tol_bits=ts(snap.task_tol_bits),
        task_node=ts(snap.task_node), task_critical=ts(snap.task_critical),
        task_needs_host=ts(snap.task_needs_host),
        task_aff_idx=remap(snap.task_aff_idx), task_pref_idx=remap(snap.task_pref_idx),
    )


def _local_best(masked, tie_blk, n0: int):
    """This block's two-key winner: (value, hash among value ties, global
    index of the first (value, hash) tie, block-local pick)."""
    lval = masked.amax(dim=1)
    cand = torch.where(masked >= lval[:, None], tie_blk, -1)
    pick = cand.argmax(dim=1).to(i32)
    return lval, cand.amax(dim=1).to(i32), pick + n0, pick


def _inv_sort_key(k):
    """Inverse of ``f32_sort_key`` (an exact bijection)."""
    b = torch.where(k < 0, k ^ 0x7FFFFFFF, k)
    return b.view(torch.float32)


def _combine_best(acct: Collectives, payloads: Dict, dev0, row: int = 0,
                  count: bool = True):
    """The cross-shard two-key argmax as one gathered payload: per node
    shard a stacked [3|4, T_blk] i32 of (value sort key, hash, global
    index[, extra]), concatenated in shard order on the first device and
    reduced there — max value, max hash among value ties, lowest index
    among (value, hash) ties, the winning shard's extra.  Equal to
    ``argmax`` over the concatenated node axis, bit for bit.  Returns
    (value, index[, extra]).  ``count``: one site per round (a 2-D mesh
    combines once per task block)."""
    local = {p: torch.stack([f32_sort_key(v), k, i] + ([x] if x is not None else []))
             for p, (v, k, i, x) in payloads.items()}
    parts = acct.timed("per_round", lambda: collect(acct.mesh, local, dev0, row))
    g = torch.stack(parts)                                  # [S, 3|4, T]
    if count:
        acct.note("per_round", "all_gather", g)
    gv, gk, gi = g[:, 0], g[:, 1], g[:, 2]
    vmax_k = gv.amax(dim=0)
    vmax = _inv_sort_key(vmax_k)
    eq = gv == vmax_k[None]
    kmax = torch.where(eq, gk, -1).amax(dim=0)
    eqk = eq & (gk == kmax[None])
    imin = torch.where(eqk, gi, BIG).amin(dim=0)
    if g.shape[1] == 3:
        return vmax, imin
    win = eqk & (gi == imin[None])
    shard = win.to(torch.uint8).argmax(dim=0)
    return vmax, imin, g[:, 3].gather(0, shard[None].long())[0]


class _Grid:
    """The mesh's local positions with their block geometry: (i, j), device,
    the position's snapshot, task origin t0, node origin n0."""

    def __init__(self, ss):
        mesh = ss.mesh
        self.mesh = mesh
        self.ts, self.ns = mesh.task_shards, mesh.node_shards
        base = ss.tail()
        self.T = base.task_req.shape[0]
        self.N_loc = base.node_alloc.shape[0]
        self.N = self.N_loc * self.ns
        self.T_blk = self.T // self.ts
        self.dev0 = mesh.first
        self.base = base
        self.cells = [(i, j, mesh.device(i, j), ss.shard(i, j), i * self.T_blk, j * self.N_loc)
                      for (i, j) in mesh.local_positions()]
        self.rows = sorted({c[0] for c in self.cells})
        self.row0 = self.rows[0]
        self.ss = ss

    def node_column(self, acct, field: str, dim: int = 0):
        return _gather_nodes(acct, {(i, j): getattr(s, field) for i, j, _d, s, _t, _n in self.cells
                                    if i == self.row0}, self.dev0, dim, self.row0)


# --------------------------------------------------------------------------
# allocate
# --------------------------------------------------------------------------


def allocate_shard_map(ss, config):
    """The full allocate solve over the mesh: K1 per position each round at
    its (t0, n0), the winners combined on the first device, the tail
    there.  The result lies on the first device."""
    grid = _Grid(ss)
    acct = Collectives(ss.mesh, "allocate")
    blocks = []
    for i, j, d, s, t0, n0 in grid.cells:
        view = _block_view(s, t0, grid.T_blk, grid.ts)
        blocks.append((i, j, d, view.task_req, static_predicates(view),
                       score_matrix(view, config.weights), s.quanta, t0, n0))
    N_loc, T_blk = grid.N_loc, grid.T_blk

    def head(idle_g, rel_g, pending):
        acct.rounds += 1
        best_b, has_b, chose_b = [], [], []
        for row in range(grid.ts):
            payload = {}
            for i, j, d, req, ok, score, q, t0, n0 in blocks:
                if i != row:
                    continue
                pick, val, hsh, chose = masked_best_node_raw(
                    score, ok, req, acct.move(idle_g[n0:n0 + N_loc], d),
                    acct.move(rel_g[n0:n0 + N_loc], d),
                    acct.move(pending[t0:t0 + T_blk], d), q, t0=t0, n0=n0)
                payload[(i, j)] = (val, hsh.to(i32), pick + n0, chose.to(i32))
            vmax, best, chose = _combine_best(acct, payload, grid.dev0, row, count=row == 0)
            best_b.append(best)
            has_b.append(vmax > NEG)
            chose_b.append(chose > 0)
        return (_gather_tasks(acct, best_b), _gather_tasks(acct, has_b),
                _gather_tasks(acct, chose_b))

    idle0 = grid.node_column(acct, "node_idle")
    rel0 = grid.node_column(acct, "node_releasing")
    used0 = grid.node_column(acct, "node_used")
    return asg.allocate_rounds(grid.base, config, head, idle0, rel0, used0)


def _replicated_nodes(grid: _Grid, acct: Collectives):
    """The base snapshot with every node column gathered (the compacted and
    warm bodies' per-solve gathers: the ledgers, the fallback's columns)."""
    cols = {f: grid.node_column(acct, f) for f in (
        "node_idle", "node_releasing", "node_used", "node_alloc", "node_valid",
        "node_sched", "node_label_bits", "node_taint_bits")}
    cols.update({f: grid.node_column(acct, f, dim=1) for f in (
        "task_aff_mask", "task_pref_node", "task_pref_pod")})
    return grid.base._replace(**cols)


def _merge_candidates(grid: _Grid, acct: Collectives, payload: Dict, P: int, K: int):
    """One per-solve gather of each shard's [P, 3K+1] candidate payload and
    the merge: shard-major concatenation (positions ascend with the global
    node index), the exact lexicographic top-K, the summed feasible count."""
    g = torch.stack(acct.timed("per_solve", lambda: collect(grid.mesh, payload, grid.dev0)))
    acct.note("per_solve", "all_gather", g)

    def cat(a, b):
        return g[:, :, a:b].permute(1, 0, 2).reshape(P, -1)

    n_feas = g[:, :, 3 * K].sum(dim=0, dtype=i32)
    mi, ms, mh = asg.lex_topk(cat(0, K), cat(K, 2 * K), cat(2 * K, 3 * K), K, block=max(K, 8))
    return mi, ms, mh, n_feas


def allocate_topk_shard_map(ss, pend_rows, config):
    """The compacted solve over a 1-D mesh: K2 per shard ranks its
    [P, N_loc] block into a [P, K] candidate list (global node indices,
    the hash at ``n0``), one gather and merge per solve, then the rounds on
    the first device with no per-round collective; the exhaustion re-entry
    reads the gathered node columns."""
    grid = _Grid(ss)
    acct = Collectives(ss.mesh, "topk")
    K = config.topk
    P = pend_rows.shape[0]
    payload = {}
    for i, j, d, s, _t0, n0 in grid.cells:
        rows_d = pend_rows.to(d)
        view = asg.pend_view(s, rows_d)
        ki, ks, kh, nf, _ss, _tie = asg.compact_candidates(
            view, rows_d, s.node_idle, s.node_releasing, s.quanta, config, n0=n0)
        payload[(i, j)] = torch.cat([ks, kh, ki, nf[:, None]], dim=1)
    mi, ms, mh, n_feas = _merge_candidates(grid, acct, payload, P, K)
    return _compact_rounds(grid, acct, pend_rows, config, mi, ms, mh, n_feas > K)


def _compact_rounds(grid: _Grid, acct: Collectives, pend_rows, config, ci, cs, ch, trunc):
    snap_repl = _replicated_nodes(grid, acct)
    rows0 = pend_rows.to(grid.dev0)
    view = asg.pend_view(snap_repl, rows0)
    fallback = asg.make_lazy_bucket_fallback(view, rows0, snap_repl.quanta, config)
    head = asg.make_compact_head(ci, cs, ch, trunc, view.task_req, snap_repl.quanta,
                                 grid.N, fallback)
    res = asg.allocate_rounds(view, config, None, snap_repl.node_idle,
                              snap_repl.node_releasing, snap_repl.node_used,
                              compact_head=head)
    return asg.scatter_bucket_result(res, rows0, grid.T)


def warm_allocate_shard_map(ss, pend_rows, table, plan, config, k_min: int):
    """The warm-started solve over a 1-D mesh: per shard only delta-sized
    work — the fresh keys of its own changed nodes (one exact sum: each
    changed node belongs to one shard) and its candidate lists for the
    invalidated rows (one gather and merge) — then the table refresh and
    the rounds on the first device.  Returns ``(result, table', eroded)``."""
    grid = _Grid(ss)
    acct = Collectives(ss.mesh, "warm")
    W = config.topk
    t_idx, t_skey, t_hash, t_trunc = table
    row_map, changed, rerank_rows, rerank_slots = plan
    M = row_map.shape[0]
    Pi = rerank_rows.shape[0]
    fresh, payload = {}, {}
    for i, j, d, s, _t0, n0 in grid.cells:
        rows_m = pend_rows[:M].to(d)
        chg = changed.to(d)
        loc = chg - n0
        own = (chg >= 0) & (loc >= 0) & (loc < grid.N_loc)
        view_lc = asg.node_view(asg.pend_view(s, rows_m), torch.where(own, loc, -1))
        skey = asg.fresh_block_skey(view_lc, s.quanta, config)
        fresh[(i, j)] = torch.where(own[None, :], skey, 0)
        rr = rerank_rows.to(d)
        ki, ks, kh, nf, _ss, _tie = asg.compact_candidates(
            asg.pend_view(s, rr), rr, s.node_idle, s.node_releasing, s.quanta, config, n0=n0)
        payload[(i, j)] = torch.cat([ks, kh, ki, nf[:, None]], dim=1)
    dev0 = grid.dev0
    skey_c = _psum(acct, "per_solve", fresh, dev0)
    changed0 = changed.to(dev0)
    rows_m0 = pend_rows[:M].to(dev0)
    skey_c = torch.where((changed0 >= 0)[None, :], skey_c, asg._I32_MIN)
    hash_c = tie_break_hash_rows(rows_m0.clamp(min=0), changed0.clamp(min=0))
    ri, rs, rh, n_feas = _merge_candidates(grid, acct, payload, Pi, W)
    ni, ns, nh, trunc, eroded = asg.warm_refresh_table(
        t_idx, t_skey, t_hash, t_trunc, row_map.to(dev0), rows_m0, changed0, skey_c, hash_c,
        ri, rs, rh, n_feas > W, rerank_slots.to(dev0), grid.N, k_min)
    res = _compact_rounds(grid, acct, pend_rows, config, ni, ns, nh, trunc)
    return res, (ni, ns, nh, trunc), eroded


# --------------------------------------------------------------------------
# evict (reclaim / preempt)
# --------------------------------------------------------------------------


def evict_shard_map(ss, config):
    """``(EvictResult, rounds)``: per position the [T_blk, N_loc] bids
    against the per-(queue, local node) victim capacity built from the
    replicated task vectors, the winners combined, the rounds' tail on the
    first device."""
    grid = _Grid(ss)
    acct = Collectives(ss.mesh, "evict")
    preempt = config.mode == "preempt"
    T_blk, N_loc = grid.T_blk, grid.N_loc
    blocks = []
    for i, j, d, s, t0, n0 in grid.cells:
        view = _block_view(s, t0, T_blk, grid.ts)
        Q = s.queue_weight.shape[0]
        tq = s.job_queue[s.task_job.long()].long()
        tq_blk = view.job_queue[view.task_job.long()].long()
        blocks.append(dict(
            i=i, j=j, d=d, s=s, t0=t0, n0=n0, view=view, Q=Q,
            static_ok=static_predicates(view), score=score_matrix(view, config.weights),
            tie=_tie_break_hash(T_blk, N_loc, t0=t0, n0=n0, device=d),
            tq=tq.clamp(0, Q - 1), tq_blk=tq_blk.clamp(0, Q - 1),
            q_ok=(tq_blk >= 0) & (tq_blk < Q),
            vnode=s.task_node.long() - n0))

    def bids(victim_ok, claimant_ok):
        acct.rounds += 1
        best_b, has_b = [], []
        for row in range(grid.ts):
            payload = {}
            for b in blocks:
                if b["i"] != row:
                    continue
                s, d, R = b["s"], b["d"], b["s"].task_req.shape[1]
                vo = acct.move(victim_ok, d)
                vnode = b["vnode"]
                in_shard = (vnode >= 0) & (vnode < N_loc)
                vreq = torch.where((vo & in_shard)[:, None], s.task_resreq, 0.0)
                vn = vnode.clamp(0, N_loc - 1)
                tot_v = asg._segment_sum(vreq, torch.where(vo & in_shard, vnode, N_loc),
                                         N_loc + 1)[:N_loc]
                per_qn = asg._segment_sum(vreq, b["tq"] * N_loc + vn,
                                          b["Q"] * N_loc).view(b["Q"], N_loc, R)
                cap = per_qn if preempt else tot_v[None] - per_qn
                capq = cap + s.quanta
                co = acct.move(claimant_ok[b["t0"]:b["t0"] + T_blk], d)
                feas = b["static_ok"] & (co & b["q_ok"])[:, None]
                req = b["view"].task_req
                for r in range(R):
                    feas &= req[:, r, None] <= capq[:, :, r][b["tq_blk"]]
                masked = torch.where(feas, b["score"], NEG)
                lval, lkey, lidx, _pick = _local_best(masked, b["tie"], b["n0"])
                payload[(b["i"], b["j"])] = (lval, lkey, lidx, None)
            vmax, best = _combine_best(acct, payload, grid.dev0, row, count=row == 0)
            best_b.append(best)
            has_b.append(vmax > NEG)
        return _gather_tasks(acct, best_b), _gather_tasks(acct, has_b)

    fia = None
    if config.idle_gate and not preempt:
        blocks_fia = []
        for row in range(grid.ts):
            any_l = {(b["i"], b["j"]): (fits(b["view"].task_req, b["s"].node_idle, b["s"].quanta)
                                        & b["static_ok"]).any(dim=1).to(i32)
                     for b in blocks if b["i"] == row}
            blocks_fia.append(_psum(acct, "per_solve", any_l, grid.dev0, row) > 0)
        fia = _gather_tasks(acct, blocks_fia)
    return evi.evict_rounds(grid.base, config, bids, fia, n_nodes=grid.N)


# --------------------------------------------------------------------------
# fit-error histograms
# --------------------------------------------------------------------------


def _hist_block(view, s):
    static_ok = static_predicates(view)
    fit = fits(view.task_req, s.node_idle, s.quanta) | fits(view.task_req, s.node_releasing,
                                                             s.quanta)
    return failure_histogram(view, static_ok, fit)


def failure_histogram_shard_map(ss):
    """[T, N_REASONS] i32: per-position partial counts, one exact sum over
    the node shards, the task blocks concatenated."""
    grid = _Grid(ss)
    acct = Collectives(ss.mesh, "histogram")
    blocks = []
    for row in range(grid.ts):
        part = {(i, j): _hist_block(_block_view(s, t0, grid.T_blk, grid.ts), s)
                for i, j, _d, s, t0, _n0 in grid.cells if i == row}
        blocks.append(_psum(acct, "per_solve", part, grid.dev0, row))
    if len(blocks) == 1:
        return blocks[0]
    out = torch.cat(blocks)
    acct.note("per_solve", "all_gather", out)
    return out


def failure_histogram_bucket_shard_map(ss, pend_rows):
    """The histogram on the [P] pending bucket (1-D meshes): per-shard
    [P, N_loc] partial counts, one sum, scattered back to the [T] axis."""
    from kube_batch_tpu_torch.ops.feasibility import N_REASONS

    grid = _Grid(ss)
    acct = Collectives(ss.mesh, "histogram_bucket")
    part = {}
    for i, j, d, s, _t0, _n0 in grid.cells:
        part[(i, j)] = _hist_block(asg.pend_view(s, pend_rows.to(d)), s)
    h = _psum(acct, "per_solve", part, grid.dev0)
    rows0 = pend_rows.to(grid.dev0)
    scat = torch.where(rows0 >= 0, rows0, grid.T).long()
    out = torch.zeros((grid.T + 1, N_REASONS), dtype=i32, device=grid.dev0)
    return out.index_copy_(0, scat, h)[:grid.T]


# --------------------------------------------------------------------------
# the what-if probe
# --------------------------------------------------------------------------


def probe_shard_map(ss, batch, probe_rows, config, evict_config, with_evictions: bool):
    """The batched what-if probe over the mesh (``ops/probe.py``): per node
    shard the gang's [G, N_loc] blocks — static predicates, scores, K1 at
    the probe's rows, eviction bids, histogram partials — combined as the
    allocate solve's are; everything after the blocks is the
    single-device probe's machinery, on the first device.  A 2-D mesh's
    task axis is not used (a gang's rows are few)."""
    from kube_batch_tpu_torch.ops import probe as prb

    grid = _Grid(ss)
    acct = Collectives(ss.mesh, "probe")
    dev0 = grid.dev0
    cells = [c for c in grid.cells if c[0] == grid.row0]
    N_loc = grid.N_loc
    s0 = grid.base
    idle0 = grid.node_column(acct, "node_idle")
    rel0 = grid.node_column(acct, "node_releasing")
    used0 = grid.node_column(acct, "node_used")
    # the admission budget: per-shard used sums, then the sum over shards
    used = _psum(acct, "per_solve", {
        (i, j): torch.where(s.node_valid[:, None], s.node_used, 0.0).sum(dim=0)
        for i, j, _d, s, _t, _n in cells}, dev0, grid.row0)
    oc_idle = (s0.total * prb.OVERCOMMIT_FACTOR - used).clamp(min=0.0)
    victim_base = prb._victim_base(s0, evict_config) if with_evictions else None
    rows_d = {c[2]: probe_rows.to(device=c[2], dtype=i32) for c in cells}
    ties = {(i, j): tie_break_hash_rows(rows_d[d], torch.arange(N_loc, dtype=i32, device=d) + n0)
            for i, j, d, _s, _t, n0 in cells}

    Q = s0.queue_valid.shape[0]
    J = s0.job_min_avail.shape[0]
    T = s0.task_req.shape[0]
    G = batch.req.shape[1]
    out = []
    for bi in range(batch.req.shape[0]):
        gangs = {}
        for d in {c[2] for c in cells} | {dev0}:
            gangs[d] = prb.ProbeBatch(*(f[bi].to(d) for f in batch))
        g0 = gangs[dev0]
        view0 = prb._gang_view(s0, g0.req, g0.valid, g0.min_avail, g0.queue, g0.prio,
                               g0.sel_bits, g0.sel_impossible, g0.tol_bits)
        blocks = []
        for i, j, d, s, _t0, n0 in cells:
            g = gangs[d]
            view = prb._gang_view(s, g.req, g.valid, g.min_avail, g.queue, g.prio,
                                  g.sel_bits, g.sel_impossible, g.tol_bits)
            blocks.append((i, j, d, s, n0, g, view, static_predicates(view),
                           score_matrix(view, config.weights)))

        def head(idle_g, rel_g, pending, blocks=blocks):
            acct.rounds += 1
            payload = {}
            for i, j, d, s, n0, g, view, ok, score in blocks:
                pick, val, hsh, chose = masked_best_node_raw(
                    score, ok, view.task_req, acct.move(idle_g[n0:n0 + N_loc], d),
                    acct.move(rel_g[n0:n0 + N_loc], d), acct.move(pending, d), s.quanta,
                    n0=n0, rows=rows_d[d])
                payload[(i, j)] = (val, hsh.to(i32), pick + n0, chose.to(i32))
            vmax, best, chose = _combine_best(acct, payload, dev0, grid.row0)
            return best, vmax > NEG, chose > 0

        res = asg.allocate_rounds(view0, config, head, idle0, rel0, used0)
        feasible = (~view0.task_pending | (res.assigned >= 0)).all() & view0.task_pending.any()
        reasons = _psum(acct, "per_solve", {
            (i, j): failure_histogram(view, ok, fits(view.task_req, s.node_idle, s.quanta)
                                      | fits(view.task_req, s.node_releasing, s.quanta))
            for i, j, d, s, n0, g, view, ok, score in blocks}, dev0, grid.row0)
        q1 = g0.queue.clamp(0, Q - 1).long().reshape(1)  # not 0-d: no readback
        queue_known = (g0.queue >= 0) & (g0.queue < Q) & s0.queue_valid[q1][0]
        enqueue_ok = prb._admission_verdict(
            oc_idle, s0.quanta, g0.min_res, g0.has_min_res,
            s0.queue_alloc[q1][0], s0.queue_capability[q1][0], queue_known)
        if with_evictions:
            def bid_fn(claimant_ok, cap, blocks=blocks):
                payload = {}
                for i, j, d, s, n0, g, view, ok, score in blocks:
                    feas = (ok & acct.move(claimant_ok, d)[:, None]
                            & fits(g.req, acct.move(cap[n0:n0 + N_loc], d), s.quanta))
                    lval, lkey, lidx, _pick = _local_best(torch.where(feas, score, NEG),
                                                          ties[(i, j)], n0)
                    payload[(i, j)] = (lval, lkey, lidx, None)
                vmax, best = _combine_best(acct, payload, dev0, grid.row0)
                return best, vmax > NEG

            claim_node, victims, evict_ok = prb._evict_probe(
                s0, g0.req, view0.task_pending, g0.queue, g0.min_avail, res.assigned,
                bid_fn, evict_config, victim_base, n_nodes=grid.N)
        else:
            claim_node = torch.full((G,), -1, dtype=i32, device=dev0)
            victims = torch.zeros(T, dtype=torch.bool, device=dev0)
            evict_ok = torch.zeros((), dtype=torch.bool, device=dev0)
        out.append(prb.ProbeResult(
            assigned=res.assigned, pipelined=res.pipelined, committed=res.committed[J],
            feasible=feasible, reasons=reasons, enqueue_ok=enqueue_ok,
            claim_node=claim_node, victims=victims, evict_covered=evict_ok))
    return prb.ProbeResult(*(torch.stack([r[k] for r in out])
                             for k in range(len(prb.ProbeResult._fields))))
