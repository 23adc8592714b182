"""Tier C: peak device memory, task × node planes, in-place allocations and
node-scaled per-round moves of every registered device program, at a
ladder of shape points.

Mirrors ``kube_batch_tpu/analysis/hbm_audit.py`` with its rule ids, its
ladder and its allowlist.  The JAX tier traces each program abstractly and
walks the jaxpr's liveness; here each program runs on real tensors at the
point (``program_audit.run_entry``) and what it did is read:

- **peak bytes**: on a card ``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats`` (every tensor on the card counts, the
  program's inputs and whatever else the process holds); on the CPU the
  recorder's live bytes (inputs included, freed storages subtracted);
- **task × node planes**: every op output with one task-scale dimension
  (T, P, or T over a shard count) and one node-scale dimension (N or N
  over a shard count), classified as the JAX tier classifies, which needs
  a point whose extents are distinct;
- **in-place allocations**: the storages the call allocated, against the
  declared resident tensors' size;
- **per-round moves**: the sharded bodies' collectives and the moves of
  the tail back to each position (``parallel/shard_solve.Collectives``),
  each with its shape and round.

Rules (``HBM_RULES``): KBT201 the peak is over the budget; KBT202 a steady
program made a task × node plane; KBT203 a declared in-place update
allocated a buffer of the resident's size; KBT204 a move between mesh
positions inside the round loop carries the node axis.  Suppressions are
``HBM_ALLOWLIST`` entries ``(entry glob, rule, point glob) → reason``; a
reason is mandatory, and an entry that matched nothing, where its entries
and points ran, is itself a finding (the burn-down list cannot keep a
waiver whose corner is fixed).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from kube_batch_tpu_torch.analysis.findings import Finding
from kube_batch_tpu_torch.device import resolve_device

#: the JAX package's tier-C ids (``hbm_audit.HBM_RULES``), with what each
#: checks in the port
HBM_RULES = {
    "KBT201": "measured peak device bytes over the budget at a shape point",
    "KBT202": "task-axis × node-axis tensor in a steady-path program",
    "KBT203": "declared in-place update allocated a buffer of the resident's size",
    "KBT204": "per-round move between mesh positions carrying the node axis",
}

GIB = 2**30

#: the JAX package's TPU profiles, GiB per device: accepted by name in
#: ``KB_HBM_BUDGET``, never the port's default
BUDGET_PROFILES: Dict[str, float] = {"v5e": 16.0, "v6e": 32.0, "v5p": 95.0}
#: the port's card when none is present (the CPU): an H100's 80 GB
H100_BYTES = 80 * 10**9


def budget_bytes(device=None) -> Tuple[int, str]:
    """(budget in bytes, label).  ``KB_HBM_BUDGET`` overrides as the JAX
    package reads it: a profile name or a GiB number; anything unparsable
    keeps the default, which is the card's own ``total_memory`` (an
    H100's 80 GB where no card is given), so the audit never relaxes."""
    raw = os.environ.get("KB_HBM_BUDGET", "").strip()
    if raw:
        if raw in BUDGET_PROFILES:
            return int(BUDGET_PROFILES[raw] * GIB), raw
        try:
            return int(float(raw) * GIB), f"{raw} GiB (KB_HBM_BUDGET)"
        except ValueError:
            pass
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return int(props.total_memory), props.name
    return H100_BYTES, "H100 80 GB"


# --------------------------------------------------------------------------
# the shape ladder
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapePoint:
    """One point of the ladder: the extents every entry runs at.  The
    fields up to ``scatter_rows`` are the JAX package's
    (``kube_batch_tpu/analysis/jaxpr_audit.py`` ``ShapePoint``); ``floor``
    is the noise floor below which an extent is not read as a task or node
    axis (the JAX tier's fixed 256).  A smaller floor needs a point whose
    axis extents are distinct from every other extent the programs make."""

    name: str
    tasks: int
    nodes: int
    T: int
    N: int
    J: int
    Q: int
    R: int
    W: int
    K_aff: int
    P: int
    topk: int
    warm_w: int
    warm_c: int
    warm_pi: int
    probe_b: int = 2
    probe_g: int = 4
    scatter_rows: int = 64
    floor: int = 256


def shape_point(name: str, tasks: int, nodes: int, R: int = 8, W: int = 4) -> ShapePoint:
    """A ladder point from pod and node counts with the production sizing:
    capacity buckets, the largest pending bucket ≤ T // 4, the default
    candidate width and the warm plan's width, changed-node slots and
    re-rank rung (the JAX package's arithmetic, on the port's constants)."""
    from kube_batch_tpu_torch.actions.allocate import TOPK_DEFAULT, TOPK_PEND_BUCKETS
    from kube_batch_tpu_torch.api.resident import (
        WARM_CHANGED_BUCKETS,
        WARM_WIDTH_MARGIN,
        warm_rerank_rungs,
    )
    from kube_batch_tpu_torch.api.snapshot import bucket

    T, N = bucket(tasks), bucket(nodes)
    J = bucket(max(8, tasks // 4))
    fit = [b for b in TOPK_PEND_BUCKETS if b <= T // 4]
    P = fit[-1] if fit else TOPK_PEND_BUCKETS[0]
    k = TOPK_DEFAULT
    changed = [c for c in WARM_CHANGED_BUCKETS if c < N]
    warm_c = changed[-1] if changed else WARM_CHANGED_BUCKETS[0]
    return ShapePoint(
        name=name, tasks=tasks, nodes=nodes, T=T, N=N, J=J, Q=8, R=R, W=W,
        K_aff=4, P=P, topk=k, warm_w=k + WARM_WIDTH_MARGIN, warm_c=warm_c,
        warm_pi=warm_rerank_rungs(P)[-1], probe_b=2, probe_g=4, scatter_rows=N,
    )


_POINTS: Optional[Tuple[ShapePoint, ...]] = None


def shape_points() -> Tuple[ShapePoint, ...]:
    """The JAX package's ladder: the bench's scale, the 50k × 5k headline
    and the 1M × 100k north star."""
    global _POINTS
    if _POINTS is None:
        _POINTS = (
            shape_point("bench-20k", 20_000, 2_000),
            shape_point("headline-50k", 50_000, 5_000),
            shape_point("northstar-1m", 1_000_000, 100_000),
        )
    return _POINTS


def points_for(device) -> Tuple[ShapePoint, ...]:
    """The points a run on ``device`` reaches: on a card the ladder but the
    north star (one [T, N] f32 plane there is 400 GB), on the CPU the
    audit point (the ladder's planes would take minutes there)."""
    from kube_batch_tpu_torch.analysis.program_audit import AUDIT_POINT

    if torch.device(device).type == "cuda":
        return shape_points()[:2]
    return (AUDIT_POINT,)


# --------------------------------------------------------------------------
# axis classification (the JAX tier's, with the point's floor)
# --------------------------------------------------------------------------

#: the shard counts the audit meshes can make
_SHARD_DIVS = (2, 4, 8)


def axis_dims(sp: ShapePoint) -> Tuple[Set[int], Set[int]]:
    """(task-scale extents, node-scale extents) at ``sp``: T, P and T over a
    shard count; N and N over a shard count; minus every extent another
    axis shares, and minus what is under the floor."""
    task = {sp.T, sp.P} | {sp.T // d for d in _SHARD_DIVS if sp.T % d == 0}
    node = {sp.N} | {sp.N // d for d in _SHARD_DIVS if sp.N % d == 0}
    ambiguous = {sp.J, sp.Q, sp.R, sp.W, sp.K_aff, sp.topk, sp.warm_w,
                 sp.warm_c, sp.probe_b, sp.probe_g}
    task = {d for d in task if d >= sp.floor} - ambiguous - node
    node = {d for d in node if d >= sp.floor} - ambiguous - {sp.T, sp.P}
    return task, node


def dim_label(d: int, sp: ShapePoint) -> str:
    names = {sp.T: "T", sp.N: "N", sp.P: "P", sp.J: "J"}
    if d in names:
        return f"{names[d]}={d}"
    for base, tag in ((sp.T, "T"), (sp.N, "N"), (sp.P, "P")):
        for s in _SHARD_DIVS:
            if base % s == 0 and d == base // s:
                return f"{tag}/{s}={d}"
    return str(d)


def _fmt_shape(shape, sp: ShapePoint) -> str:
    return "[" + ", ".join(dim_label(int(d), sp) for d in shape) + "]"


def task_node_planes(rec, sp: ShapePoint) -> List[Tuple[str, str, Tuple[int, ...], int]]:
    """The recorded outputs with a task-scale and a node-scale dimension:
    (op, dtype, shape, count)."""
    task, node = axis_dims(sp)
    if not task or not node:
        return []
    out = []
    for (op, dtype, shape), n in rec.outputs.items():
        if len(shape) >= 2 and any(d in task for d in shape) and any(d in node for d in shape):
            out.append((op, dtype, shape, n))
    return out


def _fmt_bytes(b: int) -> str:
    if b >= GIB:
        return f"{b / GIB:.2f} GiB"
    return f"{b / 2**20:.1f} MiB"


# --------------------------------------------------------------------------
# per entry and point
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EntryReport:
    """One (entry, point) result: the measured numbers and the raw findings
    (allowlist not yet applied)."""

    entry: str
    point: str
    steady: bool
    traced: bool
    peak_bytes: int = 0
    base_bytes: int = 0
    budget: int = 0
    planes: int = 0
    syncs: int = 0
    rounds: int = 0
    transfers: int = 0
    round_move_bytes: int = 0
    findings: List[Tuple[str, str]] = dataclasses.field(default_factory=list)


def audit_entry_at(entry, sp: ShapePoint, device=None, budget: Optional[int] = None,
                   label: Optional[str] = None, runs: Optional[Dict] = None) -> EntryReport:
    """Run one entry at one point on ``device`` (None: the card, which
    raises without one), reusing ``runs`` (see
    ``program_audit.cached_run``), and apply KBT201–204.  A build or run
    failure is a KBT000 finding that names the point."""
    from kube_batch_tpu_torch.analysis.program_audit import cached_run

    device = resolve_device(device)
    if budget is None:
        budget, label = budget_bytes(device)
    rep = EntryReport(entry=entry.name, point=sp.name, steady=entry.steady,
                      traced=False, budget=budget)
    run = cached_run(runs, entry, sp, device)
    if run.error:
        rep.findings.append((
            "KBT000", f"entry point failed to run at shape point {sp.name} "
                      f"(T={sp.T}, N={sp.N}): {run.error}"))
        return rep
    rep.traced = True
    rec = run.rec
    rep.peak_bytes = run.peak_bytes
    rep.base_bytes = run.base_bytes
    rep.syncs, rep.rounds, rep.transfers = len(rec.syncs), rec.rounds, len(rec.transfers)

    if run.peak_bytes > budget:
        rep.findings.append((
            "KBT201",
            f"peak bytes {_fmt_bytes(run.peak_bytes)} exceed the {label or 'device'} "
            f"budget {_fmt_bytes(budget)} at shape point {sp.name} (T={sp.T}, "
            f"N={sp.N}) — {run.peak_bytes / budget:.1f}x over"))

    planes = task_node_planes(rec, sp)
    rep.planes = sum(n for *_x, n in planes)
    if entry.steady and planes:
        sample = "; ".join(f"{op} -> {dt}{_fmt_shape(s, sp)}" for op, dt, s, _n in planes[:3])
        rep.findings.append((
            "KBT202",
            f"{rep.planes} task-axis × node-axis temporar"
            f"{'y' if rep.planes == 1 else 'ies'} in a steady-path program at "
            f"{sp.name} (e.g. {sample}) — the steady dispatch contract is the "
            "compacted [P, K] candidate geometry"))

    if entry.in_place and run.resident_bytes:
        big = [n for n in rec.allocations if n >= min(run.resident_bytes)]
        if big:
            rep.findings.append((
                "KBT203",
                f"a declared in-place update of {', '.join(entry.in_place)} allocated "
                f"{len(big)} buffer(s) of the resident's size or more "
                f"({_fmt_bytes(max(big))} against {_fmt_bytes(min(run.resident_bytes))}) "
                "— the in-place contract's saving did not happen"))

    _task, node = axis_dims(sp)
    rounds = max(1, max((s["round"] for s in run.sites), default=0))
    per_round = [s for s in run.sites if s["phase"] == "per_round"]
    rep.round_move_bytes = sum(s["bytes"] for s in per_round if s["kind"] == "move") // rounds
    node_sites = [s for s in per_round if any(int(d) in node for d in s["shape"])]
    if node_sites:
        kinds = sorted({(s["kind"], s["shape"], s["bytes"]) for s in node_sites})
        parts = [f"{k}[{_fmt_shape(shape, sp)}] = {b:,} B" for k, shape, b in kinds[:4]]
        total = sum(s["bytes"] for s in node_sites)
        rep.findings.append((
            "KBT204",
            f"{len(node_sites)} per-round move(s) with node-axis payloads at "
            f"{sp.name} over {rounds} round(s), {total // rounds:,} B a round: "
            f"{'; '.join(parts)} — the cross-device contract is O(tasks) bytes "
            "per bidding round"))
    return rep


# --------------------------------------------------------------------------
# allowlist: (entry glob, rule, point glob) → mandatory reason
# --------------------------------------------------------------------------

#: The JAX package's waivers where the port's programs need them, and the
#: port's own.  Every reason names the ``ROADMAP.md`` item that removes it.
HBM_ALLOWLIST: Dict[Tuple[str, str, str], str] = {
    # -- ROADMAP 1.(1) of the JAX package: evict scores full [T, N] bids ---
    ("ops.eviction.evict_solve[*]", "KBT202", "*"):
        "ROADMAP 1.(1): eviction scores full [T, N] bid planes; the "
        "candidate-table + warm-carry rebuild over per-(queue, node) "
        "capacity keys is the planned fix",
    ("ops.invariants.evict_sentinel_solve[*]", "KBT202", "*"):
        "ROADMAP 1.(1): sentinel-fused evict inherits the bare solve's "
        "full-matrix bid planes",
    ("parallel.mesh.*sharded_evict_solve[*]", "KBT202", "*"):
        "ROADMAP 1.(1): sharded evict (both impls, sentinel-fused "
        "included) shards the bid planes over nodes but still holds "
        "[T, N/shards] per position",
    # -- ROADMAP 1.(2): the compacted path's table build and exhaustion
    #    fallback keep [P, N] planes ---------------------------------------
    ("ops.assignment.allocate_topk_solve", "KBT202", "*"):
        "ROADMAP 1.(2): the candidate-table build scores [P, N] planes "
        "(and the exhaustion fallback re-enters them); blocked table "
        "rebuild is the planned fix",
    ("ops.invariants.allocate_topk_sentinel_solve", "KBT202", "*"):
        "ROADMAP 1.(2): sentinel-fused topk inherits the table build's "
        "[P, N] planes",
    ("parallel.mesh.*sharded_allocate_topk_solve[*]", "KBT202", "*"):
        "ROADMAP 1.(2): the sharded topk build holds [P, N/shards] score "
        "and key planes per position (pjit oracle: unsharded [P, N])",
    ("ops.assignment.warm_allocate_solve", "KBT202", "*"):
        "ROADMAP 1.(2): the warm refresh re-ranks its invalidated rows "
        "against every node ([Pi, N] planes, Pi = P at the top rung); same "
        "fix",
    ("ops.invariants.warm_allocate_sentinel_solve", "KBT202", "*"):
        "ROADMAP 1.(2): sentinel-fused warm inherits the re-rank planes",
    ("parallel.mesh.*sharded_warm_allocate_solve[*]", "KBT202", "*"):
        "ROADMAP 1.(2): sharded warm (both impls, sentinel-fused "
        "included) inherits the re-rank planes per position",
    # -- the port's own: the sharded tail's per-round ledger slices --------
    ("parallel.mesh.*sharded_allocate_solve[shard_map*]", "KBT204", "*"):
        "ROADMAP 'sharded cycle on one card': the tail runs once on the "
        "first device and slices its idle and releasing ledgers back to "
        "each position every round, [N/shards, R] each; the JAX tail runs "
        "on every shard and moves none",
    ("parallel.mesh.sharded_probe_solve[shard_map]", "KBT204", "*"):
        "ROADMAP 'sharded cycle on one card': the probe's tail slices its "
        "ledgers and its victim capacity back to each position every "
        "round, as the allocate tail does",
}


def glob_match(name: str, pat: str) -> bool:
    """``*`` matches anything; everything else, brackets included, is
    literal (entry names carry ``[reclaim]``-style tags)."""
    rx = re.escape(pat).replace(r"\*", ".*")
    return re.fullmatch(rx, name) is not None


def _allowlist_reason(allowlist, entry_name: str, rule: str, point: str):
    for key, reason in allowlist.items():
        e_pat, a_rule, p_pat = key
        if a_rule == rule and glob_match(entry_name, e_pat) and glob_match(point, p_pat):
            return key, reason
    return None


def apply_allowlist(reports: Sequence[EntryReport], entry_names: Sequence[str],
                    point_names: Sequence[str], allowlist=None) -> List[Finding]:
    """The findings of ``reports`` less the allowlisted ones, plus a KBT000
    for each waiver without a reason and each stale waiver (one that
    matched nothing although its entries and points ran)."""
    if allowlist is None:
        allowlist = HBM_ALLOWLIST
    findings: List[Finding] = []
    used: Set[Tuple] = set()
    for rep in reports:
        path = f"<memory:{rep.entry}@{rep.point}>"
        for rule, message in rep.findings:
            hit = None if rule == "KBT000" else _allowlist_reason(
                allowlist, rep.entry, rule, rep.point)
            if hit is not None:
                key, reason = hit
                used.add(key)
                if not reason.strip():
                    findings.append(Finding("KBT000", path, 0, 0,
                                            f"allowlist[{key}] has no reason — "
                                            "suppression ignored"))
                continue
            findings.append(Finding(rule, path, 0, 0, message))
    for key, reason in allowlist.items():
        if key in used:
            continue
        e_pat, _rule, p_pat = key
        if (any(glob_match(n, e_pat) for n in entry_names)
                and any(glob_match(n, p_pat) for n in point_names)):
            findings.append(Finding(
                "KBT000", "<memory:allowlist>", 0, 0,
                f"stale allowlist entry {key}: matched no finding — the corner "
                f"it waived is fixed; delete the entry (reason was: {reason})"))
    return findings


# --------------------------------------------------------------------------
# running the tier
# --------------------------------------------------------------------------


def run_memory_audit(registry=None, points: Optional[Sequence[ShapePoint]] = None,
                     device=None, select: Optional[Sequence[str]] = None,
                     allowlist=None, reports: Optional[list] = None,
                     runs: Optional[Dict] = None) -> List[Finding]:
    """Every entry at every point on ``device`` (None: the card, which
    raises without one; default registry: the single-device and sharded
    ones at :func:`points_for`); the allowlisted findings dropped.
    ``reports``, a list, receives each :class:`EntryReport`; ``runs``
    reuses recorded calls."""
    from kube_batch_tpu_torch.analysis.program_audit import default_registry

    device = resolve_device(device)
    if registry is None:
        registry = default_registry(device)
    if points is None:
        points = points_for(device)
    budget, label = budget_bytes(device)
    reps = [audit_entry_at(e, sp, device, budget, label, runs)
            for sp in points for e in registry]
    if reports is not None:
        reports.extend(reps)
    findings = apply_allowlist(reps, [e.name for e in registry],
                               [sp.name for sp in points], allowlist)
    if select is not None:
        wanted = set(select) | {"KBT000"}
        findings = [f for f in findings if f.rule in wanted]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def headroom_report(registry=None, points: Optional[Sequence[ShapePoint]] = None,
                    device=None) -> Dict:
    """Bytes against the budget per entry and point on ``device`` (None:
    the card, which raises without one): the numbers a benchmark sizes
    its cells by."""
    device = resolve_device(device)
    budget, label = budget_bytes(device)
    if points is None:
        points = points_for(device)
    reps: List[EntryReport] = []
    run_memory_audit(registry, points, device, reports=reps)
    entries: Dict[str, Dict[str, Dict]] = {}
    for rep in reps:
        entries.setdefault(rep.entry, {})[rep.point] = {
            "traced": rep.traced,
            "peak_bytes": rep.peak_bytes,
            "base_bytes": rep.base_bytes,
            "headroom_bytes": rep.budget - rep.peak_bytes,
            "over_budget": rep.peak_bytes > rep.budget,
            "syncs": rep.syncs,
            "rounds": rep.rounds,
            "round_move_bytes": rep.round_move_bytes,
            "findings": [r for r, _ in rep.findings],
        }
    return {
        "budget_bytes": budget,
        "budget_profile": label,
        "points": [{"name": sp.name, "tasks": sp.tasks, "nodes": sp.nodes, "T": sp.T,
                    "N": sp.N, "P": sp.P, "topk": sp.topk} for sp in points],
        "entries": entries,
    }
