"""Drive kube_batch_tpu_torch's allocate solve on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds both CUDA kernels from ``kube_batch_tpu_torch/csrc`` with nvcc,
holds each against its plain PyTorch version at the main path's shapes
(bit-exact: the tolerance is zero) — K1 at round 0 and at a late round
with a tenth of the rows pending, K2 at both bucket sizes — and at their
corners: ragged blocks at a nonzero origin, odd N with no row start
aligned, rows without a candidate, picks decided by the node index, and
-0.0 scores.  It times each main-path case against its bound
(``kube_batch_tpu_torch/testing/kernel_bench.py``), carries the CPU ↔ CUDA parity of the
whole solve at a mid size, then runs the allocate solve at the size users
run — 50 000 pods × 5 000 nodes, gangs of 4 over 3 queues, DRF and
proportion on — through the full and the compacted program, checking the
ledger and gang invariants, determinism, and that the two programs agree.
Each phase prints one JSON line; any failure raises (non-zero exit).  The
last three lines are the kernels' summary, the card's name and power
limit, and ``{"ok": true, "device": ...}``.

Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from kube_batch_tpu_torch.testing.kernel_bench import (
    index_decided_rows, k1_bound, k1_case, k2_bound, k2_case, late_round,
    nvidia_smi, offset_copy, run_case, same,
)

N_TASKS, N_NODES, GANG, N_QUEUES = 50_000, 5_000, 4, 3
MID_TASKS, MID_NODES = 4096, 1024
TOPK = 32


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device():
    smi = nvidia_smi()
    if torch.cuda.device_count() < 1:
        fail("no CUDA device")
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build():
    from kube_batch_tpu_torch.ops import _build

    info = _build.build(force=True)
    _build.load_library()
    emit("build", seconds=info.seconds, library=str(info.path.name),
         ptxas=info.ptxas)


def phase_kernels(snap):
    from kube_batch_tpu_torch.ops import kernels
    from kube_batch_tpu_torch.ops.assignment import score_matrix, static_predicates
    from kube_batch_tpu_torch.ops.scoring import ScoreWeights

    k1_kernel = (kernels.masked_best_node_raw, kernels.masked_best_node_raw_plain)
    k2_kernel = (kernels.masked_topk_blocks, kernels.masked_topk_blocks_plain)
    score = score_matrix(snap, ScoreWeights())
    static_ok = static_predicates(snap)
    T, N = score.shape
    report = {}

    def timed(name, kernel, inp, reps, plain_reps, bound_fn):
        r = run_case(*kernel, inp, reps, plain_reps)
        b_ms, b_by = bound_fn(inp)
        key = "score" if "score" in inp else "score_static"
        report[name] = dict(shape=list(inp[key].shape), **r, bound_ms=b_ms,
                            bound_by=b_by, bound_fraction=b_ms / r["ms"])

    def checked(name, kernel, inp, **info):
        r = run_case(*kernel, inp, reps=1)
        key = "score" if "score" in inp else "score_static"
        report[name] = dict(shape=list(inp[key].shape), **info,
                            max_abs_err=r["max_abs_err"])

    # K1 at the main path's round-0 inputs, and at a late round
    k1 = k1_case(snap, score, static_ok)
    timed("K1", k1_kernel, k1, 20, 3, k1_bound)
    # the homogeneous round 0 scores every node alike, so many picks are
    # decided by the hash, and some by the node index alone
    decided = index_decided_rows(k1)
    if decided == 0:
        fail("K1: no row of the round-0 inputs is decided by the node index")
    report["K1"]["index_decided_rows"] = decided
    late = late_round(k1)
    timed("K1_late_round", k1_kernel, late, 20, 3, k1_bound)
    report["K1_late_round"]["pending_rows"] = int(late["pending"].sum())
    del k1, late
    # K1 on a ragged block at a nonzero global origin
    k1r = k1_case(snap, score, static_ok, t0=1000, n0=333,
                  rows=slice(1000, 1000 + 4099), cols=slice(333, 333 + 1021))
    checked("K1_ragged_offset", k1_kernel, k1r, t0=1000, n0=333)
    # odd N with no row start aligned, wide enough for the vector body
    k1u = k1_case(snap, score, static_ok, t0=7, n0=3, rows=slice(7, 1007),
                  cols=slice(3, 3 + 5117))
    k1u["score"] = offset_copy(k1u["score"])
    k1u["static_ok"] = offset_copy(k1u["static_ok"])
    checked("K1_odd_n_unaligned", k1_kernel, k1u, t0=7, n0=3)
    # rows with no candidate: none pending, and pending but all infeasible
    k1n = k1_case(snap, score, static_ok, rows=slice(0, 4096))
    checked("K1_all_non_pending", k1_kernel,
            dict(k1n, pending=torch.zeros_like(k1n["pending"])))
    checked("K1_all_infeasible", k1_kernel,
            dict(k1n, static_ok=torch.zeros_like(k1n["static_ok"])))
    del k1r, k1u, k1n, score, static_ok

    # K2 at the compacted solve's bucket sizes, plus ragged node blocks
    for P in (8192, T):
        timed(f"K2_P{P}", k2_kernel, k2_case(snap, P), 10, 2, k2_bound)
    k2r = k2_case(snap, 1000, n_cols=1000)
    k2r["rows"] = k2r["rows"] + 17
    checked("K2_ragged_offset", k2_kernel, dict(k2r, n0=24), n0=24)
    k2u = k2_case(snap, 1000)
    cols = slice(3, 3 + 5117)
    k2u = dict(k2u, score_static=offset_copy(k2u["score_static"][:, cols]),
               idle=k2u["idle"][cols].contiguous(),
               releasing=k2u["releasing"][cols].contiguous(), n0=3)
    checked("K2_odd_n_unaligned", k2_kernel, k2u, n0=3)
    # -0.0 cells key as +0.0
    k2z = k2_case(snap, 1000)
    ss = k2z["score_static"]
    gen = torch.Generator(device=ss.device).manual_seed(0)
    zero = (torch.rand(ss.shape, generator=gen, device=ss.device) < 0.05) & (
        ss > kernels.NEG)
    k2z["score_static"] = torch.where(zero, -0.0, ss)
    if not (k2z["score_static"] == 0).logical_and(
            torch.signbit(k2z["score_static"])).any():
        fail("K2: the -0.0 case holds no -0.0 cell")
    checked("K2_negative_zero", k2_kernel, k2z,
            negative_zero_cells=int(zero.sum()))
    emit("kernels", tolerance="bit-exact", **report)
    return report


def phase_cross_device():
    """The whole solve on the CPU (plain versions) and on the card
    (kernels) at a mid size: every AllocateResult field bit-exact."""
    from kube_batch_tpu_torch.ops import kernels
    from kube_batch_tpu_torch.ops.assignment import (
        AllocateConfig, allocate_solve, allocate_topk_solve,
    )
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    out = {}
    for frac in (0.0, 0.3):
        kw = dict(n_tasks=MID_TASKS, n_nodes=MID_NODES, gang_size=GANG,
                  n_queues=N_QUEUES, gpu_task_frac=frac, seed=1)
        cpu_snap, _ = synthetic_device_snapshot(**kw, device="cpu")
        gpu_snap, _ = synthetic_device_snapshot(**kw, device="cuda")
        rows = torch.nonzero(cpu_snap.task_pending).flatten().to(torch.int32)
        cfg = AllocateConfig()
        cfg_k = cfg._replace(topk=TOPK)
        kernels.reset_launches()
        full_c = allocate_solve(cpu_snap, cfg)
        topk_c = allocate_topk_solve(cpu_snap, rows, cfg_k)
        if any(kernels.launches.values()):
            fail("a CPU solve launched a CUDA kernel")
        full_g = allocate_solve(gpu_snap, cfg)
        topk_g = allocate_topk_solve(gpu_snap, rows.cuda(), cfg_k)
        torch.cuda.synchronize()
        if not kernels.launches["masked_best_node_raw"] or \
                not kernels.launches["masked_topk_blocks"]:
            fail(f"CUDA solves did not launch both kernels: {kernels.launches}")
        for label, a, b in (("full", full_c, full_g), ("topk", topk_c, topk_g)):
            bad = [f for f, x, y in zip(a._fields, a, b) if not same([x], [y])]
            if bad:
                fail(f"cross_device {label} gpu_frac={frac}: {bad} differ")
        out[f"gpu_frac_{frac}"] = dict(
            placed=int((full_g.assigned >= 0).sum()),
            rounds_run=int(full_g.rounds_run),
            topk_exhausted=int(topk_g.topk_exhausted),
        )
    emit("cross_device", shape=[MID_TASKS, MID_NODES], equal="bit-exact",
         **out)


def invariants(snap, res):
    """A plain subset of the JAX package's allocate_invariants: per-node
    used ≤ allocatable + quanta and idle ≥ −quanta on valid nodes; every
    placement is an eligible pending row on a valid node; every committed
    job has ready + its placements ≥ min_available."""
    q = snap.quanta
    nv = snap.node_valid
    over = ((res.node_used > snap.node_alloc + q).any(dim=1) & nv).sum()
    under = ((res.node_idle < -q).any(dim=1) & nv).sum()
    placed = res.assigned >= 0
    tj = snap.task_job.long()
    eligible = (snap.task_pending & snap.task_valid & snap.job_valid[tj]
                & snap.job_schedulable[tj])
    bad_rows = (placed & ~eligible).sum()
    a = res.assigned.long().clamp(min=0)
    bad_nodes = (placed & ~nv[a]).sum()
    J = snap.job_min_avail.shape[0]
    new_alloc = torch.zeros(J, dtype=torch.int32, device=tj.device).index_add_(
        0, tj, (placed & ~res.pipelined).to(torch.int32))
    short = (res.committed
             & (snap.job_ready + new_alloc < snap.job_min_avail)).sum()
    found = dict(nodes_over_alloc=int(over), nodes_idle_negative=int(under),
                 ineligible_placements=int(bad_rows),
                 placements_on_invalid_nodes=int(bad_nodes),
                 committed_jobs_short=int(short))
    if any(found.values()):
        fail(f"invariants violated: {found}")
    return found


def phase_solve_full(snaps, config):
    from kube_batch_tpu_torch.actions.allocate import dispatch_allocate_solve
    from kube_batch_tpu_torch.ops import kernels

    out = {}
    launches = None
    results = {}
    for label, snap in snaps.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t = time.perf_counter()
        res, mode, info = dispatch_allocate_solve(snap, config)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        counts = dict(kernels.launches)
        if launches is None:
            launches = counts
        peak = torch.cuda.max_memory_allocated()
        if info is not None:
            fail(f"{label}: expected the full program, got compaction {info}")
        if counts["masked_best_node_raw"] == 0:
            fail(f"{label}: the full solve never launched K1")
        if counts["masked_best_node_raw"] != int(res.rounds_run):
            fail(f"{label}: K1 launches {counts} != rounds {int(res.rounds_run)}")
        inv = invariants(snap, res)
        # determinism: the same solve again, bit-identical
        t = time.perf_counter()
        again, _, _ = dispatch_allocate_solve(snap, config)
        torch.cuda.synchronize()
        again_ms = (time.perf_counter() - t) * 1e3
        bad = [f for f, x, y in zip(res._fields, res, again) if not same([x], [y])]
        if bad:
            fail(f"{label}: a second run differs in {bad}")
        placed = res.assigned >= 0
        out[label] = dict(
            mode="full", placed=int(placed.sum()),
            pending=int(snap.task_pending.sum()),
            pipelined=int(res.pipelined.sum()),
            committed_jobs=int(res.committed.sum()),
            rounds_run=int(res.rounds_run), wall_ms=wall_ms,
            wall_ms_second_run=again_ms, peak_mem_gib=peak / 2**30,
            launches=counts, invariants=inv, deterministic=True,
        )
        results[label] = res
    emit("solve_full", shape=[N_TASKS, N_NODES], gang=GANG,
         queues=N_QUEUES, **out)
    return results, launches


def phase_solve_topk(snap, config, full):
    from kube_batch_tpu_torch.ops import kernels
    from kube_batch_tpu_torch.ops.assignment import allocate_topk_solve

    T = snap.task_req.shape[0]
    rows = torch.nonzero(snap.task_pending).flatten().to(torch.int32)
    pend_rows = torch.full((T,), -1, dtype=torch.int32, device=rows.device)
    pend_rows[: rows.numel()] = rows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.perf_counter()
    res = allocate_topk_solve(snap, pend_rows, config._replace(topk=TOPK))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    counts = dict(kernels.launches)
    if counts["masked_topk_blocks"] == 0:
        fail("the compacted solve never launched K2")
    bad = [f for f, x, y in zip(res._fields, res, full)
           if not f.startswith("topk_") and not same([x], [y])]
    if bad:
        fail(f"compacted solve differs from the full solve in {bad}")
    emit("solve_topk", bucket=T, k=TOPK, wall_ms=wall_ms,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         placed=int((res.assigned >= 0).sum()),
         topk_exhausted=int(res.topk_exhausted),
         topk_reentries=int(res.topk_reentries),
         launches=counts, equal_to_full="bit-exact")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    smi = phase_device()
    phase_build()
    main_kw = dict(n_tasks=N_TASKS, n_nodes=N_NODES, gang_size=GANG,
                   n_queues=N_QUEUES, seed=0, device="cuda")
    snap, _meta = synthetic_device_snapshot(**main_kw)
    kern = phase_kernels(snap)
    phase_cross_device()
    config = AllocateConfig()
    snaps = {"homogeneous": snap,
             "gpu_gangs": synthetic_device_snapshot(**main_kw,
                                                    gpu_task_frac=0.3)[0]}
    full, full_launches = phase_solve_full(snaps, config)
    del snaps["gpu_gangs"]
    topk_launches = phase_solve_topk(snap, config, full["homogeneous"])

    src = "kube_batch_tpu_torch/csrc/"
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    k1, k1_late = kern["K1"], kern["K1_late_round"]
    k2 = kern[f"K2_P{snap.task_req.shape[0]}"]
    summary = [
        dict(name="masked_best_node_raw", route="cuda",
             source=src + "best_node.cu",
             replaces="kube_batch_tpu/ops/pallas_kernels.py:52",
             launches=full_launches["masked_best_node_raw"],
             **{f: k1[f] for f in fields}, library_ms=None,
             late_round_ms=k1_late["ms"],
             late_round_bound_ms=k1_late["bound_ms"],
             late_round_pending_rows=k1_late["pending_rows"]),
        dict(name="masked_topk_blocks", route="cuda",
             source=src + "topk_blocks.cu",
             replaces="kube_batch_tpu/ops/pallas_kernels.py:216",
             launches=topk_launches["masked_topk_blocks"],
             **{f: k2[f] for f in fields}, library_ms=None),
    ]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
