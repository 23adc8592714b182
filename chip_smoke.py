"""Drive kube_batch_tpu_torch's scheduler on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the three CUDA kernels from ``kube_batch_tpu_torch/csrc`` with nvcc
(one nvcc per source, all at once) and holds each against its plain
PyTorch version at the main path's shapes (bit-exact: the tolerance is
zero) — K1 at round 0 and at a late round with a tenth of the rows
pending, K2 at both bucket sizes, the enqueue gate over 12 500
MinResources rows at capJ 16 384 — and at their corners: ragged blocks at
a nonzero origin, odd N with no row start aligned, rows without a
candidate, picks decided by the node index, -0.0 scores; for the gate,
rows within one quantum of the budget's edge, every row rejected,
non-candidate rows between candidates, thousands of admissions, an
infinite budget.  It times each main-path case against its bound
(``kube_batch_tpu_torch/testing/kernel_bench.py``), carries the CPU ↔ CUDA
parity of the whole allocate solve and of the reclaim and preempt solves
at a mid size, then runs the allocate solve at the size users run —
50 000 pods × 5 000 nodes, gangs of 4 over 3 queues, DRF and proportion
on — through the full and the compacted program, checking the ledger and
gang invariants, determinism, and that the two programs agree.

Then it drives the scheduling cycle through ``Scheduler.run_once`` under
the shipped five-action conf (``kube_batch_tpu_torch/testing/cycle_drive.py``):
the 50 000-pod cluster built through the cache's handlers — cycle 1 with
every pod pending (the full program, K1), cycle 2 after 5 000 pods arrive
in 1 250 gangs carrying MinResources (the compacted program, K2), cycle 3
after enqueue promotes the arrivals cycle 2 left Pending (the admission
gate) — and the overcommitted 60 000-pod cluster, where reclaim evicts
and pipelines and the claimants bind once the victims are gone; after
each cycle the column store, the node ledgers, double binds and every
eviction are checked.  These drives run under the cross-cycle defaults:
the delta session open and close, and device programs reading resident
tensors refreshed by row scatters.

The steady-state drive (``cycle_steady``, ``drive_steady``: the JAX
package's ``bench.py`` ``multicycle_bench``) runs 2 + 4 back-to-back
cycles on the 50 000-pod cluster (the bench's 8 measured cycles cut to 4
for the script's time; ``cycle_drive --steady`` runs 8) — 2 % of the bound gangs complete and
arrivals refill the pod count within ±10 % before each — five times: with
the defaults (delta open and close, resident snapshot, the warm
candidate-table carry, the guard plane), with ``KB_WARM=0`` (cold), with
``KB_GUARD=0`` (noguard), with the four cross-cycle mechanisms off (the
oracle), and pipelined (the defaults, each cycle through
``run_once_pipelined``: its status flush and bind drain on the writeback
worker, the bind drain joined before the kubelet pass); every resident
swap of all but the oracle is held against a fresh upload of its host
snapshot.  Every cycle's decisions must be equal across the legs, the
defaults leg must take the delta open, the scatter path and the warm
merge in every plan after its first, every guarded leg's sentinel
verdicts must be clean, and no writeback stage or bind may fail; one JSON
line per cycle and leg (the warm plan, the table's rungs, exhaustion,
solve ms, syncs, K2 launches; for the pipelined leg its barrier, join,
wall + join and the writeback's own ms), then the p50s of each leg and
the guard's overhead (defaults less noguard).  The loop phase
(``drive_loop``: the JAX package's ``bench.py`` ``pipelined_bench``) runs
``Scheduler.run_forever`` on the warmed 50 000-pod cluster while 20
single-pod gangs arrive at seeded offsets of U(0.15, 0.45) s, once with
``KB_PIPELINE=0`` (a 1 s tick) and once pipelined: every arrival must be
bound exactly once and ``stop()`` must drain; it prints the arrival →
bind-ack latency, the cycles and their wake reasons, and the kernel
launches of each loop.  K2 is also timed at the warm path's re-rank rungs.  The
guard phase (``drive_guard``, 4 096 × 1 024) audits clean cycles against
the full solve, zeroes a resident capacity word in place (the cycle must
fail closed, heal, and the demoted paths re-promote after the cooldown),
sets a Running row's resident pending bit (the host checksum must trip),
and replays the trip's bundle on the card and the CPU.  The feature phase
(``drive_features``) runs the 50 000-pod cluster with PodDisruptionBudget
gangs, claims on a PV ledger (and on missing PVs) and a custom score row:
two exclusive cycles and one isolated, checking the gangs and the ledger,
K1 and K2 held bit-exact on the plane with the row; at 4 096 × 1 024 the
card and the CPU must decide identically.  The headline and
overcommit drives at 4 096 × 1 024 (with host ports) and 2 048 / 1 024 /
256 run with the defaults on the card and as the oracle on the CPU, and
must bind and evict identically.  The what-if phase (``drive_whatif``)
holds K1 at a probe gang's explicit rows against its plain version, checks
the read plane's oracle contract at 50 000 × 5 000 (each probed gang,
submitted alone, binds exactly at its probed nodes; the eviction verdict
evicts exactly its victims), serves 16 clients × 25 requests beside three
live steady cycles, and answers 32 requests identically on the card and
the CPU at 4 096 × 1 024.  The replicate phase (``drive_replicate``)
runs the steady drive at 50 000 × 5 000 without and with a replication
publisher, with the per-cycle checks of every drive; a follower on the
card applies every record and, in the cycles it follows, must answer
four gangs and a sweep as the leader's lease of that record does (its
probes launch K1 on tensors filled from the wire), resync warm after a
dropped frame, get a full frame past a ring of 4 and re-adopt warm on a
restart; at 4 096 × 1 024 a card follower and a CPU follower must answer
32 requests identically.  Each phase prints one JSON line; any
failure raises (non-zero exit).  The last three lines are the kernels'
summary, the card's name and power limit, and ``{"ok": true, "device":
...}``.

Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from kube_batch_tpu_torch.testing.kernel_bench import (
    gate_bound, gate_case, gate_corners, gate_kernel, gate_plain, gate_tensors,
    index_decided_rows,
    k1_bound, k1_case, k2_bound, k2_case, late_round, nvidia_smi, offset_copy,
    run_case, same, sm_clock_hz,
)

N_TASKS, N_NODES, GANG, N_QUEUES = 50_000, 5_000, 4, 3
MID_TASKS, MID_NODES = 4096, 1024
TOPK = 32
# the cycle drive: pods arriving before cycle 2, and host ports at mid size
ARRIVALS, MID_ARRIVALS, MID_PORTS = 5_000, 408, 0.1
# the overcommit drive (kube_batch_tpu/testing/benchmark.py:85, 800 running /
# 400 pending / 100 nodes, scaled 50x to the headline's nodes), and at a
# small size for the CPU <-> CUDA comparison
OC_RUNNING, OC_PENDING = 40_000, 20_000
MID_OC = dict(n_running=2048, n_pending=1024, n_nodes=256)
# the steady-state drive: warmup and measured cycles (bench.py:151), and its
# legs (cycle_drive.LEGS: defaults, KB_WARM=0, KB_GUARD=0, the oracle)
STEADY_WARMUP, STEADY_CYCLES = 2, 4
STEADY_LEGS = ("defaults", "cold", "noguard", "oracle", "pipelined")
# the loop drive: single-pod arrivals and the serial loop's tick (bench.py:1215)
LOOP_FEED, LOOP_PERIOD = 20, 1.0
# the warm path's re-rank rungs below the 8 192-row bucket (K2's rows there)
WARM_RERANK_RUNGS = (128, 256, 512, 1024, 2048, 4096)
# the feature drive: PDB-defined gangs, claims on the PV ledger and claims on
# missing PVs, at the headline size and (the same shares) at mid size
FEAT_PDB, FEAT_PVC, FEAT_IMPOSSIBLE = 0.05, 2_000, 50
MID_FEAT_PVC, MID_FEAT_IMPOSSIBLE = 164, 4
KERNELS = ("masked_best_node_raw", "masked_topk_blocks", "enqueue_gate")


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0, **fields}),
          flush=True)


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

    # K2 at the compacted solve's bucket sizes and at the warm path's
    # re-rank rungs (128 up to the bucket), plus ragged node blocks
    for P in WARM_RERANK_RUNGS + (8192, T):
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


def phase_enqueue_gate():
    """The admission gate's kernel against its plain version, bit-exact, at
    capJ 16 384 with 12 500 MinResources rows and at its corners; the main
    case timed against its bound (the dependence chain at the card's
    highest SM clock)."""
    dev = torch.device("cuda")
    clock = sm_clock_hz()
    main = gate_tensors(gate_case(), dev)
    r = run_case(gate_kernel, gate_plain, main, reps=20, plain_reps=1)
    b_ms, b_by = gate_bound(main, clock)
    admitted = int(gate_kernel(**main)[0].sum())
    report = {"main": dict(cap=main["min_res"].shape[0], rows=main["n_rows"],
                           candidates=int(main["cand"].sum()), admitted=admitted,
                           **r, bound_ms=b_ms, bound_by=b_by,
                           bound_fraction=b_ms / r["ms"], sm_clock_mhz=clock / 1e6)}
    if not 0 < admitted < int(main["cand"].sum()):
        fail(f"enqueue_gate: the main case admitted {admitted} rows")
    for name, case in gate_corners().items():
        inp = gate_tensors(case, dev)
        rc = run_case(gate_kernel, gate_plain, inp, reps=1)
        report[name] = dict(rows=inp["n_rows"], admitted=int(gate_kernel(**inp)[0].sum()),
                            max_abs_err=rc["max_abs_err"])
    emit("enqueue_gate", tolerance="bit-exact", **report)
    return report


def _mid_evict_cluster():
    """An overcommitted 4 096-task × 1 024-node cluster: q0 fills every
    node's cpu, q1 waits (reclaim's claimants), and 128 high-priority q0
    gangs wait too (preempt's)."""
    from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Pod, PodGroup
    from kube_batch_tpu_torch.api.types import PodPhase
    from kube_batch_tpu_torch.testing.synthetic import synthetic_overcommit_cluster

    cache = synthetic_overcommit_cluster(n_running=2048, n_pending=1536, n_nodes=MID_NODES)
    for j in range(128):
        cache.add_pod_group(PodGroup(name=f"high{j}", namespace="bench", min_member=GANG,
                                     queue="q0", creation_index=10**6 + j))
        for k in range(GANG):
            cache.add_pod(Pod(name=f"high{j}-{k}", namespace="bench",
                              requests={"cpu": 2000.0, "memory": 2.0 * 2**30},
                              annotations={GROUP_NAME_ANNOTATION: f"high{j}"},
                              phase=PodPhase.PENDING, priority=100,
                              creation_index=10**6 + GANG * j + k))
    return cache


def phase_evict_cross_device():
    """The reclaim and preempt solves on one 4 096 × 1 024 session snapshot,
    on the CPU (plain PyTorch) and on the card: all three result fields and
    the rounds equal."""
    from kube_batch_tpu_torch import plugins as _plugins  # noqa: F401 — registers
    from kube_batch_tpu_torch.actions.reclaim import evict_config
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
    from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
    from kube_batch_tpu_torch.framework.session import close_session, open_session
    from kube_batch_tpu_torch.ops.eviction import evict_solve

    cache = _mid_evict_cluster()
    conf = load_scheduler_conf(shipped_conf_path())
    ssn = open_session(cache, conf.tiers, "cpu")
    ssn.action_names = list(conf.actions)
    out = {}
    try:
        snap, _meta = cache.columns.device_snapshot(ssn)
        for mode in ("reclaim", "preempt"):
            cfg = evict_config(ssn, mode)
            cpu, cpu_rounds = evict_solve(snapshot_from_numpy(snap, "cpu"), cfg)
            gpu_snap = snapshot_from_numpy(snap, "cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            gpu, gpu_rounds = evict_solve(gpu_snap, cfg)
            torch.cuda.synchronize()
            gpu_ms = (time.perf_counter() - t) * 1e3
            bad = [f for f, x, y in zip(cpu._fields, cpu, gpu) if not same([x], [y])]
            if bad or cpu_rounds != gpu_rounds:
                fail(f"evict_cross_device {mode}: {bad} differ, rounds "
                     f"{cpu_rounds} / {gpu_rounds}")
            claims = int((gpu.claim_node >= 0).sum())
            if claims == 0:
                fail(f"evict_cross_device {mode}: no claim")
            out[mode] = dict(claims=claims, evicted=int(gpu.evicted.sum()),
                             rounds=gpu_rounds, idle_gate=cfg.idle_gate, gpu_ms=gpu_ms)
    finally:
        close_session(ssn)
    emit("evict_cross_device", shape=[int(snap.task_req.shape[0]), int(snap.node_idle.shape[0])],
         equal="bit-exact", **out)


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


def sentinel_cost(snap, res, config):
    """The guard's added work on one allocate result at this size: the
    sentinel's device time (``allocate_invariants`` + the eligibility
    checksum, CUDA events) and the host checksum's time (host clock), with
    the verdict, which must be 0 on a lawful solve."""
    from kube_batch_tpu_torch.api.convert import snapshot_to_numpy
    from kube_batch_tpu_torch.ops.invariants import (
        allocate_invariants, eligibility_checksum, host_eligibility_checksum,
    )
    from kube_batch_tpu_torch.testing.kernel_bench import time_ms

    verdict, _hist = allocate_invariants(snap, res, config)
    check = int(eligibility_checksum(snap)) & 0xFFFFFFFF
    host = snapshot_to_numpy(snap)
    t = time.perf_counter()
    host_check = host_eligibility_checksum(host)
    host_ms = (time.perf_counter() - t) * 1e3
    if int(verdict) != 0 or check != host_check:
        fail(f"sentinel: verdict {int(verdict)}, checksum {check} / host {host_check}")
    device_ms = time_ms(lambda: (allocate_invariants(snap, res, config),
                                 eligibility_checksum(snap)), reps=20)
    return dict(verdict=int(verdict), device_ms=device_ms, host_checksum_ms=host_ms)


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
        res, mode, info, _g = dispatch_allocate_solve(snap, config)
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
        again, _, _, _ = dispatch_allocate_solve(snap, config)
        torch.cuda.synchronize()
        again_ms = (time.perf_counter() - t) * 1e3
        bad = [f for f, x, y in zip(res._fields, res, again) if not same([x], [y])]
        if bad:
            fail(f"{label}: a second run differs in {bad}")
        placed = res.assigned >= 0
        sentinel = sentinel_cost(snap, res, config)
        out[label] = dict(
            mode="full", placed=int(placed.sum()),
            pending=int(snap.task_pending.sum()),
            pipelined=int(res.pipelined.sum()),
            committed_jobs=int(res.committed.sum()),
            rounds_run=int(res.rounds_run), wall_ms=wall_ms,
            wall_ms_second_run=again_ms, peak_mem_gib=peak / 2**30,
            launches=counts, invariants=inv, deterministic=True, sentinel=sentinel,
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


def phase_cycle():
    """Three cycles of the shipped conf at 50k × 5k on the card."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive

    r = drive(N_TASKS, N_NODES, ARRIVALS, device="cuda")
    c1, c2, c3 = r["cycles"]
    k1, k2, gate = KERNELS
    if c1["mode"] != "full" or c1["new_binds"] != N_TASKS \
            or c1["gangs_running"] != N_TASKS // GANG:
        fail(f"cycle 1: {c1['mode']}, {c1['new_binds']} binds, "
             f"{c1['gangs_running']} gangs running")
    if c1["launches"][k1] == 0 or c1["launches"][k1] != c1["rounds"]:
        fail(f"cycle 1: K1 launches {c1['launches']} != rounds {c1['rounds']}")
    if c2["mode"] != "compacted" or c2["launches"][k2] == 0:
        fail(f"cycle 2: {c2['mode']} program, launches {c2['launches']}")
    if c2["new_binds"] == 0:
        fail("cycle 2 bound nothing")
    if c3["enqueue"]["gate_rows"] == 0 or c3["launches"][gate] == 0 \
            or c3["new_binds"] == 0:
        fail(f"cycle 3: gate rows {c3['enqueue']['gate_rows']}, launches "
             f"{c3['launches']}, {c3['new_binds']} binds")
    totals = {k: sum(c["launches"][k] for c in r["cycles"]) for k in KERNELS}
    if not all(totals.values()):
        fail(f"the headline drive did not launch every kernel: {totals}")
    emit("cycle", conf="shipped", launches_total=totals, **r)
    return r


def phase_cycle_overcommit():
    """Three cycles of the shipped conf on the 60k-pod overcommitted
    cluster: reclaim evicts and pipelines, the claimants bind once the
    kubelet deleted the victims; the drive checks every eviction."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_overcommit

    r = drive_overcommit(OC_RUNNING, OC_PENDING, N_NODES, device="cuda")
    c1, c2, c3 = r["cycles"]
    if c1["new_evicts"] == 0 or c1["pipelined_claimants"] == 0:
        fail(f"overcommit cycle 1: {c1['new_evicts']} evictions, "
             f"{c1['pipelined_claimants']} pipelined claimants")
    if c2["new_binds"] == 0:
        fail("overcommit cycle 2 bound nothing")
    # nothing is left pending: the idle path launches no kernel
    if c3["mode"] != "idle" or any(c3["launches"].values()):
        fail(f"overcommit cycle 3: {c3['mode']}, launches {c3['launches']}")
    emit("cycle_overcommit", conf="shipped", **r)
    return r


def phase_cycle_steady():
    """The steady-state drive at 50k × 5k on the card, four legs (module
    docstring): equal decisions in every cycle, the defaults leg warm after
    its first plan, every guarded leg's verdicts clean."""
    from kube_batch_tpu_torch.api.resident import scatter_summary
    from kube_batch_tpu_torch.testing.cycle_drive import drive_steady

    legs = {leg: drive_steady(N_TASKS, N_NODES, cycles=STEADY_CYCLES,
                              warmup_cycles=STEADY_WARMUP, device="cuda", leg=leg,
                              check_swaps=leg != "oracle")
            for leg in STEADY_LEGS}
    base = legs["defaults"]
    for leg, r in legs.items():
        for a, b in zip(base["cycles"], r["cycles"]):
            if a["digest"] != b["digest"]:
                fail(f"cycle_steady: cycle {a['cycle']} of leg {leg} decided "
                     f"differently ({a['digest']} / {b['digest']})")
            if b["swaps_checked"] is not None and b["swaps_checked"] != b["swaps"]:
                fail(f"cycle_steady: {leg} cycle {b['cycle']} checked "
                     f"{b['swaps_checked']} of {b['swaps']} swaps")
        guarded = leg != "noguard"
        for c in r["cycles"]:
            g = c["guard"]
            if guarded and (g["trips"] or g["failed_closed"]
                            or (c["mode"] != "idle" and not g["verdicts"])):
                fail(f"cycle_steady: {leg} cycle {c['cycle']} guard {g}")
            if not guarded and (g["enabled"] or g["verdicts"]):
                fail(f"cycle_steady: the noguard leg read verdicts: {g}")
        if leg in ("cold", "oracle") and any(c["warm"] for c in r["cycles"]):
            fail(f"cycle_steady: the {leg} leg ran the carried table")
    steady = base["cycles"][STEADY_WARMUP:]
    planned = [c for c in base["cycles"] if c["warm"] is not None]
    if not planned or not planned[0]["warm"]["cold"]:
        fail("cycle_steady: the defaults leg never planned the warm carry")
    late_cold = [c["cycle"] for c in planned[1:] if c["warm"]["cold"]]
    if late_cold:
        fail(f"cycle_steady: the defaults leg planned cold again in cycles {late_cold}")
    if any(c["mode"] == "compacted" and c["warm"] is None for c in steady):
        fail("cycle_steady: a compacted steady cycle of the defaults leg ran cold")
    if "delta" not in [c["open_path"] for c in steady]:
        fail("cycle_steady: the defaults leg never took the delta open")
    if not sum(c["resident"]["scatter_updates"] for c in steady if c["resident"]):
        fail("cycle_steady: the defaults leg never scattered")
    k2 = "masked_topk_blocks"
    for leg, r in legs.items():
        for c in r["cycles"]:
            topk = c["topk"] or {}
            emit("cycle_steady_cycle", leg=leg, cycle=c["cycle"], mode=c["mode"],
                 overlap=c["overlap"], period_ms=c["period_ms"],
                 open_path=c["open_path"], snapshot_path=c["snapshot_path"],
                 churn=c["churn"], pending=c["pending"],
                 completed_gangs=c.get("completed_gangs"), arrived=c.get("arrived"),
                 new_binds=c["new_binds"], wall_ms=c["wall_ms"],
                 solve_ms=c["allocate_ms"].get("solve"), stages_ms=c["stages_ms"],
                 allocate_ms=c["allocate_ms"], syncs=c["syncs"],
                 k2_launches=c["launches"][k2], launches=c["launches"],
                 warm=c["warm"], rungs=topk.get("rungs"),
                 topk_exhausted=topk.get("exhausted"), reentries=topk.get("reentries"),
                 guard=c["guard"], swaps=c["swaps"], swap_check_ms=c["swap_check_ms"],
                 resident=c["resident"], digest=c["digest"])
    totals = {}
    for c in steady:
        for k, v in (c["resident"] or {}).items():
            if isinstance(v, int) and k != "version":
                totals[k] = totals.get(k, 0) + v

    def p50(values):
        values = sorted(v for v in values if v is not None)
        return float(np.percentile(values, 50)) if values else None

    summary = {}
    for leg, r in legs.items():
        cyc = r["cycles"][STEADY_WARMUP:]
        summary[leg] = dict(
            r["steady"],
            wall_less_swap_check_ms_p50=p50([c["wall_ms"] - c["swap_check_ms"] for c in cyc]),
            syncs=[c["syncs"] for c in cyc], k2_launches=[c["launches"][k2] for c in cyc],
            ingest_s=r["ingest_s"])
    d, ng, cold = summary["defaults"], summary["noguard"], summary["cold"]
    pipe = summary["pipelined"]
    # the pipelined cycle's wall + its bind-drain join, against the serial
    # defaults leg's wall (both include the swap check)
    pipelined_vs_defaults = {
        "wall_plus_join_ms_p50": pipe["wall_plus_join_ms_p50"],
        "defaults_wall_ms_p50": d["wall_ms_p50"],
        "difference_ms": pipe["wall_plus_join_ms_p50"] - d["wall_ms_p50"],
        "writeback_ms_p50": pipe["writeback_ms_p50"],
        "barrier_ms_p50": pipe["barrier_ms_p50"],
        "join_ms_p50": pipe["join_ms_p50"],
        "close_ms_p50": pipe["close_ms_p50"], "defaults_close_ms_p50": d["close_ms_p50"],
        # the whole iteration, the same work on both legs
        "period_ms_p50": pipe["period_ms_p50"],
        "defaults_period_ms_p50": d["period_ms_p50"]}
    overhead = {key: d[key] - ng[key] for key in
                ("solve_ms_p50", "wall_ms_p50", "wall_less_swap_check_ms_p50")}
    overhead["share_of_steady_wall_p50"] = overhead["wall_less_swap_check_ms_p50"] / ng[
        "wall_less_swap_check_ms_p50"]
    rungs = [c["topk"]["rungs"]["rerank"] for c in steady
             if c["topk"] and c["topk"].get("rungs")]
    emit("cycle_steady", conf="shipped", tasks=N_TASKS, nodes=N_NODES,
         warmup_cycles=STEADY_WARMUP, cycles=STEADY_CYCLES, legs=list(STEADY_LEGS),
         equal="decisions every cycle, all legs; every non-oracle swap equals a fresh upload",
         resident_steady=scatter_summary({"single": totals})["single"] if totals else None,
         guard_overhead=overhead, pipelined_vs_defaults=pipelined_vs_defaults,
         warm_minus_cold_solve_ms_p50=d["solve_ms_p50"] - cold["solve_ms_p50"],
         rerank_rungs=rungs, **summary)
    return legs, rungs


def phase_loop():
    """``Scheduler.run_forever`` on the card at 50k × 5k, shipped conf
    (``cycle_drive.drive_loop``): the serial loop and the pipelined loop
    over the same warmed cluster shape and arrival stream.  Every arrival
    bound exactly once, ``stop()`` drained, no cycle or writeback failed
    (the drive checks), and each loop launched kernels."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_loop

    r = drive_loop(N_TASKS, N_NODES, feed=LOOP_FEED, period=LOOP_PERIOD, device="cuda")
    for mode in ("serial", "pipelined"):
        m = r[mode]
        if m["bound"] != LOOP_FEED or m["staged_left"] or not m["writeback_joined"]:
            fail(f"loop {mode}: {m['bound']} of {LOOP_FEED} bound, "
                 f"{m['staged_left']} staged left, writeback joined {m['writeback_joined']}")
        if not (m["launches"]["masked_best_node_raw"] + m["launches"]["masked_topk_blocks"]):
            fail(f"loop {mode}: no allocate kernel launched: {m['launches']}")
    emit("loop", conf="shipped", tasks=N_TASKS, nodes=N_NODES, feed=LOOP_FEED,
         period_s=LOOP_PERIOD, serial=r["serial"], pipelined=r["pipelined"],
         p99_serial_over_pipelined=r["serial"]["latency_ms"]["p99"]
         / r["pipelined"]["latency_ms"]["p99"])
    return r


def phase_guard():
    """The guard plane on the card at 4 096 × 1 024, shipped conf
    (``cycle_drive.drive_guard``): audited clean cycles, a zeroed resident
    capacity word failing closed and healing, re-promotion after the
    cooldown, a phantom pending bit caught by the host checksum, and the
    trip bundle replayed on the card and the CPU."""
    import shutil
    import tempfile

    from kube_batch_tpu_torch.testing.cycle_drive import drive_guard

    bundles = tempfile.mkdtemp(prefix="guard-bundles-")
    try:
        r = drive_guard(MID_TASKS, MID_NODES, MID_ARRIVALS, bundles, device="cuda")
    finally:
        shutil.rmtree(bundles, ignore_errors=True)
    emit("guard", conf="shipped", shape=[MID_TASKS, MID_NODES], arrivals=MID_ARRIVALS,
         cooldown=r["cooldown"], audits_clean=r["audits_clean"], cycles=r["cycles"],
         trips=[{k: t[k] for k in ("cycle", "action", "reason", "demoted", "detail")}
                for t in r["trip_log"]],
         state={k: v for k, v in r["guard"].items() if k != "bundles"},
         replay={k: v for k, v in r["replay"].items() if k != "original_report"},
         restored_verdict=r["restored_verdict"])


def phase_cycle_cross_device():
    """The headline drive at 4 096 × 1 024 with host ports and the
    overcommit drive at 2 048 / 1 024 / 256, on the card with the
    cross-cycle defaults and on the CPU as the oracle (the three switched
    off, plain kernel versions): identical binds, evictions, task statuses
    and PodGroup phases after every cycle."""
    from kube_batch_tpu_torch.testing.cycle_drive import (
        drive, drive_overcommit, oracle_switches,
    )

    runs = {
        "headline": lambda dev: drive(MID_TASKS, MID_NODES, MID_ARRIVALS,
                                      host_ports_frac=MID_PORTS, device=dev,
                                      keep_states=True),
        "overcommit": lambda dev: drive_overcommit(**MID_OC, device=dev,
                                                   keep_states=True),
    }
    out = {}
    for name, run in runs.items():
        with oracle_switches(True):
            cpu = run("cpu")
        gpu = run("cuda")
        for c, (a, b) in enumerate(zip(cpu.pop("states"), gpu.pop("states"))):
            for key in a:
                if a[key] != b[key]:
                    fail(f"cycle_cross_device {name}: cycle {c + 1} {key} differ")
        out[name] = [dict(cycle=g["cycle"], mode=g["mode"], binds=g["binds"],
                          evicts=g["evicts"], cpu_wall_ms=c_["wall_ms"],
                          gpu_wall_ms=g["wall_ms"], gpu_launches=g["launches"],
                          gpu_open_path=g["open_path"], gpu_resident=g["resident"],
                          fallback=g["fallback"])
                     for c_, g in zip(cpu["cycles"], gpu["cycles"])]
    if not out["headline"][0]["gpu_launches"]["masked_best_node_raw"]:
        fail("cycle_cross_device: the card's cycle 1 launched no K1")
    if not out["overcommit"][0]["evicts"]:
        fail("cycle_cross_device: the overcommit drive evicted nothing")
    emit("cycle_cross_device", conf="shipped", cpu="oracle", gpu="defaults",
         equal="binds, evictions, task statuses and PodGroup phases",
         headline_shape=[MID_TASKS, MID_NODES], host_ports_frac=MID_PORTS,
         overcommit=MID_OC, cycles=out)


def isolated_decided(cyc, size):
    """The isolated cycle (the third) placed the arrivals it was given:
    new binds, among them a PDB gang and pods whose claims bound PVs, so
    the object replay ran the volume binding and the PDB close."""
    iso, prev = cyc[2]["checks"], cyc[1]["checks"]
    if not (cyc[2]["new_binds"] > 0
            and iso["pdb_gangs_bound"] > prev["pdb_gangs_bound"]
            and iso["bound_pods_with_claims"] > prev["bound_pods_with_claims"]):
        fail(f"features {size}: the isolated cycle placed no arrival: {cyc[2]['new_binds']} "
             f"new binds, checks {prev} -> {iso}")


def phase_cycle_features():
    """The feature drive (``cycle_drive.drive_features``): the
    50 000-pod cluster with 5 % of its gangs defined by PodDisruptionBudgets
    (a quarter of them too large to fit), 2 000 pods claiming PVs from a
    ``StandalonePVBinder`` (half pinned to one node each by hostname
    topology, half wildcard) and 50 claims on missing PVs, under the
    shipped conf plus a custom score row registered through
    ``Session.add_score_row``: two exclusive cycles, then one isolated
    that must place new arrivals (PDB gangs, claims on new PVs).
    Every cycle checks the PDB gangs (all or nothing), the ledger (no PV
    twice, every bound claim on a node its PV reaches, the impossible
    claims unbound) and the column store, node ledgers and double binds;
    cycle 1's solve input holds K1 and K2 against their plain versions on
    the score plane with the row, bit-exact.  Then the same features at
    4 096 × 1 024: exclusive and isolated cycles on the card with the
    defaults and on the CPU as the oracle must decide identically."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_features, oracle_switches

    r = drive_features(N_TASKS, N_NODES, FEAT_PVC, FEAT_IMPOSSIBLE,
                       pdb_gang_frac=FEAT_PDB, device="cuda", hold_first=True)
    cyc = r["cycles"]
    k1, k2 = "masked_best_node_raw", "masked_topk_blocks"
    if cyc[0]["launches"][k1] == 0 or cyc[0]["launches"][k1] != cyc[0]["rounds"]:
        fail(f"features cycle 1: K1 launches {cyc[0]['launches']} != rounds {cyc[0]['rounds']}")
    if not any(c["launches"][k2] for c in cyc):
        fail("features: no cycle ran the compacted program (K2)")
    if not (cyc[2]["launches"][k1] + cyc[2]["launches"][k2]):
        fail(f"features: the isolated cycle launched no kernel: {cyc[2]['launches']}")
    isolated_decided(cyc, "50k")
    last = cyc[-1]["checks"]
    if not (last["pdb_gangs_bound"] and last["pdb_gangs_blocked"]
            and last["bound_pods_with_claims"]
            and last["impossible_claims_unbound"] == FEAT_IMPOSSIBLE):
        fail(f"features: the drive did not exercise every feature: {last}")
    if not any(c["volume_demoted_jobs"] for c in cyc):
        fail("features: the volume pre-check demoted no job")
    mid = {}
    for leg, dev in (("cpu", "cpu"), ("gpu", "cuda")):
        with oracle_switches(leg == "cpu"):
            mid[leg] = drive_features(MID_TASKS, MID_NODES, MID_FEAT_PVC, MID_FEAT_IMPOSSIBLE,
                                      pdb_gang_frac=FEAT_PDB, device=dev, keep_states=True)
    isolated_decided(mid["gpu"]["cycles"], "mid")
    for c, (a, b) in enumerate(zip(mid["cpu"].pop("states"), mid["gpu"].pop("states"))):
        for key in a:
            if a[key] != b[key]:
                fail(f"features mid: cycle {c + 1} ({mid['gpu']['cycles'][c]['session']}) "
                     f"{key} differ between the card and the CPU")
    emit("cycle_features", conf="shipped + rack-affinity score row", shape=r["shape"],
         ingest_s=r["ingest_s"], pdb_gang_frac=FEAT_PDB, pvc_pods=FEAT_PVC,
         pvc_impossible=FEAT_IMPOSSIBLE, held=r["held"],
         cycles=[{k: c[k] for k in ("cycle", "session", "arrivals", "mode", "rounds", "wall_ms",
                                    "stages_ms", "clone_ms", "allocate_ms", "new_binds",
                                    "binds", "volume_demoted_jobs", "launches", "syncs",
                                    "checks")} for c in cyc],
         mid_shape=[MID_TASKS, MID_NODES], mid_equal="binds, evictions, task statuses, "
         "PodGroup phases, events, PV bindings and reservations",
         mid=[dict(cycle=g["cycle"], session=g["session"], new_binds=g["new_binds"],
                   binds=g["binds"],
                   cpu_wall_ms=c_["wall_ms"], gpu_wall_ms=g["wall_ms"],
                   gpu_launches=g["launches"], checks=g["checks"])
              for c_, g in zip(mid["cpu"]["cycles"], mid["gpu"]["cycles"])])
    return r


def phase_whatif(k1_main, steady_defaults):
    """The read plane on the card (``cycle_drive.drive_whatif``): K1 at a
    64-member probe gang's rows (gaps, rows past the task axis) bit-exact
    against its plain version and timed; the oracle contract at 50k × 5k
    (eight gangs probed on the frozen cluster, each then submitted alone:
    a feasible verdict binds exactly at its nodes, the eviction verdict on
    the filled node evicts exactly its victims through preempt); 16
    clients × 25 requests served beside 3 steady cycles (no error, no
    version going back, every node in its lease, every swap's retirement
    re-armed, fewer dispatches than requests); and the same 32 requests,
    with and without evictions, answered identically on the card and on
    the CPU at 4 096 × 1 024."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_whatif

    r = drive_whatif(N_TASKS, N_NODES, device="cuda")
    oracle = r["oracle"]
    launches = sum(g["k1_launches"] for g in oracle)
    if not all(g["k1_launches"] for g in oracle):
        fail(f"whatif: a probe launched no K1: {[g['k1_launches'] for g in oracle]}")
    if r["cross_device"] is None:
        fail("whatif: the card-against-CPU part did not run")
    serving = r["serving"]
    emit("whatif", conf="shipped", shape=[N_TASKS, N_NODES], setup_s=r["setup_s"],
         k1_probe_rows=r["k1_probe_rows"], flush=r["flush"], k1_main_path_ms=k1_main["ms"],
         k1_main_path_bound_ms=k1_main["bound_ms"],
         oracle=oracle, k1_launches=launches, serving=serving,
         steady_defaults_wall_ms_p50=steady_defaults["wall_ms_p50"],
         cross_device=r["cross_device"])
    return r, launches


def phase_replicate():
    """The replication stream on the card (``cycle_drive.drive_replicate``):
    the steady drive at 50k × 5k with a query plane, first without a
    publisher, then with the publisher and a follower on the same card
    pulling in process: in the cycles the follower follows, after every
    record, before the leader's next swap, four gangs (one with evictions)
    and a sweep go to both planes and must be answered identically; in the
    others the publisher runs alone (its cost on the wall) and the
    follower catches up after the cycle; a dropped frame resyncs warm
    (only the changed fields uploaded again), a follower past a ring of 4
    gets a synthesized full frame, and a restarted pull loop re-adopts
    warm; then at 4 096 × 1 024 a card follower and a CPU follower of one
    leader answer 32 requests identically, with and without evictions."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive_replicate

    r = drive_replicate(N_TASKS, N_NODES, device="cuda")
    if not r["follower_k1_launches"]:
        fail("replicate: the follower's probes launched no K1")
    if r["cross_device"] is None:
        fail("replicate: the card-against-CPU part did not run")
    if r["counters"]["encode_errors"]:
        fail(f"replicate: {r['counters']['encode_errors']} encodes failed")
    emit("replicate", conf="shipped", shape=[N_TASKS, N_NODES],
         **{k: v for k, v in r.items() if k not in ("tasks", "nodes")})
    return r


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
    gate = phase_enqueue_gate()
    phase_cross_device()
    phase_evict_cross_device()
    config = AllocateConfig()
    snaps = {"homogeneous": snap,
             "gpu_gangs": synthetic_device_snapshot(**main_kw,
                                                    gpu_task_frac=0.3)[0]}
    full, full_launches = phase_solve_full(snaps, config)
    del snaps["gpu_gangs"]
    topk_launches = phase_solve_topk(snap, config, full["homogeneous"])
    T = snap.task_req.shape[0]
    # the cycles reuse the caching allocator's blocks, as a long-running
    # scheduler process does
    del snap, snaps, full
    cycle = phase_cycle()
    overcommit = phase_cycle_overcommit()
    steady, rerank_rungs = phase_cycle_steady()
    loop = phase_loop()
    phase_guard()
    features = phase_cycle_features()
    phase_cycle_cross_device()
    whatif, whatif_launches = phase_whatif(kern["K1"], steady["defaults"]["steady"])
    replicate = phase_replicate()
    cycle_launches = {name: {f"cycle{c['cycle']}": c["launches"][name]
                             for c in cycle["cycles"]}
                      for name in KERNELS}
    overcommit_launches = {name: {f"cycle{c['cycle']}": c["launches"][name]
                                  for c in overcommit["cycles"]}
                           for name in KERNELS}
    steady_launches = {name: sum(c["launches"][name] for c in steady["defaults"]["cycles"])
                       for name in KERNELS}
    # the pipelined loop's paths: the steady leg through run_once_pipelined,
    # and run_forever in both modes (its warmup excluded)
    pipelined_launches = {name: sum(c["launches"][name]
                                    for c in steady["pipelined"]["cycles"])
                          for name in KERNELS}
    loop_launches = {name: {mode: loop[mode]["launches"][name]
                            for mode in ("serial", "pipelined")}
                     for name in KERNELS}
    features_launches = {name: {f"cycle{c['cycle']}_{c['session']}": c["launches"][name]
                                for c in features["cycles"]}
                         for name in KERNELS}
    # K2 on the warm path: launches per steady cycle of the defaults and
    # cold legs, and its time against its bound at the commonest re-rank rung
    k2_per_cycle = {leg: [c["launches"]["masked_topk_blocks"]
                          for c in steady[leg]["cycles"][STEADY_WARMUP:]]
                    for leg in ("defaults", "cold")}
    rung = max(set(rerank_rungs), key=rerank_rungs.count) if rerank_rungs else None
    k2_rerank = kern.get(f"K2_P{rung}") if rung else None

    src = "kube_batch_tpu_torch/csrc/"
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    k1, k1_late = kern["K1"], kern["K1_late_round"]
    k2 = kern[f"K2_P{T}"]
    g = gate["main"]
    summary = [
        dict(name="masked_best_node_raw", route="cuda",
             source=src + "best_node.cu",
             replaces="kube_batch_tpu/ops/pallas_kernels.py:52",
             launches=full_launches["masked_best_node_raw"],
             **{f: k1[f] for f in fields}, library_ms=None,
             late_round_ms=k1_late["ms"],
             late_round_bound_ms=k1_late["bound_ms"],
             late_round_pending_rows=k1_late["pending_rows"],
             cycle_launches=cycle_launches["masked_best_node_raw"],
             overcommit_launches=overcommit_launches["masked_best_node_raw"],
             steady_launches=steady_launches["masked_best_node_raw"],
             pipelined_steady_launches=pipelined_launches["masked_best_node_raw"],
             loop_launches=loop_launches["masked_best_node_raw"],
             features_launches=features_launches["masked_best_node_raw"],
             whatif_launches=whatif_launches,
             replicate_follower_launches=replicate["follower_k1_launches"],
             probe_rows_shape=whatif["k1_probe_rows"]["shape"],
             probe_rows_ms=whatif["k1_probe_rows"]["ms"],
             probe_rows_plain_ms=whatif["k1_probe_rows"]["plain_ms"],
             probe_rows_bound_ms=whatif["k1_probe_rows"]["bound_ms"],
             probe_rows_max_abs_err=whatif["k1_probe_rows"]["max_abs_err"]),
        dict(name="masked_topk_blocks", route="cuda",
             source=src + "topk_blocks.cu",
             replaces="kube_batch_tpu/ops/pallas_kernels.py:216",
             launches=topk_launches["masked_topk_blocks"],
             **{f: k2[f] for f in fields}, library_ms=None,
             cycle_launches=cycle_launches["masked_topk_blocks"],
             overcommit_launches=overcommit_launches["masked_topk_blocks"],
             steady_launches=steady_launches["masked_topk_blocks"],
             pipelined_steady_launches=pipelined_launches["masked_topk_blocks"],
             loop_launches=loop_launches["masked_topk_blocks"],
             features_launches=features_launches["masked_topk_blocks"],
             warm_launches_per_steady_cycle=k2_per_cycle["defaults"],
             cold_launches_per_steady_cycle=k2_per_cycle["cold"],
             fresh_keys="plain ops (the releasing fit masked on the view, as the JAX package)",
             rerank_shape=None if k2_rerank is None else k2_rerank["shape"],
             rerank_ms=None if k2_rerank is None else k2_rerank["ms"],
             rerank_bound_ms=None if k2_rerank is None else k2_rerank["bound_ms"],
             rung_ms={P: kern[f"K2_P{P}"]["ms"] for P in WARM_RERANK_RUNGS},
             rung_bound_ms={P: kern[f"K2_P{P}"]["bound_ms"] for P in WARM_RERANK_RUNGS}),
        dict(name="enqueue_gate", route="cuda",
             source=src + "enqueue_gate.cu",
             replaces="kube_batch_tpu/ops/admission.py:48",
             launches=sum(cycle_launches["enqueue_gate"].values()),
             **{f: g[f] for f in fields}, library_ms=None,
             cycle_launches=cycle_launches["enqueue_gate"],
             overcommit_launches=overcommit_launches["enqueue_gate"],
             steady_launches=steady_launches["enqueue_gate"],
             pipelined_steady_launches=pipelined_launches["enqueue_gate"],
             loop_launches=loop_launches["enqueue_gate"],
             features_launches=features_launches["enqueue_gate"]),
    ]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
