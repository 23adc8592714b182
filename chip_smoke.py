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
package's ``bench.py`` ``multicycle_bench``) runs 2 + 2 back-to-back
cycles on the 50 000-pod cluster (the bench's 8 measured cycles cut to 2
for the script's time; ``cycle_drive --steady`` runs 8) — 2 % of the bound gangs complete and
arrivals refill the pod count within ±10 % before each — five times: with
the defaults (delta open and close, resident snapshot, the warm
candidate-table carry, the guard plane), with ``KB_WARM=0`` (cold), with
``KB_GUARD=0`` (noguard), with the four cross-cycle mechanisms off (the
oracle), pipelined (the defaults, each cycle through
``run_once_pipelined``: its status flush and bind drain on the writeback
worker, the bind drain joined before the kubelet pass) and with
``KB_TRACE=0`` (untraced: the tracer is on in every other leg, as by
default); every resident
swap of all but the oracle is held against a fresh upload of its host
snapshot.  Every cycle's decisions must be equal across the legs, the
defaults leg must take the delta open, the scatter path and the warm
merge in every plan after its first, every guarded leg's sentinel
verdicts must be clean, and no writeback stage or bind may fail; one JSON
line per cycle and leg (the warm plan, the table's rungs, exhaustion,
solve ms, syncs, K2 launches; for the pipelined leg its barrier, join,
wall + join and the writeback's own ms), then the p50s of each leg and
the guard's overhead (defaults less noguard).  The traced legs are read
back (``trace_steady``): the defaults leg's spans per cycle and each span
name's p50, its ring exported as Chrome trace events (which must
validate), K1 and K2 launched inside its ``solve_dispatch`` spans, the e2e
histogram counting every cycle, one arrival → decision sample per
acknowledged bind (read through the sink), the Prometheus text's series
and render time and the flight recorder's bytes; the pipelined leg's
back-to-back cycles must show cycle N's writeback span overlapping cycle
N+1's compute in the exported trace; the untraced leg keeps no record.
The loop phase
(``drive_loop``: the JAX package's ``bench.py`` ``pipelined_bench``) runs
``Scheduler.run_forever`` on the warmed 50 000-pod cluster while 10
single-pod gangs arrive at seeded offsets of U(0.15, 0.45) s, once with
``KB_PIPELINE=0`` (a 1 s tick) and once pipelined: every arrival must be
bound exactly once and ``stop()`` must drain; it prints the arrival →
bind-ack latency, the cycles and their wake reasons, and the kernel
launches of each loop.  K2 is also timed at the warm path's re-rank rungs.  The
guard phase (``drive_guard``, 4 096 × 1 024) audits clean cycles against
the full solve, zeroes a resident capacity word in place (the cycle must
fail closed, heal, and the demoted paths re-promote after the cooldown),
sets a Running row's resident pending bit (the host checksum must trip),
and replays the trip's bundle on the card and the CPU; the trip must fire
the ``guard_trips`` alert (its gauge at 1) and leave a flight-recorder dump
beside the bundles whose trace validates.  The feature phase
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
32 requests identically.  The card's full solve of the 50 000-pod snapshot
must equal the plain solve of the same snapshot on the CPU, every field
(``solve_card_vs_cpu``).  The shard phase (``parallel/``) places the same
snapshot on a four-position mesh (four cards when there are four, else
four shards of the one card) and holds each sharded solve against its
single-device twin on the card, every field: the full solve (K1 per shard
at its node origin each round), the compacted solve (K2 per shard, one
merge), the full solve on a (tasks=2, nodes=2) grid, and reclaim's and
preempt's solves on the overcommit drive's cluster with 625 high-priority
gangs waiting; K1 and K2 at the second shard's origin are held against
their plain versions and timed beside the unsharded kernels, and the
collectives' bytes per round and per solve must equal
``collective_stats``.  After the headline drive, ``shard_cycles`` runs its
cycles 1–3 again through ``Scheduler(mesh=...)`` and with
``KB_SHARD_MAP=0`` (the ``"pjit"`` oracle): every cycle's binds digest
must equal the single-device drive's; the mesh's enqueue gate must equal
the single-device gate; and two processes joined by
``parallel/distributed.py`` (``nccl`` with a card each, ``gloo`` sharing
the card) solve 4 096 × 1 024, each rank equal to one process's solve.  The server phase
(``testing/server_drive.drive_server``) runs the standalone server as
``python -m kube_batch_tpu_torch.cmd.main`` builds it, in this process:
the 50 000-pod cluster ingested over HTTP as list bodies in the headline
drive's handler order and ``POST /v1/sync``; cycle 1's ``/v1/bindings``
must equal the headline drive's cycle 1 binds; the headline arrivals bind
in a compacted cycle; what-ifs and a sweep over HTTP must equal the query
plane's answers at the same lease version, byte for byte, and so must a
follower pulling ``/v1/replicate`` over loopback HTTP once caught up;
``failover_recover`` must keep the residency warm with consistent
columns.  The server process phase (``drive_server_process``, 4 096 ×
1 024) starts the process entry as a subprocess on the card with a state
file, binds the cluster, stops it, restarts it from the file (every
bound pod stays bound where it was) and answers a what-if from a
``--follower`` subprocess as the leader does.  The k8s phase
(``testing/k8s_drive.drive_k8s``) runs the same server with ``--master``
against the port's stub apiserver in a child process of its own, started
with the script and preloaded with the 50 000-pod cluster as Kubernetes
JSON while the other phases run: the watch lists
and seeds the cache, cycle 1 must decide as the headline drive's cycle 1
(equal binds digest, read off the cache's acked binds) and launch K1,
all 50 000 Binding POSTs must land on the stub, the watch's MODIFIED echo
must show every pod Running in the cache, the headline arrivals created
on the stub one POST at a time must bind through the watch and launch K2
and the gate, the columns must be consistent, and at close the watch
threads must join and the PV ledger's writer and timer close; it prints
each resource's LIST, the seed, cycle 1's stages, the bind POSTs' rate,
the echo's lag, the status writes and the arrivals' create → bind p50 /
p99.  The sim phase (``testing/sim_drive.py``) runs the virtual-time
simulator: its eight presets at seed 0, and smoke at seed 3 through the
pipelined cycle, on the card, each passing the
simulator CLI's exit criteria (no invariant error, recovered faults, no
duplicate bind, the guard's chaos invariants on ``corruption``) with the
same ``trace_sha256``, ``bind_digest``, trace length and cycles as the
same presets on the CPU in a child process; ``--warm-ab`` on
``warm-churn`` (identical binds, the carry engaged); ``--replay-bundle``
of the card's first corruption bundle (reproduced on the card);
``python -m kube_batch_tpu_torch.sim --preset smoke --seed 0`` as a
subprocess on the card (exit 0, the in-process smoke run's trace); then
the 50k drive — 5 000 nodes, 12 500 Poisson gangs of 4 (50 000 pods) over
three queues, 12 virtual cycles — with the defaults and with
``KB_WARM=0``: equal binds digest, clean invariants, no duplicate bind,
compacted cycles in the defaults leg; one JSON line per cycle and leg
(its wall split into events applied, ``run_once``, kubelet drain and
metrics sample), then the virtual-time p50 / p99 of job wait, JCT and pod arrival → bind.
The lockdep phase (``testing/lock_drive.py``, 4 096 × 1 024) installs the
port's lock checker and its guarded-access corroborator and drives every
threaded surface of one standalone server under them: HTTP ingest,
``run_forever`` pipelined over single-pod arrivals (some carrying
MinResources, so the gate launches), ``/v1/whatif`` through the batcher and
the lease, the publisher with a follower on the card; it fails on any
violation, on fewer than the four hot structures instrumented, or when K1,
K2 or the gate did not launch under the checker, and prints the edges and
the five sites with the most wait.  Its ``static`` line runs tiers A and D
of the analyzer over the installed package tree, which must have no
finding.  The matrix phase
(``testing/benchmark.py``) runs every case of ``build_cases()`` at full
width on the card — 3 000 × 100, 50 000 × 5 000 (DRF and proportion),
10 000 × 1 000 with the binpack row, the overcommitted cluster at 800 /
400 / 100 and at 10 000 running / 50 000 pending / 5 000 nodes through the
five actions, 50 000 × 5 000 GPU gangs, and 3 100 pods through
``run_forever`` on 100 nodes — one timed cycle after each warm-up, with
the launches of each; a device case must place and launch K1, an
overcommit case must evict, the startup case must schedule every pod it
created, a cycle case must launch K2; the two small device cases are
solved again on the CPU and must assign bit for bit alike.  The go_loop
phase (``testing/go_baseline.py``, ``go_pass_bench.py``) runs the
sequential Go allocate loop over the 50 000 × 5 000 workload in numpy and
in C (``native/go_pass.c``, built with ``cc`` into
``kube_batch_tpu_torch/build/``) on one thread and on a 16-thread pool —
the three must place alike — and times the per-task pass the three ways
(which must pick alike); it prints each leg against the headline drive's
cycle 1 and the host's CPU.  The audit phase
(``kube_batch_tpu_torch/analysis``), run right after the build while the
card holds nothing else, runs every registered device program once under
the recorder: the single-device registry and the sharded one (four
positions) at the audit point with every rule judged (float64, transfers,
host syncs against each program's budget, in-place residents, task ×
node planes, the budget, in-place allocations, node-scaled per-round
moves), each program's recorded syncs held equal to CUDA's sync-debug
count of the same call; then the single-device programs at bench-20k and
headline-50k and the sharded ones at headline-50k, each program's peak
``max_memory_allocated`` against the card's memory.  Any finding not on
the allowlist, or any sync count that differs, fails; one ``audit`` line
carries per program and point the peak and base bytes, the headroom, the
syncs (recorded and sync-debug) and rounds, the transfers and the sharded
tail's move bytes a round.  Each phase prints one JSON
line; any failure raises (non-zero exit).  The last three lines are the kernels'
summary, the card's name and power limit, and ``{"ok": true, "device":
...}``.

Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

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
STEADY_WARMUP, STEADY_CYCLES = 2, 2
STEADY_LEGS = ("defaults", "cold", "noguard", "oracle", "pipelined", "untraced")
# the loop drive: single-pod arrivals (bench.py:1215's 20, cut to 10 for the
# script's time) and the serial loop's tick
LOOP_FEED, LOOP_PERIOD = 10, 1.0
# the warm path's re-rank rungs below the 8 192-row bucket (K2's rows there)
WARM_RERANK_RUNGS = (128, 256, 512, 1024, 2048, 4096)
# the feature drive: PDB-defined gangs, claims on the PV ledger and claims on
# missing PVs, at the headline size and (the same shares) at mid size
FEAT_PDB, FEAT_PVC, FEAT_IMPOSSIBLE = 0.05, 2_000, 50
MID_FEAT_PVC, MID_FEAT_IMPOSSIBLE = 164, 4
KERNELS = ("masked_best_node_raw", "masked_topk_blocks", "enqueue_gate")
# the sharded solves' mesh: four positions (distinct cards when there are
# four, else four shards of the one card)
SHARDS = 4
# the simulator's 50k drive: 5 000 nodes, 12 500 gangs of 4, virtual cycles
# (sim_drive's 16 cut to 12 for the script's time: its three compacted
# cycles, the last arrivals' at 9–11, stay in)
SIM_NODES, SIM_GANGS, SIM_CYCLES = N_NODES, N_TASKS // GANG, 12
# the benchmark matrix (testing/benchmark.py build_cases, full width): one
# timed cycle a case after its warm-up (the JAX --quick's 2, cut to 1 for the
# script's time), and the two small device cases solved on the CPU as well
MATRIX_CYCLES = 1
MATRIX_CARD_VS_CPU = ("gang_allocate_kubemark", "binpack_nodeorder_10k_1k")


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


def phase_audit():
    """The device-program audits on the card (module docstring)."""
    from kube_batch_tpu_torch.analysis import memory_audit as ma
    from kube_batch_tpu_torch.analysis import program_audit as pa

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    single = tuple(pa.REGISTRY)
    mesh = _shard_mesh()
    sharded = pa.sharded_registry(mesh)
    bench, headline = ma.shape_points()[:2]
    runs, reports = {}, []

    def record(entries, points):
        for sp in points:
            for e in entries:
                runs[(e.name, sp.name, str(dev))] = pa.run_entry(e, sp, dev, sync_debug=True)
        return ma.run_memory_audit(entries, points, dev, runs=runs, reports=reports)

    found = record(single + sharded, [pa.AUDIT_POINT])
    found += pa.run_audit(single + sharded, dev, runs=runs)
    found += record(single, [bench, headline])
    found += record(sharded, [headline])
    budget, label = ma.budget_bytes(dev)
    entries = {}
    for rep in reports:
        run = runs[(rep.entry, rep.point, str(dev))]
        entries.setdefault(rep.entry, {})[rep.point] = dict(
            peak_bytes=rep.peak_bytes, base_bytes=rep.base_bytes,
            headroom_bytes=budget - rep.peak_bytes, syncs=rep.syncs,
            sync_debug=run.sync_debug, rounds=rep.rounds, transfers=rep.transfers,
            round_move_bytes=rep.round_move_bytes, planes=rep.planes, ms=run.ms)
    gaps = {f"{k[0]}@{k[1]}": [len(r.rec.syncs), r.sync_debug]
            for k, r in runs.items() if r.rec is not None and len(r.rec.syncs) != r.sync_debug}
    emit("audit", seconds=time.perf_counter() - t0, budget_bytes=budget, budget=label,
         points={sp.name: dict(T=sp.T, N=sp.N, P=sp.P, R=sp.R)
                 for sp in (pa.AUDIT_POINT, bench, headline)},
         programs=len(single), sharded_programs=len(sharded), mesh=str(mesh),
         findings=[f.render() for f in found], sync_gaps=gaps, entries=entries)
    if found:
        fail(f"audit: {len(found)} finding(s): {[f.render() for f in found][:5]}")
    if gaps:
        fail(f"audit: recorded syncs differ from the sync-debug count: {gaps}")


def phase_lockdep():
    """The port's lock checker on the card (``testing/lock_drive.py``): with
    the checker and the guarded-access corroborator installed, the
    standalone server at mid size takes the cluster over HTTP, runs the
    pipelined ``run_forever`` over single-pod arrivals (every other one with
    MinResources, so the gate launches), answers ``/v1/whatif`` through the
    batcher and the lease, and a follower on the card applies its
    publisher's records and answers from its own plane.  No violation, the
    four hot structures instrumented, K1, K2 and the gate launched under the
    checker.  Then tiers A and D over the installed package tree: no
    finding."""
    from kube_batch_tpu_torch.analysis.engine import iter_python_files, run_paths
    from kube_batch_tpu_torch.analysis.races import RACE_RULES
    from kube_batch_tpu_torch.analysis.rules import ALL_RULES
    import kube_batch_tpu_torch
    from kube_batch_tpu_torch.testing.lock_drive import drive_lockdep

    t_phase = time.perf_counter()
    r = drive_lockdep(MID_TASKS, MID_NODES, device="cuda")
    emit("lockdep", shape=[MID_TASKS, MID_NODES], **r)
    if r["violations"]:
        fail(f"lockdep: {r['violations']} violation(s): {r['violation_descriptions']}")
    if r["guarded"] != 4:
        fail(f"lockdep: {r['guarded']} of 4 hot structures instrumented")
    if not all(r["launches"][k] for k in KERNELS):
        fail(f"lockdep: a kernel was not launched under the checker: {r['launches']}")
    t0 = time.perf_counter()
    tree = os.path.dirname(kube_batch_tpu_torch.__file__)
    found = run_paths([tree], rules=list(ALL_RULES) + list(RACE_RULES))
    emit("static", tiers="A+D", tree=tree,
         files=sum(1 for _ in iter_python_files([Path(tree)])),
         rules=len(ALL_RULES) + len(RACE_RULES), findings=[f.render() for f in found],
         seconds=time.perf_counter() - t0, phase_s=time.perf_counter() - t_phase)
    if found:
        fail(f"static: {len(found)} finding(s): {[f.render() for f in found][:5]}")
    return r["launches"]


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


def _mid_evict_cluster(n_running=2048, n_pending=1536, n_nodes=MID_NODES, n_high=128):
    """An overcommitted cluster (by default 4 096 tasks × 1 024 nodes): q0
    fills every node's cpu, q1 waits (reclaim's claimants), and ``n_high``
    high-priority q0 gangs wait too (preempt's)."""
    from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Pod, PodGroup
    from kube_batch_tpu_torch.api.types import PodPhase
    from kube_batch_tpu_torch.testing.synthetic import synthetic_overcommit_cluster

    cache = synthetic_overcommit_cluster(n_running=n_running, n_pending=n_pending,
                                         n_nodes=n_nodes)
    for j in range(n_high):
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
    return counts, res


def _shard_mesh(task_shards: int = 1):
    """SHARDS positions: distinct cards when there are that many, else
    SHARDS shards of the one card (``testing/dryrun.mesh_devices``)."""
    from kube_batch_tpu_torch.parallel.mesh import make_mesh
    from kube_batch_tpu_torch.testing.dryrun import mesh_devices

    return make_mesh(mesh_devices(SHARDS, "cuda"), task_shards=task_shards)


def _timed_solve(fn):
    from kube_batch_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t) * 1e3, dict(kernels.launches)


def _differs(a, b, skip=()):
    return [f for f, x, y in zip(a._fields, a, b)
            if f not in skip and not same([x], [y])]


def _overcommit_snapshot():
    """The overcommit drive's cluster (40 000 running, 20 000 pending on
    5 000 nodes) with 625 high-priority q0 gangs waiting too (the mid
    cluster's share: preempt's claimants), as its first session's device
    snapshot, with reclaim's and preempt's solve configurations."""
    from kube_batch_tpu_torch import plugins as _plugins  # noqa: F401 — registers
    from kube_batch_tpu_torch.actions.reclaim import evict_config
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
    from kube_batch_tpu_torch.framework.conf import load_scheduler_conf, shipped_conf_path
    from kube_batch_tpu_torch.framework.session import close_session, open_session

    cache = _mid_evict_cluster(OC_RUNNING, OC_PENDING, N_NODES, n_high=625)
    conf = load_scheduler_conf(shipped_conf_path())
    ssn = open_session(cache, conf.tiers, "cpu")
    ssn.action_names = list(conf.actions)
    try:
        snap, _meta = cache.columns.device_snapshot(ssn)
        cfgs = {mode: evict_config(ssn, mode) for mode in ("reclaim", "preempt")}
    finally:
        close_session(ssn)
    return snapshot_from_numpy(snap, "cuda"), cfgs


def phase_shard(snap, config, full, topk, k1_ms, k2_ms):
    """The sharded solves at 50k × 5k on a SHARDS-position mesh (module
    docstring), each held against its single-device twin on the card,
    every field; per-shard K1 and K2 held against their plain versions at
    a nonzero shard origin and timed beside the unsharded ones."""
    from kube_batch_tpu_torch.ops import kernels
    from kube_batch_tpu_torch.ops.assignment import (
        allocate_solve, allocate_topk_solve, score_matrix, static_predicates,
    )
    from kube_batch_tpu_torch.ops.eviction import evict_solve
    from kube_batch_tpu_torch.ops.scoring import ScoreWeights
    from kube_batch_tpu_torch.parallel import shard_solve
    from kube_batch_tpu_torch.parallel.mesh import (
        collective_stats, place_snapshot, sharded_allocate_solve,
        sharded_allocate_topk_solve, sharded_evict_solve,
    )

    k1n, k2n, _gate = KERNELS
    t_phase = time.perf_counter()
    mesh = _shard_mesh()
    T, N = snap.task_req.shape[0], snap.node_idle.shape[0]
    out = dict(devices=[str(d) for d in mesh.devices], devices_distinct=mesh.devices_distinct,
               mesh=dict(mesh.shape))
    launches = {}
    ss = place_snapshot(snap, mesh)
    # the full solve: K1 per shard each round
    res, wall, n = _timed_solve(lambda: sharded_allocate_solve(ss, config))
    rounds = int(res.rounds_run)
    bad = _differs(res, full)
    if bad:
        fail(f"shard full: differs from the single-device solve in {bad}")
    if n[k1n] != SHARDS * rounds:
        fail(f"shard full: K1 launches {n[k1n]} != {SHARDS} shards x {rounds} rounds")
    launches["full"] = n
    _single, single_wall, _ = _timed_solve(lambda: allocate_solve(snap, config))
    shard_solve.TIME_COLLECTIVES = True
    try:
        _timed_solve(lambda: sharded_allocate_solve(ss, config))
    finally:
        shard_solve.TIME_COLLECTIVES = False
    moved = shard_solve.last_collectives["allocate"].summary()
    stats = collective_stats(mesh, config, snap)
    if (moved["per_round_bytes"], moved["per_solve_bytes"]) != (
            stats["per_round_bytes"], stats["per_solve_bytes"]):
        fail(f"shard full: moved {moved} against collective_stats {stats}")
    out["full"] = dict(rounds=rounds, placed=int((res.assigned >= 0).sum()), wall_ms=wall,
                       single_device_wall_ms=single_wall, launches=n,
                       collectives=moved, equal="every field")
    del res, _single
    # the compacted solve: K2 per shard, merged once
    rows = torch.nonzero(snap.task_pending).flatten().to(torch.int32)
    pend_rows = torch.full((T,), -1, dtype=torch.int32, device=rows.device)
    pend_rows[: rows.numel()] = rows
    cfg_k = config._replace(topk=TOPK)
    res, wall, n = _timed_solve(lambda: sharded_allocate_topk_solve(ss, pend_rows, cfg_k))
    bad = _differs(res, topk)
    if bad:
        fail(f"shard compacted: differs from the single-device compacted solve in {bad}")
    if n[k2n] != SHARDS:
        fail(f"shard compacted: K2 launches {n[k2n]} != {SHARDS}")
    _t, single_wall, _ = _timed_solve(lambda: allocate_topk_solve(snap, pend_rows, cfg_k))
    moved = shard_solve.last_collectives["topk"].summary()
    stats = collective_stats(mesh, cfg_k, snap, pend_bucket=T)
    if stats["per_round_bytes"] != 0 or moved["per_round_bytes_total"] != 0 \
            or moved["per_solve_bytes"] != stats["per_solve_bytes"]:
        fail(f"shard compacted: moved {moved} against collective_stats {stats}")
    launches["compacted"] = n
    out["compacted"] = dict(wall_ms=wall, single_device_wall_ms=single_wall, launches=n,
                            collectives=moved, topk_reentries=int(res.topk_reentries),
                            equal="every field")
    del res, _t, ss
    # the (tasks=2, nodes=2) grid
    mesh2 = _shard_mesh(task_shards=2)
    ss2 = place_snapshot(snap, mesh2)
    res, wall, n = _timed_solve(lambda: sharded_allocate_solve(ss2, config))
    bad = _differs(res, full)
    if bad:
        fail(f"shard 2x2: differs from the single-device solve in {bad}")
    if n[k1n] != SHARDS * int(res.rounds_run):
        fail(f"shard 2x2: K1 launches {n[k1n]} for {int(res.rounds_run)} rounds")
    launches["full_2x2"] = n
    out["full_2x2"] = dict(mesh=dict(mesh2.shape), wall_ms=wall, launches=n,
                           collectives=shard_solve.last_collectives["allocate"].summary(),
                           equal="every field")
    del res, ss2
    # per-shard K1 and K2 at the second shard's origin, against their plain
    # versions, timed beside the unsharded kernels
    score = score_matrix(snap, ScoreWeights())
    static_ok = static_predicates(snap)
    s = N // SHARDS
    k1s = k1_case(snap, score, static_ok, n0=s, cols=slice(s, 2 * s))
    del score, static_ok
    r1 = run_case(kernels.masked_best_node_raw, kernels.masked_best_node_raw_plain,
                  k1s, reps=20, plain_reps=1)
    b1 = k1_bound(k1s)
    del k1s
    k2s = k2_case(snap, T)
    k2s = dict(k2s, score_static=k2s["score_static"][:, s:2 * s].contiguous(),
               idle=k2s["idle"][s:2 * s].contiguous(),
               releasing=k2s["releasing"][s:2 * s].contiguous(), n0=s)
    r2 = run_case(kernels.masked_topk_blocks, kernels.masked_topk_blocks_plain,
                  k2s, reps=10, plain_reps=1)
    b2 = k2_bound(k2s)
    del k2s
    out["kernels_per_shard"] = {
        "K1": dict(shape=[T, s], n0=s, **r1, bound_ms=b1[0], bound_by=b1[1],
                   unsharded_ms=k1_ms, unsharded_shape=[T, N]),
        "K2": dict(shape=[T, s], n0=s, **r2, bound_ms=b2[0], bound_by=b2[1],
                   unsharded_ms=k2_ms, unsharded_shape=[T, N]),
    }
    # reclaim's and preempt's solves on the overcommit snapshot
    oc, cfgs = _overcommit_snapshot()
    ss_oc = place_snapshot(oc, mesh)
    for mode, cfg in cfgs.items():
        (one, one_rounds), one_wall, _n = _timed_solve(lambda: evict_solve(oc, cfg))
        (res, r_rounds), wall, n = _timed_solve(lambda: sharded_evict_solve(ss_oc, cfg))
        bad = _differs(res, one)
        if bad or r_rounds != one_rounds:
            fail(f"shard {mode}: differs from the single-device solve in {bad}, rounds "
                 f"{r_rounds} / {one_rounds}")
        if int((res.claim_node >= 0).sum()) == 0:
            fail(f"shard {mode}: no claim")
        out[mode] = dict(shape=[int(oc.task_req.shape[0]), int(oc.node_idle.shape[0])],
                         claims=int((res.claim_node >= 0).sum()),
                         evicted=int(res.evicted.sum()), rounds=r_rounds, wall_ms=wall,
                         single_device_wall_ms=one_wall,
                         collectives=shard_solve.last_collectives["evict"].summary(),
                         equal="every field")
    del oc, ss_oc
    emit("shard", tolerance="bit-exact", seconds=time.perf_counter() - t_phase, **out)
    return launches, out["kernels_per_shard"]


def phase_shard_cycles(cycle):
    """The headline drive's cycles 1–3 through ``Scheduler(mesh=...)``, and
    with ``KB_SHARD_MAP=0`` (the ``"pjit"`` oracle): each cycle's digest
    must equal the single-device drive's (``phase_cycle``); the mesh's
    gate against the single-device gate; the two-process rehearsal."""
    from kube_batch_tpu_torch.parallel.mesh import dispatch_enqueue_gate
    from kube_batch_tpu_torch.testing.cycle_drive import drive
    from kube_batch_tpu_torch.testing.dryrun import rehearse

    t_phase = time.perf_counter()
    mesh = _shard_mesh()
    want = [c["digest"] for c in cycle["cycles"]]
    legs = {}
    for leg, env in (("shard_map", None), ("pjit", "0")):
        old = os.environ.get("KB_SHARD_MAP")
        if env is not None:
            os.environ["KB_SHARD_MAP"] = env
        try:
            r = drive(N_TASKS, N_NODES, ARRIVALS, device="cuda", mesh=mesh)
        finally:
            if old is None:
                os.environ.pop("KB_SHARD_MAP", None)
            else:
                os.environ["KB_SHARD_MAP"] = old
        got = [c["digest"] for c in r["cycles"]]
        if got != want:
            fail(f"shard cycles {leg}: digests {got} != the single-device drive's {want}")
        if any(c["solve_mode"] != "sharded" for c in r["cycles"] if c["mode"] != "idle"):
            fail(f"shard cycles {leg}: a cycle did not solve sharded")
        legs[leg] = [dict(cycle=c["cycle"], mode=c["mode"], solve_mode=c["solve_mode"],
                          new_binds=c["new_binds"], wall_ms=c["wall_ms"],
                          single_device_wall_ms=s["wall_ms"], launches=c["launches"],
                          gate_rows=c["enqueue"]["gate_rows"], resident=c["resident"],
                          digest=c["digest"])
                     for c, s in zip(r["cycles"], cycle["cycles"])]
    k1n, k2n, gaten = KERNELS
    c1, c2, c3 = legs["shard_map"]
    if c1["launches"][k1n] == 0 or c2["launches"][k2n] == 0 or c3["launches"][gaten] == 0:
        fail(f"shard cycles: launches {[c['launches'] for c in legs['shard_map']]}")
    # the gate on the mesh against the gate on the inputs' device
    inp = gate_tensors(gate_case(), torch.device("cuda"))
    args = (inp["min_res"], inp["cand"], inp["idle0"], inp["quanta"])
    one = gate_kernel(**inp)[0]
    got = dispatch_enqueue_gate(*args, n_nodes_padded=N_NODES, mesh=mesh,
                                n_rows=inp["n_rows"])
    if not same([got], [one]):
        fail("shard gate: the mesh's gate differs from the single-device gate")
    dist = rehearse(2, "cuda", 2)
    emit("shard_cycles", equal="binds digests, every cycle, both legs", legs=legs,
         gate=dict(equal="bit-exact", admitted=int(got.sum())), distributed=dist,
         seconds=time.perf_counter() - t_phase)
    return {name: {f"{leg}_cycle{c['cycle']}": c["launches"][name]
                   for leg in legs for c in legs[leg]} for name in KERNELS}


def phase_solve_card_vs_cpu(snap, config, card):
    """The card's full solve of the 50k snapshot (``phase_solve_full``'s
    result) against the plain solve of the same snapshot on the CPU:
    every field equal.  A flip is a fault (ROADMAP Queue 3)."""
    from kube_batch_tpu_torch.actions.allocate import dispatch_allocate_solve
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy, snapshot_to_numpy

    cpu_snap = snapshot_from_numpy(snapshot_to_numpy(snap), "cpu")
    t = time.perf_counter()
    cpu, mode, info, _g = dispatch_allocate_solve(cpu_snap, config)
    cpu_s = time.perf_counter() - t
    if info is not None:
        fail(f"solve_card_vs_cpu: the CPU dispatch took compaction {info}")
    bad = [f for f, x, y in zip(card._fields, card, cpu) if not same([x], [y])]
    if bad:
        fail(f"solve_card_vs_cpu: the card's full solve differs from the CPU's in {bad}")
    emit("solve_card_vs_cpu", shape=[N_TASKS, N_NODES], equal="every field, bit-exact",
         placed=int((cpu.assigned >= 0).sum()), rounds_run=int(cpu.rounds_run),
         cpu_plain_s=cpu_s)


def phase_server(cycle):
    """The standalone server at 50k × 5k on the card, in this process
    (``server_drive.drive_server``; module docstring)."""
    from kube_batch_tpu_torch.testing.server_drive import drive_server

    r = drive_server(N_TASKS, N_NODES, ARRIVALS, device="cuda")
    k1, k2, _gate = KERNELS
    if r["device"] != "cuda":
        fail(f"server: the server came up on {r['device']}")
    if r["bindings_digest"] != cycle["cycle1_bindings_digest"]:
        fail(f"server: cycle 1's /v1/bindings {r['bindings_digest']} != the headline "
             f"drive's cycle 1 {cycle['cycle1_bindings_digest']}")
    if not r["launches"][k1] or not r["launches"][k2]:
        fail(f"server: the cycles did not launch K1 and K2: {r['launches']}")
    if not r["follower"]["k1_launches"]:
        fail("server: the HTTP follower's probes launched no K1")
    if not r["arrivals_bound"]:
        fail("server: no arrival bound")
    emit("server", conf="shipped", shape=[N_TASKS, N_NODES],
         bindings_equal_to_cycle="cycle 1", whatif_equal="HTTP = QueryPlane.submit, "
         "follower over HTTP = leader, byte for byte", **r)
    return r


def phase_server_process():
    """``python -m kube_batch_tpu_torch.cmd.main`` as subprocesses on the card
    at 4 096 × 1 024 (``server_drive.drive_server_process``)."""
    from kube_batch_tpu_torch.testing.server_drive import drive_server_process

    r = drive_server_process(MID_TASKS, MID_NODES, device="cuda")
    emit("server_process", conf="shipped", shape=[MID_TASKS, MID_NODES], **r)
    return r


def phase_k8s(cycle, stub):
    """The ``--master`` server at 50k × 5k on the card against the stub
    apiserver ``stub``, preloaded since the script started
    (``k8s_drive.drive_k8s``; module docstring)."""
    from kube_batch_tpu_torch.testing.k8s_drive import drive_k8s

    r = drive_k8s(N_TASKS, N_NODES, ARRIVALS, device="cuda", stub=stub)
    k1, k2, gate = KERNELS
    if r["device"] != "cuda":
        fail(f"k8s: the server came up on {r['device']}")
    if r["cycle1_bindings_digest"] != cycle["cycle1_bindings_digest"]:
        fail(f"k8s: cycle 1's acked binds {r['cycle1_bindings_digest']} != the headline "
             f"drive's cycle 1 {cycle['cycle1_bindings_digest']}")
    if not r["cycle1"]["launches"][k1]:
        fail(f"k8s: cycle 1 launched no K1: {r['cycle1']['launches']}")
    if r["binds"]["posts"] < N_TASKS:
        fail(f"k8s: {r['binds']['posts']} Binding POSTs of {N_TASKS} on the stub")
    after = r["launches_after_cycle1"]
    if not r["arrivals_bound"] or not after[k2] or not after[gate]:
        fail(f"k8s: {r['arrivals_bound']} arrivals bound, launches after cycle 1 {after}")
    emit("k8s", conf="shipped", shape=[N_TASKS, N_NODES],
         bindings_equal_to_cycle="cycle 1", **r)
    return r


def phase_cycle():
    """Three cycles of the shipped conf at 50k × 5k on the card; cycle 1's
    binds digest is kept for the server phase."""
    from kube_batch_tpu_torch.testing.cycle_drive import drive
    from kube_batch_tpu_torch.testing.server_drive import bindings_digest

    r = drive(N_TASKS, N_NODES, ARRIVALS, device="cuda", keep_states=True)
    states = r.pop("states")
    r["cycle1_bindings_digest"] = bindings_digest(states[0]["binds"])
    del states
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
    """The steady-state drive at 50k × 5k on the card, six legs (module
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


def phase_trace_steady(legs):
    """The steady legs' traces, read back (module docstring)."""
    t = legs["defaults"]["trace"]
    cycles = legs["defaults"]["cycles"]
    if t["chrome_errors"] != [] or not t["enabled"] or t["records"] != len(cycles):
        fail(f"trace_steady: the defaults leg's ring {t['records']} records, "
             f"export {t['chrome_errors']}")
    inside = {name: sum(c["trace"]["dispatch_launches"].get(name, 0) for c in cycles)
              for name in KERNELS}
    if not inside["masked_best_node_raw"] or not inside["masked_topk_blocks"]:
        fail(f"trace_steady: K1 / K2 not launched inside solve_dispatch spans: {inside}")
    samples = sum(c["trace"]["decisions"] for c in cycles)
    if t["e2e"] != t["cycles_run"] or t["decisions"] != samples \
            or samples != t["binds_acked"]:
        fail(f"trace_steady: e2e {t['e2e']} of {t['cycles_run']} cycles; decisions "
             f"{t['decisions']} / sink {samples} / binds acked {t['binds_acked']}")
    pipe, untraced = legs["pipelined"]["trace"], legs["untraced"]["trace"]
    if not pipe["overlap"]:
        fail("trace_steady: no writeback span overlapped the next cycle's compute")
    if pipe["chrome_errors"] != []:
        fail(f"trace_steady: the pipelined leg's export {pipe['chrome_errors'][:3]}")
    if untraced["enabled"] or untraced["records"] or untraced["e2e"] != untraced["cycles_run"]:
        fail(f"trace_steady: the untraced leg kept {untraced['records']} records, "
             f"e2e {untraced['e2e']}")
    per_cycle = [{k: c["trace"][k] for k in ("dispatch_launches", "decisions",
                                               "decision_observe_ms")} for c in cycles]
    emit("trace_steady", tasks=N_TASKS, nodes=N_NODES,
         defaults={k: v for k, v in t.items() if k != "overlap"},
         solve_dispatch_launches=inside, per_cycle=per_cycle,
         ring_bytes_at_capacity=dict(
             steady=float(np.median(t["ring"]["bytes_per_record"][1:])) * t["ring"]["capacity"],
             cycle1=t["ring"]["bytes_per_record"][0] * t["ring"]["capacity"]),
         pipelined_overlap=pipe["overlap"],
         pipelined_spans_per_cycle=pipe["spans_per_cycle"],
         untraced=dict(records=untraced["records"], e2e=untraced["e2e"],
                       decisions=untraced["decisions"]))
    return inside


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
         alert=r["alert"], flight=r["flight"],
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


def phase_matrix(device="cuda"):
    """The benchmark matrix (``testing/benchmark.py``): every case of
    ``build_cases()`` at full width on the card, with the kernels each
    launched (counted from 0 around the case's run); the two small device
    cases are solved again from the case's own inputs on the card and on
    the CPU, and must assign bit for bit alike.  ``device="cpu"`` rehearses
    the control flow (launches read 0 there)."""
    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
    from kube_batch_tpu_torch.ops import kernels
    from kube_batch_tpu_torch.ops.assignment import allocate_solve
    from kube_batch_tpu_torch.testing.benchmark import build_cases

    t_phase = time.perf_counter()
    k1, k2, _gate = KERNELS
    cases = []
    for case in build_cases(device):
        kernels.reset_launches()
        t0 = time.perf_counter()
        r = case.run(MATRIX_CYCLES)
        seconds = time.perf_counter() - t0
        launched = {k: kernels.launches[k] for k in KERNELS}
        kind = ("device" if case.inputs is not None
                else "overcommit" if "evicted" in r else "startup")
        entry = dict(config=case.name, kind=kind, **r, launches=launched,
                     seconds=seconds)
        if not any(launched.values()):
            fail(f"matrix: {case.name} launched no kernel")
        if kind == "device" and (r["placed"] == 0 or launched[k1] == 0):
            fail(f"matrix: {case.name} placed {r['placed']}, launches {launched}")
        # one overcommit cycle has no kubelet: the claimants pipeline onto
        # the victims' Releasing capacity and bind nothing yet (placed 0,
        # as in the JAX package's case)
        if kind == "overcommit" and r["evicted"] == 0:
            fail(f"matrix: {case.name} evicted nothing")
        if kind == "startup" and r["scheduled"] < r["pods"]:
            fail(f"matrix: {case.name} scheduled {r['scheduled']} of {r['pods']} pods")
        if case.name in MATRIX_CARD_VS_CPU:
            fields, meta, config = case.inputs()
            card = allocate_solve(snapshot_from_numpy(fields, device),
                                  config).assigned.cpu().numpy()
            cpu = allocate_solve(snapshot_from_numpy(fields, "cpu"),
                                 config).assigned.numpy()
            if not np.array_equal(card, cpu):
                fail(f"matrix: {case.name}: the card and the CPU assign "
                     f"{int((card != cpu).sum())} rows differently")
            entry["card_vs_cpu"] = dict(assigned_equal=True,
                                        placed=int((cpu[:meta.n_tasks] >= 0).sum()))
        cases.append(entry)
    if device == "cuda" and not any(c["launches"][k2] for c in cases
                                    if c["kind"] != "device"):
        fail("matrix: no cycle case launched K2")
    emit("matrix", cycles=MATRIX_CYCLES, cases=cases,
         worst_p99_ms=max(c["p99_ms"] for c in cases),
         seconds=time.perf_counter() - t_phase)
    return cases


def host_cpu_model() -> str:
    """The host's CPU as ``/proc/cpuinfo`` names it: the model name where
    it gives one, with the vendor, family, model, stepping and clock (a
    virtualised kernel may report the model name as "unknown"; Arm's
    cpuinfo has implementer and part instead)."""
    import platform

    keys = ("model name", "vendor_id", "cpu family", "model", "stepping",
            "cpu MHz", "CPU implementer", "CPU part")
    first = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                if first:
                    break
                continue
            k, _, v = line.partition(":")
            if k.strip() in keys:
                first.setdefault(k.strip(), v.strip())
    named = [f"{k} {first[k]}" for k in keys if first.get(k)]
    return ", ".join(named) or platform.machine()


def phase_go_loop(cycle):
    """The Go-loop denominator on the card's host
    (``testing/go_baseline.py``, ``testing/go_pass_bench.py``): the
    sequential allocate loop over the headline workload in numpy, in C on
    one thread and in C on a 16-thread pool (the C library built from
    ``native/go_pass.c`` into ``kube_batch_tpu_torch/build/``), which must
    place alike; then the per-task pass timed three ways, which must pick
    alike.  Each leg is set against the headline drive's cycle 1 wall."""
    from kube_batch_tpu_torch import native
    from kube_batch_tpu_torch.testing.go_baseline import run_go_baseline
    from kube_batch_tpu_torch.testing.go_pass_bench import measure

    t0 = time.perf_counter()
    lib = native.build()
    stats = run_go_baseline(N_TASKS, N_NODES, GANG, N_QUEUES)
    diverged = {k: v for k, v in stats.items() if k.endswith("_divergence")}
    if diverged:
        fail(f"go_loop: the C legs' placements differ from numpy's: {diverged}")
    legs = {"numpy": dict(ms=stats["elapsed_ms"], placed=stats["placed"])}
    for leg in ("native_single", "native_pooled"):
        legs[leg] = dict(ms=stats[f"{leg}_ms"], placed=stats[f"{leg}_placed"])
    micro = measure(N_NODES)  # raises if the picks differ
    cycle1_ms = cycle["cycles"][0]["wall_ms"]
    emit("go_loop", shape=[stats["n_tasks"], stats["n_nodes"]], legs=legs,
         threads=micro["threads"], cycle1_wall_ms=cycle1_ms,
         ratio_to_cycle1={k: v["ms"] / cycle1_ms for k, v in legs.items()},
         pass_us=micro, floor_holds=micro["floor_holds"],
         library=str(lib.relative_to(Path(__file__).resolve().parent)),
         host_cpu=host_cpu_model(), cpu_count=os.cpu_count(),
         seconds=time.perf_counter() - t0)


def phase_sim(device="cuda"):
    """The virtual-time simulator on the card (``testing/sim_drive.py``;
    module docstring).  ``device="cpu"`` rehearses the phase's control
    flow on the CPU at a size set by ``SIM_*``."""
    import contextlib
    import io
    import shutil
    import tempfile

    from kube_batch_tpu_torch.ops import kernels
    from kube_batch_tpu_torch.sim.__main__ import main as sim_main
    from kube_batch_tpu_torch.testing.sim_drive import (
        DIGESTS, PRESETS, Child, cli_args, drive_sim, run_presets)

    def cli(argv):
        """The simulator's CLI in this process: its exit code and JSON."""
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = sim_main(argv, device=device)
        return rc, json.loads(out.getvalue())

    k1, k2, _gate = KERNELS
    work = tempfile.mkdtemp(prefix="kb-sim-")
    # the CPU oracle of every preset, and the CLI on the card, each in a
    # process of its own while this process runs the presets on the card
    cpu = Child("presets-cpu", ["-m", "kube_batch_tpu_torch.testing.sim_drive",
                                "--presets", "--device", "cpu"], work,
                KB_GUARD_DIR=os.path.join(work, "guard-cpu"), OMP_NUM_THREADS="2")
    entry = Child("cli", cli_args(["--preset", "smoke", "--seed", "0"], device), work,
                  KB_GUARD_DIR=os.path.join(work, "guard-cli"))
    # this process's bundles (the last phase: nothing after it reads the dir)
    os.environ["KB_GUARD_DIR"] = os.path.join(work, "guard-card")
    try:
        t0 = time.perf_counter()
        card = run_presets(device=device)
        presets_s = time.perf_counter() - t0
        failed = [n for n, r in card.items() if not r["exit_ok"]]
        if failed:
            fail(f"sim: presets {failed} failed the CLI's exit criteria on {device}")
        # --warm-ab on warm-churn (both legs counted), then the replay
        kernels.reset_launches()
        rc, ab = cli(["--preset", "warm-churn", "--seed", "0", "--warm-ab"])
        ab_launches = dict(kernels.launches)
        if rc or not ab["binds_match"] or not ab["warm_engaged"]:
            fail(f"sim: --warm-ab exit {rc}: {ab}")
        bundles = card["corruption"]["bundles"]
        if not bundles:
            fail("sim: the corruption run wrote no bundle")
        rc, replay = cli(["--replay-bundle", bundles[0]])
        if rc or not replay["reproduced"] or \
                torch.device(replay["device"]).type != torch.device(device).type:
            fail(f"sim: --replay-bundle exit {rc}: {replay}")
        rc, out = cpu.finish(600)
        if rc:
            fail(f"sim: the CPU presets exited {rc}: {cpu.stderr_tail()}")
        oracle = json.loads(out.strip().splitlines()[-1])
        diverged = {n: {k: (card[n][k], oracle[n][k]) for k in DIGESTS
                        if card[n][k] != oracle[n][k]}
                    for n in card}
        diverged = {n: d for n, d in diverged.items() if d}
        if diverged:
            fail(f"sim: the card and the CPU ran presets differently: {diverged}")
        rc, out = entry.finish(300)
        if rc:
            fail(f"sim: python -m kube_batch_tpu_torch.sim exited {rc}: {entry.stderr_tail()}")
        cli_report = json.loads(out)
        if cli_report["trace_sha256"] != card["smoke"]["trace_sha256"]:
            fail("sim: the CLI process's smoke run differs from this process's")
    finally:
        cpu.stop()
        entry.stop()
    # the 50k drive, each leg's launches counted from 0
    drive = drive_sim(SIM_NODES, SIM_GANGS, SIM_CYCLES, device=device)
    for leg, r in drive["legs"].items():
        for i, c in enumerate(r["cycles"]):
            emit("sim_cycle", leg=leg, cycle=i, t=c["t"], wall_ms=c["wall_ms"],
                 **{k: c[k] for k in ("apply_ms", "run_once_ms", "kubelet_ms", "sample_ms")},
                 scheduler_ms=c["scheduler_ms"], stages_ms=c["stages_ms"],
                 pending=c["pending"],
                 running=c["running"], trace_lines=c["trace_lines"],
                 k1_launches=c["launches"][k1], k2_launches=c["launches"][k2],
                 topk=c["topk"], warm=c["warm"])
    sim_launches = {name: {**{p: r["launches"][name] for p, r in card.items()},
                           "warm_ab": ab_launches[name],
                           **{f"drive_{leg}": r["launches"][name]
                              for leg, r in drive["legs"].items()}}
                    for name in KERNELS}
    if device != "cpu" and (not sum(sim_launches[k1].values())
                            or not sum(sim_launches[k2].values())
                            or not drive["legs"]["defaults"]["launches"][k2]):
        fail(f"sim: the simulator did not launch K1 and K2: {sim_launches}")
    vt = {leg: {m: {q: r["report"][m][q] for q in ("p50", "p99", "n")}
                for m in ("wait_vt", "jct_vt", "pod_bind_latency_vt")}
          for leg, r in drive["legs"].items()}
    shutil.rmtree(work, ignore_errors=True)
    emit("sim", presets={n: {k: v for k, v in r.items() if k != "bundles"}
                         for n, r in card.items()},
         presets_s=presets_s, presets_equal_cpu=list(DIGESTS),
         cpu_presets_s=cpu.seconds, warm_ab=ab, replay=replay,
         cli={"exit": 0, "seconds": entry.seconds, "metric": cli_report["metric"],
              "value": cli_report["value"]},
         drive={"nodes": drive["nodes"], "pods": drive["pods"], "cycles": drive["cycles"],
                "legs": {leg: {"wall_s": r["wall_s"], "launches": r["launches"],
                               **{k: r["report"][k] for k in (
                                   "jobs", "binds", "topk", "warm", "makespan_vt",
                                   "snapshot_paths", "bind_digest")}}
                         for leg, r in drive["legs"].items()},
                "vt": vt},
         sim_launches=sim_launches)
    return sim_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from kube_batch_tpu_torch.testing.k8s_drive import StubProcess

    # the k8s phase's apiserver, a process of its own with no card,
    # preloads the 50 000-pod cluster while the other phases run
    stub = StubProcess(N_TASKS, N_NODES)
    try:
        return run_phases(stub)
    finally:
        stub.stop()


def run_phases(stub) -> int:
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    smi = phase_device()
    phase_build()
    phase_audit()
    lockdep_launches = phase_lockdep()
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
    topk_launches, topk_res = phase_solve_topk(snap, config, full["homogeneous"])
    phase_solve_card_vs_cpu(snap, config, full["homogeneous"])
    shard_launches, shard_k = phase_shard(snap, config, full["homogeneous"], topk_res,
                                 kern["K1"]["ms"], kern[f"K2_P{snap.task_req.shape[0]}"]["ms"])
    del topk_res
    T = snap.task_req.shape[0]
    # the cycles reuse the caching allocator's blocks, as a long-running
    # scheduler process does
    del snap, snaps, full
    cycle = phase_cycle()
    shard_cycle_launches = phase_shard_cycles(cycle)
    overcommit = phase_cycle_overcommit()
    steady, rerank_rungs = phase_cycle_steady()
    traced_launches = phase_trace_steady(steady)
    loop = phase_loop()
    phase_guard()
    features = phase_cycle_features()
    phase_cycle_cross_device()
    whatif, whatif_launches = phase_whatif(kern["K1"], steady["defaults"]["steady"])
    replicate = phase_replicate()
    server = phase_server(cycle)
    phase_server_process()
    k8s = phase_k8s(cycle, stub)
    matrix = phase_matrix()
    phase_go_loop(cycle)
    sim_launches = phase_sim()
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

    matrix_launches = {name: {c["config"]: c["launches"][name] for c in matrix}
                       for name in KERNELS}
    k8s_launches = {name: {"cycle1": k8s["cycle1"]["launches"][name],
                           "after_cycle1": k8s["launches_after_cycle1"][name]}
                    for name in KERNELS}

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
             traced_solve_dispatch_launches=traced_launches["masked_best_node_raw"],
             pipelined_steady_launches=pipelined_launches["masked_best_node_raw"],
             loop_launches=loop_launches["masked_best_node_raw"],
             features_launches=features_launches["masked_best_node_raw"],
             whatif_launches=whatif_launches,
             replicate_follower_launches=replicate["follower_k1_launches"],
             server_launches=server["launches"]["masked_best_node_raw"],
             server_follower_launches=server["follower"]["k1_launches"],
             k8s_launches=k8s_launches["masked_best_node_raw"],
             matrix_launches=matrix_launches["masked_best_node_raw"],
             sim_launches=sim_launches["masked_best_node_raw"],
             lockdep_launches=lockdep_launches["masked_best_node_raw"],
             shard_launches={"full": shard_launches["full"]["masked_best_node_raw"],
                             "full_2x2": shard_launches["full_2x2"]["masked_best_node_raw"],
                             **shard_cycle_launches["masked_best_node_raw"]},
             shard_ms=shard_k["K1"]["ms"], shard_shape=shard_k["K1"]["shape"],
             shard_bound_ms=shard_k["K1"]["bound_ms"],
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
             traced_solve_dispatch_launches=traced_launches["masked_topk_blocks"],
             pipelined_steady_launches=pipelined_launches["masked_topk_blocks"],
             loop_launches=loop_launches["masked_topk_blocks"],
             features_launches=features_launches["masked_topk_blocks"],
             server_launches=server["launches"]["masked_topk_blocks"],
             k8s_launches=k8s_launches["masked_topk_blocks"],
             matrix_launches=matrix_launches["masked_topk_blocks"],
             sim_launches=sim_launches["masked_topk_blocks"],
             lockdep_launches=lockdep_launches["masked_topk_blocks"],
             shard_launches={"compacted": shard_launches["compacted"]["masked_topk_blocks"],
                             **shard_cycle_launches["masked_topk_blocks"]},
             shard_ms=shard_k["K2"]["ms"], shard_shape=shard_k["K2"]["shape"],
             shard_bound_ms=shard_k["K2"]["bound_ms"],
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
             features_launches=features_launches["enqueue_gate"],
             server_launches=server["launches"]["enqueue_gate"],
             k8s_launches=k8s_launches["enqueue_gate"],
             matrix_launches=matrix_launches["enqueue_gate"],
             sim_launches=sim_launches["enqueue_gate"],
             lockdep_launches=lockdep_launches["enqueue_gate"],
             shard_launches=shard_cycle_launches["enqueue_gate"]),
    ]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
