"""The kernels on the card at the main path's shapes, against their bounds.

    python -m kube_batch_tpu_torch.testing.kernel_bench [--reps N]

Builds the 50k-pod × 5k-node synthetic snapshot (T 50 176 × N 5 120,
R 4), then times, with CUDA events after a warm-up:

  - K1 at the round-0 inputs (every real row pending) and at a late round
    (``pending`` cut to the first 10 % of the pending rows);
  - K2 at the compacted solve's buckets, P 8 192 and P 50 176;
  - the enqueue gate over 12 500 MinResources rows at capJ 16 384
    (``gate_case``), whose bound is its dependence chain.

Each case is first held bit-exact against its plain version.  Prints one
JSON line: per case the time, the bound (bytes over 3.35 TB/s or
operations over 67 TFLOP/s, whichever is larger) and the share of it
reached, beside the card's name and power limit from ``nvidia-smi``.
For an A/B of two trees in one call, run this file by path with
``PYTHONPATH=<other tree>`` (the gate case needs a tree that has
``ops/admission.py``).
``chip_smoke.py`` takes its cases and bounds from here.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

# memory rate and non-tensor-core f32 rate of one H100 SXM (NVIDIA's data
# sheet); the bound of a kernel is the larger of bytes / rate and ops / rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
LATE_ROUND_FRAC = 0.1
#: the least cycles one row of the enqueue gate takes on the dependence
#: chain.  Both outcomes of a row depend only on (idle, comp, m), so they
#: can be computed beside the fit test, and the verdict only picks one: the
#: function's shortest carried path is the admitted outcome's comp - m, t,
#: idle - t, + y and zeroing select, then the verdict's select (the fit's
#: eff, m - eff, FSETP, VOTE.ALL reach that select one step sooner) — six
#: dependent instructions, each at least the 4-cycle dependent-issue
#: latency of Hopper's fixed-latency pipes
GATE_CHAIN_CYCLES = 6 * 4
GATE_QUANTA = np.array([10.0, 10.0 * 2**20, 0.1, 10.0], np.float32)
GiB = float(2**30)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock (``clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def same(a, b) -> bool:
    """Bit-exact equality of two results (sequences of tensors)."""
    for x, y in zip(a, b):
        x, y = x.detach().cpu().numpy(), y.detach().cpu().numpy()
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
            return False
    return True


def max_abs_err(a, b) -> float:
    err = 0.0
    for x, y in zip(a, b):
        x = x.detach().cpu().numpy().astype(np.float64)
        y = y.detach().cpu().numpy().astype(np.float64)
        if x.size:
            err = max(err, float(np.max(np.abs(x - y))))
    return err


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def offset_copy(x: torch.Tensor, off: int = 1) -> torch.Tensor:
    """``x`` copied into a contiguous tensor that starts ``off`` elements
    into its storage, so that (for off > 0) its rows are not 16 B aligned."""
    flat = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    out = flat[off:].view(x.shape)
    out.copy_(x)
    return out


def k1_case(snap, score, static_ok, t0=0, n0=0, rows=None, cols=None):
    """K1's inputs at the round-0 state of ``snap`` (optionally a block)."""
    rows = slice(None) if rows is None else rows
    cols = slice(None) if cols is None else cols
    pending = (snap.task_pending & snap.task_valid)[rows].contiguous()
    return dict(
        score=score[rows, cols].contiguous(),
        static_ok=static_ok[rows, cols].contiguous(),
        task_req=snap.task_req[rows].contiguous(),
        idle=snap.node_idle[cols].contiguous(),
        releasing=snap.node_releasing[cols].contiguous(),
        pending=pending, quanta=snap.quanta, t0=t0, n0=n0,
    )


def late_round(k1, frac: float = LATE_ROUND_FRAC):
    """``k1`` with ``pending`` cut to the first ``frac`` of its pending
    rows, as a late bidding round sees it."""
    pend = k1["pending"]
    rows = torch.nonzero(pend).flatten()
    keep = torch.zeros_like(pend)
    keep[rows[: max(1, int(rows.numel() * frac))]] = True
    return dict(k1, pending=keep)


def k2_case(snap, P, n_cols=None):
    """K2's inputs for a compacted solve whose bucket holds the first ``P``
    pending rows (a ``n_cols``-wide node block if given)."""
    from kube_batch_tpu_torch.ops.assignment import (
        NEG, pend_view, score_matrix, static_predicates,
    )
    from kube_batch_tpu_torch.ops.scoring import ScoreWeights

    rows = torch.nonzero(snap.task_pending).flatten()[:P].to(torch.int32)
    pend_rows = torch.full((P,), -1, dtype=torch.int32, device=rows.device)
    pend_rows[: rows.numel()] = rows
    view = pend_view(snap, pend_rows)
    ss = torch.where(static_predicates(view),
                     score_matrix(view, ScoreWeights()), NEG)
    cols = slice(None) if n_cols is None else slice(0, n_cols)
    return dict(score_static=ss[:, cols].contiguous(),
                task_req=view.task_req.contiguous(),
                idle=snap.node_idle[cols].contiguous(),
                releasing=snap.node_releasing[cols].contiguous(),
                rows=pend_rows.clamp(min=0), quanta=snap.quanta)


def k1_bound(inp):
    """K1's bound on these inputs: a pending row's score and static_ok are
    read once; a row that is not pending needs none of its bytes."""
    T, N = inp["score"].shape
    R = inp["task_req"].shape[1]
    n_pend = int(inp["pending"].sum())
    ins = n_pend * N * (4 + 1) + nbytes(
        *(inp[k] for k in ("task_req", "idle", "releasing", "pending", "quanta")))
    outs = T * (4 + 4 + 4 + 1)
    # per pending cell: 2R budget adds, 2R compares, the tie hash (7 integer
    # ops), the mask select and the two-key compare; per other cell the hash
    # and the compare
    return bound(ins + outs, n_pend * N * (4 * R + 10) + (T - n_pend) * N * 9)


def k2_bound(inp):
    P, N = inp["score_static"].shape
    R = inp["task_req"].shape[1]
    ins = nbytes(*(inp[k] for k in ("score_static", "task_req", "idle",
                                    "releasing", "rows", "quanta")))
    outs = P * N * 4 + 3 * P * (N // 64) * 4
    # per cell: 2R adds, 2R compares, select, +0.0, key flip (3), hash (7),
    # the triple's compares (2)
    return bound(ins + outs, P * N * (4 * R + 13))


def _gate(min_res, cand, idle0, n_rows) -> dict:
    """A gate case; rows from ``n_rows`` on are padding, not candidates."""
    cand = np.array(cand, bool)
    cand[n_rows:] = False
    return dict(min_res=np.ascontiguousarray(min_res, np.float32), cand=cand,
                idle0=np.asarray(idle0, np.float32), quanta=GATE_QUANTA.copy(),
                n_rows=int(n_rows))


def gate_case(n_jobs: int = 12_500, cap: int = 16_384, seed: int = 0) -> dict:
    """The enqueue gate's inputs as numpy arrays: ``n_jobs`` gangs of 4
    pods (requests drawn like ``synthetic_cluster``'s) carrying their
    summed MinResources, a tenth of them failing their queue's capability
    check, against an idle budget of 70 % of the total ask, so that the
    walk admits until the budget runs short and then only what still fits."""
    from kube_batch_tpu_torch.testing.synthetic import CPU_CHOICES, MEM_CHOICES

    rng = np.random.default_rng(seed)
    min_res = np.zeros((cap, 4), np.float32)
    min_res[:n_jobs, 0] = rng.choice(CPU_CHOICES, (n_jobs, 4)).sum(axis=1)
    min_res[:n_jobs, 1] = rng.choice(MEM_CHOICES, (n_jobs, 4)).sum(axis=1)
    min_res[:n_jobs, 2] = 4.0
    cand = np.zeros(cap, bool)
    cand[:n_jobs] = rng.random(n_jobs) >= 0.1
    idle0 = 0.7 * min_res[:n_jobs].astype(np.float64).sum(axis=0)
    idle0[2] = 5_000 * 110.0
    return _gate(min_res, cand, idle0, n_jobs)


def gate_corners(seed: int = 0) -> dict:
    """The gate's corner cases as numpy inputs: rows within one quantum of
    the budget's edge; every row rejected; rows that are not candidates
    between candidates while the compensation is nonzero (they still fold
    it into idle); and thousands of admissions of byte-sized memory
    against a 5e13-byte budget, where the Kahan carry decides the last
    verdicts."""
    rng = np.random.default_rng(seed)
    q = GATE_QUANTA
    out = {}
    # edge: admitted just inside the quantum, rejected at exactly one
    m = np.zeros((64, 4), np.float32)
    m[0] = [1000.0 + 9.5, 0, 0, 0]                 # fits within 9.5 < 10
    m[1] = [q[0], 0, 0, 0]                         # idle 0: 10 - 0 < 10 fails
    m[2] = [np.nextafter(q[0], 0, dtype=np.float32), 0, 0, 0]   # just under
    m[3] = [0, 4 * GiB + q[1] - 1024, 0, 0]        # memory edge, inside
    m[4] = [0, q[1], 0, 0]                         # memory at the quantum
    m[5] = [0, np.nextafter(q[1], 0, dtype=np.float32), 0, 0]
    out["edge"] = _gate(m, np.ones(64, bool), [1000.0, 4 * GiB, 100.0, 0.0], 6)
    # every row rejected
    m = np.zeros((256, 4), np.float32)
    m[:200, 0] = rng.choice([20.0, 250.0, 4000.0], 200)
    out["all_rejected"] = _gate(m, np.ones(256, bool), [0.0, 64 * GiB, 1e4, 0.0], 200)
    # non-candidate rows between candidates, with a nonzero compensation
    m = np.zeros((512, 4), np.float32)
    m[:500, 0] = rng.choice([250.0, 500.0, 1000.0], 500)
    m[:500, 1] = (rng.random(500) * 2**33).astype(np.float32)
    m[:500, 2] = 1.0
    cand = np.zeros(512, bool)
    cand[:500] = rng.random(500) < 0.5
    cand[499] = True
    ask = m[cand].astype(np.float64).sum(axis=0)
    out["fold"] = _gate(m, cand, [1e6, ask[1] - 4 * GiB, 1e4, 0.0], 500)
    # thousands of admissions: the budget equals the ask to within a few
    # quanta, so the last rows' verdicts depend on the carried low bits
    k = 4000
    m = np.zeros((4096, 4), np.float32)
    m[:k, 0] = 250.0
    m[:k, 1] = (rng.random(k) * 2**34).astype(np.float32)
    m[:k, 2] = 1.0
    ask = m[:k].astype(np.float64).sum(axis=0)
    out["many_admissions"] = _gate(
        m, np.ones(4096, bool), [ask[0], ask[1] - 3 * float(q[1]), 1e5, 0.0], k)
    # an infinite budget (an infinite allocatable): the first row, not a
    # candidate though its request fits, folds inf - inf = NaN into the
    # compensation, and the clamp carries the NaN on (a max that drops it
    # would reset idle to 0), so every row is rejected, the empty ones at
    # the end too
    m = np.zeros((32, 4), np.float32)
    m[:16] = [250.0, GiB, 1.0, 0.0]
    cand = np.ones(32, bool)
    cand[[0, 3]] = False
    out["inf_budget"] = _gate(m, cand, [np.inf] * 4, 24)
    return out


def gate_tensors(inp: dict, device) -> dict:
    """A gate case's numpy inputs as tensors on ``device``."""
    return {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
            for k, v in inp.items()}


def gate_bound(inp, clock_hz: float):
    """The gate's bound on these inputs: the rows it walks, each at least
    ``GATE_CHAIN_CYCLES`` on the dependence chain, against the bytes
    (MinResources and cand in, the mask out) over the memory rate."""
    k = int(inp["n_rows"])
    R = inp["min_res"].shape[1]
    t_bytes = (k * R * 4 + k + inp["cand"].shape[0]) / HBM_BYTES_PER_S * 1e3
    t_chain = k * GATE_CHAIN_CYCLES / clock_hz * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_chain else (t_chain, "operations")


def gate_kernel(**inp):
    """The gate's wrapper, its result as a sequence for :func:`run_case`."""
    from kube_batch_tpu_torch.ops.admission import enqueue_gate
    return (enqueue_gate(**inp),)


def gate_plain(**inp):
    """The gate's plain version, likewise."""
    from kube_batch_tpu_torch.ops.admission import gate_scan
    return (gate_scan(**inp),)


def index_decided_rows(inp) -> int:
    """Rows of a K1 case whose pick is decided by the node index: two or
    more cells share the row's best (value, hash)."""
    from kube_batch_tpu_torch.ops import kernels

    T, N = inp["score"].shape
    fit_idle = kernels.fits(inp["task_req"], inp["idle"], inp["quanta"])
    feas = inp["static_ok"] & inp["pending"][:, None] & (
        fit_idle | kernels.fits(inp["task_req"], inp["releasing"], inp["quanta"]))
    masked = torch.where(feas, inp["score"], kernels.NEG)
    val = masked.amax(dim=1, keepdim=True)
    hashes = kernels._tie_break_hash(T, N, inp["t0"], inp["n0"], masked.device)
    hm = torch.where(masked >= val, hashes, -1)
    return int(((hm == hm.amax(dim=1, keepdim=True)).sum(dim=1) >= 2).sum())


def run_case(kernel, plain, inp, reps, plain_reps=0):
    """Kernel vs plain version on the same inputs: bit-exact (raises
    otherwise), then timed; ``plain_reps`` 0 skips timing the plain one."""
    got = kernel(**inp)
    torch.cuda.synchronize()
    want = plain(**inp)
    err = max_abs_err(got, want)
    if not same(got, want):
        raise AssertionError(
            f"{kernel.__name__}: kernel disagrees with its plain version "
            f"(max abs err {err})")
    out = dict(max_abs_err=err, ms=time_ms(lambda: kernel(**inp), reps))
    if plain_reps:
        out["plain_ms"] = time_ms(lambda: plain(**inp), plain_reps, warmup=1)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device is available")

    from kube_batch_tpu_torch.ops import kernels
    from kube_batch_tpu_torch.ops.assignment import score_matrix, static_predicates
    from kube_batch_tpu_torch.ops.scoring import ScoreWeights
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    snap, _ = synthetic_device_snapshot(50_000, 5_000, gang_size=4, n_queues=3,
                                        seed=0, device="cuda")
    k1 = k1_case(snap, score_matrix(snap, ScoreWeights()), static_predicates(snap))
    cases = {"K1_round0": k1, "K1_late": late_round(k1)}
    T = k1["score"].shape[0]
    for P in (8192, T):
        cases[f"K2_P{P}"] = k2_case(snap, P)
    out = {}
    gate = gate_tensors(gate_case(), "cuda")
    r = run_case(gate_kernel, gate_plain, gate, args.reps)
    b_ms, b_by = gate_bound(gate, sm_clock_hz())
    out["gate"] = dict(rows=gate["n_rows"], **r, bound_ms=b_ms, bound_by=b_by,
                       bound_fraction=b_ms / r["ms"])
    for name, inp in cases.items():
        if name.startswith("K1"):
            r = run_case(kernels.masked_best_node_raw,
                         kernels.masked_best_node_raw_plain, inp, args.reps)
            b_ms, b_by = k1_bound(inp)
            shape = list(inp["score"].shape)
            r["pending_rows"] = int(inp["pending"].sum())
        else:
            r = run_case(kernels.masked_topk_blocks,
                         kernels.masked_topk_blocks_plain, inp, args.reps)
            b_ms, b_by = k2_bound(inp)
            shape = list(inp["score_static"].shape)
        out[name] = dict(shape=shape, **r, bound_ms=b_ms, bound_by=b_by,
                         bound_fraction=b_ms / r["ms"])
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": nvidia_smi(), "reps": args.reps,
                      "tolerance": "bit-exact", **out}))


if __name__ == "__main__":
    main()
