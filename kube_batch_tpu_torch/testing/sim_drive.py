"""Drive the port's virtual-time simulator at the size users run, and check it.

    python -m kube_batch_tpu_torch.testing.sim_drive [--nodes 5000]
        [--gangs 12500] [--cycles 16] [--device cuda|cpu]
    python -m kube_batch_tpu_torch.testing.sim_drive --presets
        [--device cuda|cpu]

The 50k drive (:func:`drive_sim`) runs ``sim.SimRunner`` on
:func:`drive_config`: ``nodes`` nodes of ``SimConfig``'s default shape
(16 000m cpu, 64 GiB, 110 pods) under three queues weighted 1, 2 and 3,
and ``gangs`` Poisson gangs of 4 pods (the default 12 500 gangs are
50 000 pods) arriving over the first 5 virtual seconds (2 500 gangs a
virtual second at the default width), with the preset workload's
durations (3–12 s) and start latency, for ``cycles`` virtual cycles of
the shipped five-action conf.  It is not a preset: it is the smoke
workload's generator at the headline drive's width.  It runs twice,
once with the defaults and once with ``KB_WARM=0`` (the cold candidate
table), each in a fresh runner with the GC paused; both legs must bind
identically (equal ``bind_digest``), with clean invariants and no
duplicate binds, and the defaults leg must run compacted cycles.  Each
cycle records its wall ms (the whole simulated cycle) and its split:
``apply_ms`` (the due events applied), ``run_once_ms`` (the heap's pop
and ``Scheduler.run_once`` with its bind flush), ``kubelet_ms`` (the
kubelet drain) and ``sample_ms`` (the longitudinal metrics sample: task
counts, queue shares, ``set_queue_shares``, ``note_cycle``).  It also
records the scheduler's own stage ms, the pending and running task
counts, the K1, K2 and gate launches (CUDA launches; 0 on the CPU), and
allocate's ``topk`` and ``warm`` records.

``--presets`` (:func:`run_presets`) runs every preset at seed 0, and
smoke at seed 3 through the pipelined cycle, with the CLI's exit
criteria and prints each report's digests; ``chip_smoke.py``'s ``sim``
phase holds the card's against the CPU's, which it runs in a
:class:`Child` process beside the card's, with the simulator's CLI
(:func:`cli_args`).  Bundles go to ``KB_GUARD_DIR``, as the CLI's do.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

from kube_batch_tpu_torch.ops import kernels
from kube_batch_tpu_torch.sim import SimConfig, SimRunner, run_preset
from kube_batch_tpu_torch.sim.__main__ import passed
from kube_batch_tpu_torch.testing.cycle_drive import LEGS, fail, switches_off

#: every preset of ``sim.preset``, in the JAX package's order
PRESETS = ("smoke", "fault", "churn", "warm-churn", "brownout", "bind-storm",
           "leader-failover", "corruption")

#: the runs of :func:`run_presets`: (name, preset, seed, pipelined)
RUNS = (*((name, name, 0, False) for name in PRESETS),
        ("smoke-pipelined", "smoke", 3, True))

#: the virtual seconds over which the 50k drive's gangs arrive
ARRIVAL_S = 5.0

#: the 50k drive's legs (``cycle_drive.LEGS``): the defaults, then ``KB_WARM=0``
DRIVE_LEGS = ("defaults", "cold")

#: the report fields a run on the card must equal on the CPU
DIGESTS = ("trace_sha256", "bind_digest", "trace_events", "cycles_run")

ROOT = Path(__file__).resolve().parents[2]

#: the simulator's CLI on the CPU (the device is a keyword of ``main``)
CPU_CLI = ("import sys; from kube_batch_tpu_torch.sim.__main__ import main; "
           "sys.exit(main(sys.argv[1:], device='cpu'))")


def drive_config(n_nodes: int = 5_000, n_gangs: int = 12_500,
                 cycles: int = 16) -> SimConfig:
    """The 50k drive's scenario (module docstring) at seed 0: the gangs
    arrive over the first ~5 virtual seconds at any width (2 500 a second
    for 12 500)."""
    return SimConfig(seed=0, n_nodes=n_nodes,
                     queues=(("q0", 1), ("q1", 2), ("q2", 3)),
                     cycles=cycles, n_jobs=n_gangs, arrival_rate=n_gangs / ARRIVAL_S,
                     gang_sizes=(4,))


class DriveRunner(SimRunner):
    """A ``SimRunner`` that records each cycle (module docstring)."""

    def __init__(self, cfg: SimConfig, device=None):
        super().__init__(cfg, device=device)
        self.cycle_log: List[Dict] = []
        self._apply_s = 0.0
        self._drain_t = (0.0, 0.0)

    def _apply(self, event):
        t0 = time.perf_counter()
        super()._apply(event)
        self._apply_s += time.perf_counter() - t0

    def _drain_kubelet(self, now: float) -> None:
        t0 = time.perf_counter()
        super()._drain_kubelet(now)
        self._drain_t = (t0, time.perf_counter())

    def _one_cycle(self):
        before = dict(kernels.launches)
        lines = len(self.trace)
        self._apply_s = 0.0
        t0 = time.perf_counter()
        pending, running = super()._one_cycle()
        t1 = time.perf_counter()
        drain0, drain1 = self._drain_t
        topk = self._allocate.last_topk
        warm = self._allocate.last_warm
        self.cycle_log.append({
            "t": self.clock.now(),
            "wall_ms": (t1 - t0) * 1e3,
            "apply_ms": self._apply_s * 1e3,
            "run_once_ms": (drain0 - t0 - self._apply_s) * 1e3,
            "kubelet_ms": (drain1 - drain0) * 1e3,
            "sample_ms": (t1 - drain1) * 1e3,
            "scheduler_ms": sum(self.scheduler.last_cycle_ms.values()),
            "stages_ms": dict(self.scheduler.last_cycle_ms),
            "pending": pending,
            "running": running,
            "trace_lines": len(self.trace) - lines,
            "launches": {k: kernels.launches[k] - before[k] for k in before},
            "topk": None if topk is None else {
                k: topk[k] for k in ("k", "bucket", "exhausted", "reentries") if k in topk},
            "warm": None if warm is None else {
                k: warm[k] for k in ("cold", "w", "bucket_live", "changed", "reranked")
                if k in warm},
        })
        return pending, running


def drive_leg(cfg: SimConfig, leg: str, device=None) -> Dict:
    """One leg of the 50k drive (``cycle_drive.LEGS`` names the switches it
    turns off) in a fresh runner, the GC paused while it runs."""
    with switches_off(LEGS[leg]):
        runner = DriveRunner(cfg, device=device)
        gc.collect()
        gc.disable()
        t0 = time.perf_counter()
        try:
            report = runner.run()
        finally:
            gc.enable()
        wall_s = time.perf_counter() - t0
    launches = {k: sum(c["launches"][k] for c in runner.cycle_log)
                for k in kernels.launches}
    return {
        "leg": leg,
        "wall_s": wall_s,
        "cycles": runner.cycle_log,
        "launches": launches,
        "report": {k: report[k] for k in (
            "jobs", "binds", "cycles_run", "wait_vt", "jct_vt", "pod_bind_latency_vt",
            "makespan_vt", "topk", "warm", "bind_integrity", "snapshot_paths",
            "trace_events", "trace_sha256", "bind_digest")},
        "invariant_errors": report["invariants"]["errors"],
    }


def drive_sim(n_nodes: int = 5_000, n_gangs: int = 12_500, cycles: int = 16,
              device=None) -> Dict:
    """The 50k drive's legs and their checks; raises on a failed check."""
    cfg = drive_config(n_nodes, n_gangs, cycles)
    out = {"nodes": n_nodes, "pods": 4 * n_gangs, "cycles": cycles,
           "legs": {leg: drive_leg(cfg, leg, device) for leg in DRIVE_LEGS}}
    for leg, r in out["legs"].items():
        if r["invariant_errors"]:
            fail(f"sim drive {leg}: invariants {r['invariant_errors'][:3]}")
        if r["report"]["bind_integrity"]["duplicate_binds"]:
            fail(f"sim drive {leg}: duplicate binds {r['report']['bind_integrity']}")
        if not r["report"]["binds"]:
            fail(f"sim drive {leg}: nothing bound")
    digests = {leg: r["report"]["bind_digest"] for leg, r in out["legs"].items()}
    if len(set(digests.values())) != 1:
        fail(f"sim drive: the legs bound differently {digests}")
    if not out["legs"]["defaults"]["report"]["topk"]["compacted_cycles"]:
        fail("sim drive: the defaults leg ran no compacted cycle")
    return out


def run_presets(device=None) -> Dict[str, Dict]:
    """Every run of :data:`RUNS`: its digests, its CLI verdict, its wall
    seconds and its kernel launches (CUDA launches; 0 on the CPU)."""
    out = {}
    for name, preset_name, seed, pipelined in RUNS:
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = run_preset(preset_name, seed=seed, pipelined=pipelined, device=device)
        wall = time.perf_counter() - t0
        out[name] = {
            **{k: report[k] for k in DIGESTS},
            "exit_ok": passed(report),
            "wall_s": wall,
            "launches": dict(kernels.launches),
            "topk_compacted_cycles": report["topk"]["compacted_cycles"],
            "warm_cycles": report["warm"]["warm_cycles"],
            "bundles": report.get("guard", {}).get("bundles", []),
        }
    return out


def cli_args(argv: List[str], device=None) -> List[str]:
    """The interpreter arguments that run the simulator's CLI with ``argv``:
    ``python -m kube_batch_tpu_torch.sim`` on the card, its ``main`` with
    ``device="cpu"`` on the CPU."""
    if device is None or str(device).startswith("cuda"):
        return ["-m", "kube_batch_tpu_torch.sim", *argv]
    return ["-c", CPU_CLI, *argv]


class Child:
    """A child interpreter started at once with ``args``; its stdout and
    stderr go to files in ``workdir`` (no pipe to fill).  :meth:`finish`
    waits for it and returns its exit code and stdout; :meth:`stop` kills
    it if it still runs."""

    def __init__(self, name: str, args: List[str], workdir: str, **env):
        self.out_path = os.path.join(workdir, f"{name}.out")
        self.err_path = os.path.join(workdir, f"{name}.err")
        child_env = dict(os.environ, **env,
                         PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.t0 = time.perf_counter()
        with open(self.out_path, "wb") as out, open(self.err_path, "wb") as err:
            self.proc = subprocess.Popen([sys.executable, *args], cwd=str(ROOT),
                                         stdin=subprocess.DEVNULL, stdout=out,
                                         stderr=err, env=child_env)
        self.seconds = None

    def finish(self, timeout: float):
        try:
            self.proc.wait(timeout)
        finally:
            self.stop()
        self.seconds = time.perf_counter() - self.t0
        with open(self.out_path) as f:
            return self.proc.returncode, f.read()

    def stderr_tail(self, n: int = 2000) -> str:
        with open(self.err_path, errors="replace") as f:
            return f.read()[-n:]

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", action="store_true")
    ap.add_argument("--nodes", type=int, default=5_000)
    ap.add_argument("--gangs", type=int, default=12_500)
    ap.add_argument("--cycles", type=int, default=16)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if args.presets:
        out = run_presets(device=args.device)
    else:
        out = drive_sim(args.nodes, args.gangs, args.cycles, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
