"""Workload generators for the simulator, layered on testing/synthetic.py's
distributions (the BASELINE config matrix's request/gang shapes).

A workload is a list of JOB_ARRIVAL `SimEvent`s whose data fully describes
the job — name, queue, gang minMember, and per-pod requests/durations — so
the SAME event list drives a run whether it came from the Poisson generator
or from a previously recorded trace (`trace_arrivals`). All randomness is
drawn here, before the run starts, from one seeded numpy Generator: the
run itself contains no sampling, which is what makes `--seed` ⇒ identical
trace possible.

Mirrors ``kube_batch_tpu/sim/workload.py``: the same seed draws the same
events in the same order from the same generator calls.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from kube_batch_tpu_torch.sim import events as ev
from kube_batch_tpu_torch.testing.synthetic import CPU_CHOICES, GiB

SIM_NS = "sim"

# memory follows the synthetic matrix but narrower, so small sim nodes
# contend on cpu (the interesting axis) rather than stranding on memory
MEM_CHOICES = np.array([1, 2, 4]) * GiB


def poisson_arrivals(
    seed: int,
    n_jobs: int,
    rate: float,
    queues: Sequence[str],
    gang_sizes: Sequence[int] = (1, 2, 4),
    cpu_choices: Sequence[float] = tuple(CPU_CHOICES[:4]),
    mem_choices: Sequence[float] = tuple(MEM_CHOICES),
    duration_range: Tuple[float, float] = (3.0, 12.0),
    start_latency: float = 0.5,
    start_at: float = 0.0,
) -> List[ev.SimEvent]:
    """Poisson job arrivals: exponential inter-arrival at `rate` jobs per
    virtual second; each job is a gang of a sampled size, queue round-robin
    (deterministic per index, like synthetic.py's job_queue), uniform pod
    durations."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_jobs)
    times = start_at + np.cumsum(gaps)
    sizes = rng.choice(np.asarray(gang_sizes), size=n_jobs)
    out: List[ev.SimEvent] = []
    for i in range(n_jobs):
        g = int(sizes[i])
        name = f"j{i:04d}"
        tasks = []
        for k in range(g):
            tasks.append({
                "name": f"{name}-{k}",
                "cpu": float(rng.choice(np.asarray(cpu_choices))),
                "mem": float(rng.choice(np.asarray(mem_choices))),
                "duration": round(float(rng.uniform(*duration_range)), 6),
                "start_latency": round(float(start_latency), 6),
            })
        out.append(ev.SimEvent(round(float(times[i]), 6), ev.JOB_ARRIVAL, {
            "name": name,
            "namespace": SIM_NS,
            "queue": queues[i % len(queues)],
            "min_member": g,
            "tasks": tasks,
        }))
    return out


def fixed_gangs(
    t: float,
    n_gangs: int,
    gang_size: int,
    cpu: float,
    mem: float,
    duration: float,
    queues: Sequence[str],
    start_latency: float = 0.5,
    name_prefix: str = "g",
) -> List[ev.SimEvent]:
    """Deterministic homogeneous gangs arriving together — the fault
    presets use these so the displaced workload is exactly known."""
    out: List[ev.SimEvent] = []
    for i in range(n_gangs):
        name = f"{name_prefix}{i:03d}"
        out.append(ev.SimEvent(round(float(t), 6), ev.JOB_ARRIVAL, {
            "name": name,
            "namespace": SIM_NS,
            "queue": queues[i % len(queues)],
            "min_member": gang_size,
            "tasks": [{
                "name": f"{name}-{k}",
                "cpu": float(cpu), "mem": float(mem),
                "duration": round(float(duration), 6),
                "start_latency": round(float(start_latency), 6),
            } for k in range(gang_size)],
        }))
    return out


def trace_arrivals(path: str) -> List[ev.SimEvent]:
    """Trace-driven workload: re-inject the JOB_ARRIVAL events of a
    recorded run (everything else in the trace was derived state and is
    re-derived live)."""
    return [e for e in ev.read_trace(path) if e.kind == ev.JOB_ARRIVAL]
