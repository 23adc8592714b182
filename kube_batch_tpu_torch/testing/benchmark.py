"""Benchmark matrix — the kubemark density-test successor (SURVEY.md §4.3).

The reference measures pod-startup latency percentiles on a simulated GCE
cluster (test/e2e/benchmark.go:53-285, p50/p90/p99 via metric_util.go). Here
every BASELINE.json config runs as a synthetic scheduling-cycle benchmark
with the same percentile reporting — no apiserver, the snapshot feeds the
device directly:

  gang_allocate_kubemark      3k pods × 100 nodes, minMember=4 (the kubemark
                              density target, kubemark-benchmarking.md:40-42)
  drf_proportion_3_queues     50k × 5k, 3 weighted queues, mixed CPU/mem
  binpack_nodeorder_10k_1k    10k × 1k with the binpack score row enabled
  preempt_reclaim_overcommit  the shipped five actions over an overcommitted
  preempt_reclaim_50k_5k      2-queue cluster (host actions + device solve),
                              at 800 / 400 / 100 and 10k / 50k / 5k
  hetero_gpu_gangs_50k_5k     heterogeneous GPU gangs at full scale
  pod_startup_latency_kubemark  create → schedule latency through
                              ``run_forever`` (3k pods on 100 nodes)

Every case runs on ``device`` (CUDA by default; raises without a card).

    python -m kube_batch_tpu_torch.testing.benchmark [--quick] [--device cpu]

Prints one JSON line per case plus a summary line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

TARGET_MS = 1000.0  # <1s/cycle north star


def _percentiles(ms: List[float]) -> Dict[str, float]:
    return {
        "p50_ms": round(float(np.percentile(ms, 50)), 2),
        "p90_ms": round(float(np.percentile(ms, 90)), 2),
        "p99_ms": round(float(np.percentile(ms, 99)), 2),
    }


class BenchCase(NamedTuple):
    name: str
    run: Callable[[int], Dict]  # cycles → result dict
    #: a device case's (host fields, meta, config), built as ``run`` builds
    #: them; None for the cycle cases
    inputs: Optional[Callable[[], tuple]] = None


def _device_case(name, n_tasks, n_nodes, gang_size=4, n_queues=3,
                 gpu_task_frac=0.0, gpu_node_frac=0.25, weights=None,
                 device=None):
    """A device-solve cycle benchmark: host→device upload of the snapshot,
    the allocate solve, ``assigned`` read back (the one-in/one-out transfer
    budget, §7.3).  The readback is the sync that ends the clock."""

    def inputs():
        from kube_batch_tpu_torch.api.convert import snapshot_to_numpy
        from kube_batch_tpu_torch.ops.assignment import AllocateConfig
        from kube_batch_tpu_torch.ops.scoring import ScoreWeights
        from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

        config = AllocateConfig(weights=weights or ScoreWeights())
        snap, meta = synthetic_device_snapshot(
            n_tasks=n_tasks, n_nodes=n_nodes, gang_size=gang_size,
            n_queues=n_queues, gpu_task_frac=gpu_task_frac,
            gpu_node_frac=gpu_node_frac, device="cpu",
        )
        return snapshot_to_numpy(snap), meta, config

    def run(cycles: int) -> Dict:
        from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
        from kube_batch_tpu_torch.device import resolve_device
        from kube_batch_tpu_torch.ops.assignment import allocate_solve

        dev = resolve_device(device)
        fields, meta, config = inputs()

        def cycle():
            snap = snapshot_from_numpy(fields, dev)
            result = allocate_solve(snap, config)
            return result.assigned.cpu().numpy()

        assigned = cycle()  # warmup: the caching allocator's first blocks
        placed = int((assigned[: meta.n_tasks] >= 0).sum())
        times = []
        for _ in range(cycles):
            t0 = time.perf_counter()
            cycle()
            times.append((time.perf_counter() - t0) * 1e3)
        return {
            "tasks": meta.n_tasks, "nodes": meta.n_nodes, "placed": placed,
            **_percentiles(times),
            "pods_per_sec": round(placed / (np.percentile(times, 50) / 1e3), 0),
        }

    return BenchCase(name, run, inputs)


def _overcommit_case(name, n_running=800, n_pending=400, n_nodes=100,
                     device=None):
    """preempt + reclaim under queue overcommit: queue q1 (weight 3) has
    pending gangs while queue q0 (weight 1) holds every node — the full
    enqueue→reclaim→allocate→backfill→preempt pipeline runs each cycle."""

    def run(cycles: int) -> Dict:
        from kube_batch_tpu_torch.framework.conf import load_scheduler_conf
        from kube_batch_tpu_torch.scheduler import Scheduler
        from kube_batch_tpu_torch.testing.synthetic import synthetic_overcommit_cluster

        conf = load_scheduler_conf(None)
        conf.actions = ["enqueue", "reclaim", "allocate", "backfill", "preempt"]

        def cluster():
            return synthetic_overcommit_cluster(
                n_running=n_running, n_pending=n_pending, n_nodes=n_nodes)

        # warmup: the reclaim/preempt/allocate solves' first allocations
        warm = cluster()
        Scheduler(warm, conf=conf, device=device).run_once()
        warm.stop()
        times = []
        evicted = placed = 0
        for _ in range(cycles):
            cache = cluster()
            sched = Scheduler(cache, conf=conf, device=device)
            t0 = time.perf_counter()
            sched.run_once()
            times.append((time.perf_counter() - t0) * 1e3)
            evicted = len(cache.evictor.evicts)
            placed = len(cache.binder.binds)
            cache.stop()
        return {
            "running": n_running, "pending": n_pending, "nodes": n_nodes,
            "evicted": evicted, "placed": placed, **_percentiles(times),
        }

    return BenchCase(name, run)


def _startup_latency_case(name, n_latency_pods=3_000, n_nodes=100, batch=100,
                          gang_size=100, period=0.05, device=None):
    """Pod-startup latency decomposition — the kubemark density test
    (test/e2e/benchmark.go:53-285, doc/design kubemark target of 3k pods on
    100 hollow nodes): start the scheduler loop, land a 100-pod gang, then
    feed 1-milliCPU latency pods in node-count batches and report
    create→schedule p50/p90/p99 from binder timestamps."""

    def run(cycles: int) -> Dict:  # cycles unused — one density sweep
        import threading

        from kube_batch_tpu_torch.api.pod import (
            GROUP_NAME_ANNOTATION, Node, Pod, PodGroup, Queue,
        )
        from kube_batch_tpu_torch.cache.cache import SchedulerCache
        from kube_batch_tpu_torch.cache.fake import FakeBinder
        from kube_batch_tpu_torch.scheduler import Scheduler

        created: Dict[str, float] = {}
        scheduled: Dict[str, float] = {}

        class TimestampingBinder(FakeBinder):
            def bind(self, pod, hostname):
                scheduled[f"{pod.namespace}/{pod.name}"] = time.perf_counter()
                super().bind(pod, hostname)

            def bind_many(self, pairs):
                now = time.perf_counter()
                for pod, _ in pairs:
                    scheduled[f"{pod.namespace}/{pod.name}"] = now
                super().bind_many(pairs)

        cache = SchedulerCache(binder=TimestampingBinder())
        cache.add_queue(Queue(name="default", weight=1))
        for i in range(n_nodes):
            cache.add_node(Node(name=f"n{i}", allocatable={
                "cpu": 32000.0, "memory": float(128 << 30), "pods": 110.0}))
        sched = Scheduler(cache, schedule_period=period, device=device)
        t = threading.Thread(target=sched.run_forever, daemon=True)
        t.start()
        try:
            # the 100-pod gang (benchmark.go:50,61-71)
            cache.add_pod_group(PodGroup(name="density-gang", min_member=gang_size))
            for i in range(gang_size):
                key = f"default/gang-{i}"
                created[key] = time.perf_counter()
                cache.add_pod(Pod(
                    name=f"gang-{i}", requests={"cpu": 100.0},
                    annotations={GROUP_NAME_ANNOTATION: "density-gang"},
                ))
            # latency pods in node-count batches (benchmark.go:93-140)
            for start in range(0, n_latency_pods, batch):
                for i in range(start, min(start + batch, n_latency_pods)):
                    key = f"default/lat-{i}"
                    created[key] = time.perf_counter()
                    cache.add_pod(Pod(name=f"lat-{i}", requests={"cpu": 1.0}))
                time.sleep(period)
            deadline = time.perf_counter() + 60
            while len(scheduled) < len(created) and time.perf_counter() < deadline:
                time.sleep(period)
        finally:
            sched.stop()
            t.join(5)
        lat_ms = [
            (scheduled[k] - created[k]) * 1e3 for k in created if k in scheduled
        ]
        return {
            "pods": len(created), "scheduled": len(lat_ms), "nodes": n_nodes,
            **(_percentiles(lat_ms) if lat_ms else {}),
        }

    return BenchCase(name, run)


def build_cases(device=None) -> List[BenchCase]:
    from kube_batch_tpu_torch.ops.scoring import ScoreWeights

    return [
        _device_case("gang_allocate_kubemark", 3_000, 100, device=device),
        _device_case("drf_proportion_3_queues", 50_000, 5_000, device=device),
        _device_case("binpack_nodeorder_10k_1k", 10_000, 1_000,
                     weights=ScoreWeights(binpack=1.0), device=device),
        _overcommit_case("preempt_reclaim_overcommit", device=device),
        # eviction at allocate's headline scale: 50k pending claimants vs
        # 10k saturating victims on 5k nodes — 60k tasks stay inside the
        # 65 536 task bucket; 50k + 50k would cross into the 131 072 bucket
        # and double every [T, N] buffer
        _overcommit_case("preempt_reclaim_50k_5k", n_running=10_000,
                         n_pending=50_000, n_nodes=5_000, device=device),
        _device_case("hetero_gpu_gangs_50k_5k", 50_000, 5_000,
                     gpu_task_frac=0.2, gpu_node_frac=0.25, device=device),
        _startup_latency_case("pod_startup_latency_kubemark", device=device),
    ]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cycles", type=int, default=5)
    parser.add_argument("--quick", action="store_true",
                        help="2 cycles per config")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    cycles = 2 if args.quick else args.cycles

    results = {}
    for case in build_cases(args.device):
        r = case.run(cycles)
        results[case.name] = r
        print(json.dumps({"config": case.name, **r}), flush=True)
    worst = max(r["p99_ms"] for r in results.values())
    print(json.dumps({
        "summary": "baseline_config_matrix",
        "configs": len(results),
        "worst_p99_ms": worst,
        "all_under_target": worst < TARGET_MS,
    }))


if __name__ == "__main__":
    main()
