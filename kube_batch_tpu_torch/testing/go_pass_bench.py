"""Micro-measurement of the Go-loop denominator's per-task pass.

``go_baseline.go_loop_allocate`` stands in for the reference's Go allocate
loop and uses a numpy vector pass for the per-task predicate+score scan
that the reference runs through compiled Go and a 16-worker
ParallelizeUntil (scheduler_helper.go:34-129).  The floor argument: numpy's
inner loop over N nodes is at least as fast as what the reference achieves
per task.  This module measures that claim on the host it runs on: it
times the identical pass three ways on the same buffers —

  numpy_us        the stand-in used by go_baseline
  c_single_us     compiled C, one thread (the speed class of compiled Go)
  c_pooled_us     compiled C on a persistent thread pool with per-pass
                  barriers — the ParallelizeUntil shape, paying the real
                  fork/join cost the reference pays per PredicateNodes call

If numpy_us <= c_pooled_us, the reported speedup against the go-loop is a
measured floor.  All three must agree on the argmax.

    python -m kube_batch_tpu_torch.testing.go_pass_bench [--nodes 5000] [--reps 200]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

# the SAME function object go_loop_allocate calls — the bench times the
# loop's actual pass, and an edit there cannot silently desynchronize this
from kube_batch_tpu_torch.testing.go_baseline import numpy_inner_pass as _numpy_pass


def measure(n_nodes: int = 5_000, reps: int = 200, threads: int = 16,
            seed: int = 0) -> dict:
    from kube_batch_tpu_torch import native
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    snap, meta = synthetic_device_snapshot(
        n_tasks=64, n_nodes=n_nodes, gang_size=4, n_queues=3, seed=seed,
        device="cpu",
    )
    nn = meta.n_nodes
    node_idle = np.ascontiguousarray(snap.node_idle.numpy()[:nn], np.float64)
    node_alloc = np.ascontiguousarray(snap.node_alloc.numpy()[:nn], np.float64)
    quanta = np.ascontiguousarray(snap.quanta.numpy(), np.float64)
    reqs = np.ascontiguousarray(snap.task_req.numpy()[:64], np.float64)
    cap_cpu = np.maximum(node_alloc[:, 0], 1.0)
    cap_mem = np.maximum(node_alloc[:, 1], 1.0)
    R = node_idle.shape[1]

    def time_us(fn):
        # warmup + per-pass p50 over reps, cycling the 64 task reqs so a
        # branch predictor can't lock onto one request vector
        fn(reqs[0])
        samples = []
        for i in range(reps):
            req = reqs[i % 64]
            t0 = time.perf_counter()
            fn(req)
            samples.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(samples)

    results = {"nodes": nn, "reps": reps, "threads": threads}
    picks = {}

    def numpy_fn(req):
        picks["numpy"] = _numpy_pass(req, node_idle, node_alloc, quanta,
                                     cap_cpu, cap_mem)
    results["numpy_us"] = round(time_us(numpy_fn), 1)

    lib = native.load()
    idle_p, alloc_p = node_idle.ctypes.data, node_alloc.ctypes.data
    q_p = quanta.ctypes.data

    def c_single(req):
        picks["c_single"] = lib.go_pass_single(
            req.ctypes.data, idle_p, alloc_p, q_p, nn, R
        )
    results["c_single_us"] = round(time_us(c_single), 1)

    def c_pooled(req):
        picks["c_pooled"] = lib.go_pass_pooled(
            req.ctypes.data, idle_p, alloc_p, q_p, nn, R
        )
    with native.POOL_LOCK:
        native.pool_init(lib, threads)
        try:
            results["c_pooled_us"] = round(time_us(c_pooled), 1)
        finally:
            lib.go_pass_pool_shutdown()

    # all implementations must pick the same node on the final rep
    if len(set(picks.values())) != 1:
        raise AssertionError(f"the passes disagree: {picks}")
    results["agreement"] = picks["numpy"]
    results["numpy_vs_c_single"] = round(
        results["c_single_us"] / results["numpy_us"], 2
    )
    results["numpy_vs_c_pooled"] = round(
        results["c_pooled_us"] / results["numpy_us"], 2
    )
    results["floor_holds"] = results["numpy_us"] <= results["c_pooled_us"]
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--nodes", type=int, default=5_000)
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--threads", type=int, default=16)
    args = parser.parse_args(argv)
    print(json.dumps(measure(args.nodes, args.reps, args.threads)))


if __name__ == "__main__":
    main()
