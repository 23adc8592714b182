"""Where a full allocate solve's time goes on the card.

    python -m kube_batch_tpu_torch.testing.profile_solve [--gpu-task-frac F]

Runs ``dispatch_allocate_solve`` on the 50k-pod × 5k-node synthetic
snapshot once to warm up, then once under ``torch.profiler`` (CPU and
CUDA activities), and prints one JSON line: the wall time, the device's
busy time (the sum of kernel and memory-op times on the one stream) and
idle share, the solve's host syncs, and the kernels that took the most
device time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from kube_batch_tpu_torch.actions.allocate import dispatch_allocate_solve
from kube_batch_tpu_torch.ops.assignment import AllocateConfig
from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpu-task-frac", type=float, default=0.0)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    snap, _ = synthetic_device_snapshot(
        50_000, 5_000, gang_size=4, n_queues=3,
        gpu_task_frac=args.gpu_task_frac, seed=0, device="cuda")
    config = AllocateConfig()
    dispatch_allocate_solve(snap, config)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res, _, _, _ = dispatch_allocate_solve(snap, config)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)
    # the solve's host syncs surface as aten::item / _local_scalar_dense
    syncs = sum(e.count for e in prof.key_averages()
                if e.key == "aten::_local_scalar_dense")
    print(json.dumps({
        "gpu_task_frac": args.gpu_task_frac,
        "device": torch.cuda.get_device_name(0),
        "rounds_run": int(res.rounds_run),
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "host_syncs": syncs,
        "top_kernels": [
            {"name": e.key[:90], "count": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in top[: args.top]
        ],
    }))


if __name__ == "__main__":
    main()
