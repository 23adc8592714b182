"""The threaded drive of the port's lock checker, for ``chip_smoke.py``'s
``lockdep`` phase.

``drive_lockdep`` installs the checker (``analysis/lockdep.py``) and the
guarded-access corroborator over ``lockdep.HOT_STRUCTURES`` (their domain
locks resolved from tier D), then drives, with both installed, every
threaded surface one standalone server has (``cmd/server.py``, as
``testing/server_drive.py`` builds it, in this process):

- the cluster (``synthetic_cluster(n_tasks, n_nodes)``) ingested over HTTP
  as list bodies (a thread per request), ``POST /v1/sync``, and cycle 1
  (the full program, K1);
- the pipelined ``run_forever`` on its thread, fed single-pod arrivals
  over HTTP in bursts — each in a Pending PodGroup, every other one
  carrying MinResources, so that enqueue's gate launches — each burst
  bound before the next (the compacted program, K2; the async binder,
  the writeback worker, the trigger);
- ``POST /v1/whatif`` through the admin thread, the micro-batcher's thread
  and the lease (K1 at the probe's rows);
- the server's replication publisher (its encode worker) and a follower
  on the same device pulling in process: after each burst it applies what
  the leader published, until it has applied ``FOLLOW_RECORDS`` records,
  and then answers a what-if from its own plane.

Then it stops the loop and closes the server and reports: the violations
the run added (each kind and description), the acquisition graph's edges,
how many hot structures were instrumented during the run, the five lock
sites with the most wait (``profile_report``, named by module, class and
attribute), the kernel launches of the run, and the drive's seconds.  It
uninstalls only what it installed: under a test's ``port_lockdep``
fixture the fixture's checker stays.

    python -m kube_batch_tpu_torch.testing.lock_drive --device cpu [--tasks N --nodes N]

rehearses it on the CPU at a small size (``device=None`` means CUDA).
"""

from __future__ import annotations

import argparse
import importlib
import json
import threading
import time
from typing import Dict, List

import numpy as np

from kube_batch_tpu_torch.testing.server_drive import (
    SEED,
    WIDE_BUCKET,
    _workdir,
    call,
    cluster_bodies,
    fail,
    ingest,
    post_ok,
    wait_for,
)

#: single-pod arrivals, posted in bursts, each bound before the next
ARRIVALS, BURSTS = 32, 4
#: records the follower must apply
FOLLOW_RECORDS = 2
#: the what-ifs posted to the leader
WHATIFS = 4


def single_pod_arrivals(queues, n_pods: int, seed: int, tag: str) -> Dict[str, list]:
    """``n_pods`` pending pods, each in a PodGroup of its own in phase
    Pending (enqueue's to promote); every other PodGroup carries its pod's
    requests as MinResources, which enqueue's gate admits."""
    from kube_batch_tpu_torch.api import serialize
    from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Pod, PodGroup
    from kube_batch_tpu_torch.api.types import PodGroupPhase, PodPhase
    from kube_batch_tpu_torch.testing.synthetic import CPU_CHOICES, MEM_CHOICES

    rng = np.random.default_rng(seed)
    cpu = rng.choice(CPU_CHOICES, n_pods)
    mem = rng.choice(MEM_CHOICES, n_pods)
    pgs, pods = [], []
    for i in range(n_pods):
        req = {"cpu": float(cpu[i]), "memory": float(mem[i])}
        pgs.append(PodGroup(name=f"{tag}{i}", namespace="bench", min_member=1,
                            queue=queues[i % len(queues)], creation_index=2 * 10**6 + i,
                            min_resources=dict(req) if i % 2 == 0 else None,
                            phase=PodGroupPhase.PENDING))
        pods.append(Pod(name=f"{tag}{i}-0", namespace="bench", requests=req,
                        annotations={GROUP_NAME_ANNOTATION: f"{tag}{i}"},
                        phase=PodPhase.PENDING, creation_index=2 * 10**6 + i))
    return {"podgroups": [serialize.pod_group_to_dict(pg) for pg in pgs],
            "pods": [serialize.pod_to_dict(p) for p in pods]}


def drive_lockdep(n_tasks: int, n_nodes: int, device=None) -> dict:
    """The drive (module docstring).  Returns the report; raises when a
    surface fails its check.  The caller judges the violations."""
    from kube_batch_tpu_torch.analysis import lockdep, races

    t0 = time.perf_counter()
    own = lockdep.current_state() is None
    state = lockdep.install()
    specs = races.runtime_domain_specs(lockdep.HOT_STRUCTURES)
    guarded = lockdep.install_guarded_access(specs, state=state)
    n0 = len(state.violations)
    try:
        instrumented = sum(
            isinstance(getattr(importlib.import_module(m), c).__dict__.get(a),
                       lockdep.GuardedAttr)
            for m, c, a, _lock in specs)
        with _workdir("lock-drive-") as workdir:
            report = _drive(n_tasks, n_nodes, device, workdir)
    finally:
        guarded.uninstall()
        if own:
            lockdep.uninstall()
    new = state.violations[n0:]
    top = list(state.profile_report().items())[:5]
    report.update(
        seconds=time.perf_counter() - t0,
        violations=len(new),
        violation_kinds=sorted({v.kind for v in new}),
        violation_descriptions=[v.description for v in new[:5]],
        edges=len(state.edges),
        edge_names=sorted(
            "{} -> {}".format(*("/".join(str(p) for p in lockdep.lock_name(s) if p)
                                for s in e)) for e in state.edges),
        guarded=instrumented,
        guarded_structures=[f"{c}.{a} under {lock}" for _m, c, a, lock in specs],
        top_wait=[dict(site=site, name="/".join(str(p) for p in lockdep.lock_name(site) if p),
                       **rec) for site, rec in top])
    return report


def _drive(n_tasks: int, n_nodes: int, device, workdir: str) -> dict:
    import os

    from kube_batch_tpu_torch.cmd import options
    from kube_batch_tpu_torch.cmd.server import StandaloneServer
    from kube_batch_tpu_torch.framework.conf import shipped_conf_path
    from kube_batch_tpu_torch.ops import kernels
    from kube_batch_tpu_torch.testing.cycle_drive import make_follower, whatif_body

    bodies = cluster_bodies(n_tasks, n_nodes)
    queues = [q["name"] for q in bodies["queues"]]
    arrive = single_pod_arrivals(queues, ARRIVALS, SEED + 7, "lk")
    opt = options.parse(["--listen-address", "127.0.0.1:0",
                         "--scheduler-conf", shipped_conf_path(),
                         "--cache-sync-timeout", "600",
                         "--state-file", os.path.join(workdir, "state.json")] + WIDE_BUCKET)
    server = StandaloneServer(opt, device=device)
    cache, sched = server.cache, server.sched
    url = f"http://127.0.0.1:{server.admin.port}"
    ends: List[float] = []
    saving = sched.on_cycle_end

    def on_cycle_end():
        saving()
        ends.append(time.perf_counter())

    sched.on_cycle_end = on_cycle_end
    loop = threading.Thread(target=server.serve, daemon=True, name="lock-drive-loop")
    follower = make_follower(cache.replication, server.device)
    report: dict = dict(tasks=n_tasks, nodes=n_nodes, arrivals=ARRIVALS,
                        device=str(server.device))
    outcomes: Dict[str, int] = {}

    def follow():
        cache.replication.barrier()
        for _ in range(1000):
            got = follower.run_once()
            outcomes[got] = outcomes.get(got, 0) + 1
            if got not in ("applied", "resync"):
                return
        fail(f"lock drive: the follower never caught up: {outcomes}")

    try:
        kernels.reset_launches()
        loop.start()
        ingest(url, bodies)
        post_ok(url, "/v1/sync", {})
        wait_for(lambda: ends, 600, "cycle 1")
        binds = cache.binder._backend.binds
        wait_for(lambda: len(binds) >= n_tasks, 600, "cycle 1's binds")
        follow()
        per = -(-ARRIVALS // BURSTS)
        for b in range(BURSTS):
            lo, hi = b * per, min((b + 1) * per, ARRIVALS)
            ingest(url, {k: v[lo:hi] for k, v in arrive.items()})
            wait_for(lambda hi=hi: len(binds) >= n_tasks + hi, 600,
                     f"arrival burst {b} to bind")
            follow()
        statuses = []
        for i in range(WHATIFS):
            status, body, _ms = call(url, "POST", "/v1/whatif",
                                     whatif_body(1 + i, 1000.0, evictions=i == WHATIFS - 1))
            statuses.append(status)
            if status != 200 or "feasible" not in json.loads(body):
                fail(f"lock drive: /v1/whatif answered {status} {body[:200]!r}")
        if outcomes.get("applied", 0) < FOLLOW_RECORDS:
            fail(f"lock drive: the follower applied {outcomes} (want "
                 f"{FOLLOW_RECORDS} records)")
        fut = follower.qp.submit(whatif_body(2, 1000.0))
        follower.qp.batcher.tick(now=follower.qp.batcher.clock.monotonic() + 1e6)
        fut.result(timeout=600)
        sched.stop()
        loop.join(600)
        if loop.is_alive():
            fail("lock drive: the scheduler loop did not stop")
        report.update(cycles=len(ends), bound=len(binds), follower=outcomes,
                      whatif_statuses=statuses, launches=dict(kernels.launches),
                      failed_cycles=sched.failed_cycles,
                      failed_writebacks=sched.failed_writebacks)
        if sched.failed_cycles or sched.failed_writebacks:
            fail(f"lock drive: {sched.failed_cycles} cycles and "
                 f"{sched.failed_writebacks} writebacks failed")
        return report
    finally:
        sched.stop()
        loop.join(600)
        follower.qp.close()
        server.close()


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m kube_batch_tpu_torch.testing.lock_drive")
    ap.add_argument("--tasks", type=int, default=4096)
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    print(json.dumps(drive_lockdep(args.tasks, args.nodes, device=args.device)))


if __name__ == "__main__":
    main()
