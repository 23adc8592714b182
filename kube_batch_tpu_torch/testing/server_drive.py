"""Drives of the standalone server (``cmd/server.py``) for ``chip_smoke.py``.

``drive_server`` runs the leader as ``run`` builds it, in this process so
the kernel launch counters can be read: a ``StandaloneServer`` (the shipped
conf, ``--cache-sync-timeout`` and ``--state-file`` on, the egress bucket
opened wide) with its loop on a thread.  It ingests
``synthetic_cluster(n_tasks, n_nodes, gang_size=4, n_queues=3, seed)``
over HTTP as list bodies, in the order ``synthetic_cluster`` feeds the
handlers (queues, nodes, PodGroups, pods: the column rows, and so the
tie-breaks, follow it), then ``POST /v1/sync``.  After cycle 1 it reads
``/v1/bindings`` (its digest is the drive's ``bindings_digest``, to be
held against ``testing/cycle_drive.drive``'s cycle 1), posts the headline
drive's arrivals (``cycle_drive.add_arrivals``) and waits for them to
bind, stops the loop and reads the kernel launches.  Then what-ifs and a
sweep over HTTP against the same requests through ``QueryPlane.submit``
at the same lease version (byte for byte), a ``FollowerServer`` on a
thread pulling ``/v1/replicate`` over loopback HTTP (once caught up it
must answer the same bytes; its probes' K1 launches are counted apart),
``/metrics``, ``/v1/trace`` and ``/v1/alerts`` read and checked for form,
and ``failover_recover`` on the leader.  The per-cycle ``save_state``
(``on_cycle_end``) is timed where it runs, on the cycle thread.

``drive_server_process`` runs ``python -m kube_batch_tpu_torch.cmd.main``
as a subprocess with ``--state-file``: ingest over HTTP, wait for every
pod to be bound and saved, stop it, restart it from the same file (bound
pods must come back bound to the same nodes and not be placed again),
then a ``--follower`` subprocess that must answer a what-if as the
leader does.  Every subprocess is stopped with SIGINT and must exit by it
(``-SIGINT``, as an uncaught ``KeyboardInterrupt`` ends ``main``) within
its wait; one that exits otherwise or has to be killed fails the drive.

Each drive works in a temporary directory (the state file, the
subprocess logs and flight dumps), removed when the drive passes and kept,
with its path on stderr, when it fails.

    python -m kube_batch_tpu_torch.testing.server_drive --device cpu [--tasks N --nodes N]

rehearses both on the CPU at a small size (``device=None`` means CUDA).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

#: the cluster's, the arrivals' and the what-ifs' seed
SEED = 0
#: pods per list body of the bulk ingest
POD_CHUNK = 10_000
#: what-if requests compared between HTTP and the plane, and the follower
WHATIF_N = 32
#: the egress bucket opened wide: the reference's 50 QPS would take 1 000 s
#: to bind 50 000 pods through the fake binder
WIDE_BUCKET = ["--kube-api-qps", "1e9", "--kube-api-burst", "1000000000"]
#: the subprocess form of ``main(..., device="cpu")`` (the process entry's
#: device is a keyword, not a flag)
CPU_ENTRY = ("import sys; from kube_batch_tpu_torch.cmd.main import main; "
             "sys.exit(main(sys.argv[1:], device='cpu'))")


def fail(msg: str) -> None:
    raise AssertionError(msg)


@contextlib.contextmanager
def _workdir(prefix: str):
    """A temporary directory, removed unless the body raises."""
    path = tempfile.mkdtemp(prefix=prefix)
    try:
        yield path
    except BaseException:
        sys.stderr.write(f"{prefix}: kept {path}\n")
        raise
    shutil.rmtree(path, ignore_errors=True)


# --------------------------------------------------------------------------
# HTTP
# --------------------------------------------------------------------------


def call(url: str, method: str, path: str, body=None, data: bytes = None,
         timeout: float = 600.0):
    """(status, body bytes, ms) of one request; error statuses returned."""
    if data is None and body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            out = r.status, r.read()
    except urllib.error.HTTPError as e:
        out = e.code, e.read()
    return out[0], out[1], (time.perf_counter() - t) * 1e3


def post_ok(url: str, path: str, body) -> float:
    status, resp, ms = call(url, "POST", path, body)
    if status != 200:
        fail(f"POST {path}: {status} {resp[:200]!r}")
    return ms


def wait_for(pred, timeout: float, what: str, poll: float = 0.05):
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            fail(f"timed out after {timeout:.0f} s waiting for {what}")
        time.sleep(poll)


def pct(values, q) -> Optional[float]:
    return float(np.percentile(values, q)) if len(values) else None


def bindings_digest(binds: Dict[str, str]) -> str:
    """A short hash of pod → node: the same for the binder's record of a
    cycle and for ``/v1/bindings`` rows of the same decisions."""
    text = json.dumps(sorted(binds.items()))
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# bodies in the handlers' order
# --------------------------------------------------------------------------


class _Recorder:
    """Collects handler calls, for bodies in the order a builder makes them."""

    def __init__(self, queues=()):
        self.queues = {q: None for q in queues}
        self.pod_groups: List = []
        self.pods: List = []

    def add_pod_group(self, pg) -> None:
        self.pod_groups.append(pg)

    def add_pod(self, pod) -> None:
        self.pods.append(pod)


def cluster_bodies(n_tasks: int, n_nodes: int) -> Dict[str, list]:
    """``synthetic_cluster``'s objects as JSON bodies, kind by kind in its
    handler order."""
    from kube_batch_tpu_torch.api import serialize
    from kube_batch_tpu_torch.testing.cycle_drive import GANG, N_QUEUES
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    src = synthetic_cluster(n_tasks, n_nodes, gang_size=GANG, n_queues=N_QUEUES, seed=SEED)
    try:
        return {
            "queues": [serialize.queue_to_dict(q.queue) for q in src.queues.values()],
            "nodes": [serialize.node_to_dict(n.node) for n in src.nodes.values()],
            "podgroups": [serialize.pod_group_to_dict(j.pod_group)
                          for j in src.jobs.values() if j.pod_group is not None],
            "pods": [serialize.pod_to_dict(p) for p in src.pods.values()],
        }
    finally:
        src.stop()


def arrival_bodies(queues, n_pods: int, seed: int, tag: str) -> Dict[str, list]:
    """``cycle_drive.add_arrivals``' PodGroups and pods as JSON bodies."""
    from kube_batch_tpu_torch.api import serialize
    from kube_batch_tpu_torch.testing.cycle_drive import add_arrivals

    rec = _Recorder(queues)
    add_arrivals(rec, n_pods, seed, tag)
    return {"podgroups": [serialize.pod_group_to_dict(pg) for pg in rec.pod_groups],
            "pods": [serialize.pod_to_dict(p) for p in rec.pods]}


def ingest(url: str, bodies: Dict[str, list]) -> Dict[str, float]:
    """POST every kind as list bodies; the ms and the bytes sent."""
    sent, ms = 0, 0.0
    for kind in ("queues", "nodes", "podgroups", "pods"):
        objs = bodies.get(kind, [])
        for lo in range(0, len(objs), POD_CHUNK):
            data = json.dumps(objs[lo:lo + POD_CHUNK]).encode()
            status, resp, t = call(url, "POST", f"/v1/{kind}", data=data)
            if status != 200 or json.loads(resp) != {
                    "ok": True, "applied": len(objs[lo:lo + POD_CHUNK])}:
                fail(f"ingest {kind}: {status} {resp[:200]!r}")
            sent += len(data)
            ms += t
    return {"ms": ms, "bytes": sent}


def check_exposition(url: str) -> dict:
    """``/metrics``, ``/v1/trace`` and ``/v1/alerts`` are well formed."""
    status, text, metrics_ms = call(url, "GET", "/metrics")
    if status != 200:
        fail(f"/metrics: {status}")
    series = 0
    for line in text.decode().splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            float(value)
            if not key.startswith("volcano_"):
                fail(f"/metrics: series {key!r}")
            series += 1
    status, body, trace_ms = call(url, "GET", "/v1/trace")
    trace = json.loads(body)
    if status != 200 or not trace["last_cycle"] or not trace["last_cycle"]["spans"]:
        fail(f"/v1/trace: {status}, {str(trace)[:200]}")
    status, body, _ = call(url, "GET", "/v1/alerts")
    alerts = json.loads(body)
    if status != 200 or "alerts" not in alerts:
        fail(f"/v1/alerts: {status} {body[:200]!r}")
    return dict(series=series, metrics_ms=metrics_ms, trace_ms=trace_ms,
                cycles_traced=trace["cycles_traced"],
                spans_last_cycle=len(trace["last_cycle"]["spans"]),
                alerts_firing=sorted(k for k, v in alerts["alerts"].items() if v["firing"]))


# --------------------------------------------------------------------------
# the leader in this process
# --------------------------------------------------------------------------


def _whatif_bodies(n: int) -> List[dict]:
    from kube_batch_tpu_torch.testing.cycle_drive import whatif_body

    rng = np.random.default_rng(SEED)
    return [whatif_body(int(rng.integers(1, 9)), float(rng.choice([500.0, 1000.0, 4000.0])),
                        evictions=i % 4 == 3) for i in range(n)]


SWEEP_BODY = {"queue": "q0", "max_count": 64, "requests": {"cpu": 1000.0, "memory": 2.0**30}}


def drive_server(n_tasks: int, n_nodes: int, arrivals: int, device=None) -> dict:
    """The leader and an HTTP follower (module docstring).  Returns the
    report; raises on a failed check."""
    with _workdir("server-drive-") as workdir:
        return _drive_server(n_tasks, n_nodes, arrivals, device, workdir)


def _drive_server(n_tasks: int, n_nodes: int, arrivals: int, device, workdir: str) -> dict:
    from kube_batch_tpu_torch.cmd import options
    from kube_batch_tpu_torch.cmd.server import FollowerServer, StandaloneServer
    from kube_batch_tpu_torch.framework.conf import shipped_conf_path
    from kube_batch_tpu_torch.ops import kernels

    t = time.perf_counter()
    bodies = cluster_bodies(n_tasks, n_nodes)
    queues = [q["name"] for q in bodies["queues"]]
    arrive = arrival_bodies(queues, arrivals, SEED + 1, "arrive")
    build_s = time.perf_counter() - t
    opt = options.parse(["--listen-address", "127.0.0.1:0",
                         "--scheduler-conf", shipped_conf_path(),
                         "--cache-sync-timeout", "600",
                         "--state-file", os.path.join(workdir, "state.json")] + WIDE_BUCKET)
    server = StandaloneServer(opt, device=device)
    cache, sched, qp = server.cache, server.sched, server.query_plane
    if sched.device.type != server.device.type:
        fail(f"the scheduler runs on {sched.device}, the server on {server.device}")
    url = f"http://127.0.0.1:{server.admin.port}"
    save_ms: List[float] = []
    ends: List[float] = []
    saving = sched.on_cycle_end

    def on_cycle_end():
        # the state file's save, where run() puts it: on the cycle thread
        t0 = time.perf_counter()
        saving()
        save_ms.append((time.perf_counter() - t0) * 1e3)
        ends.append(time.perf_counter())

    sched.on_cycle_end = on_cycle_end
    loop = threading.Thread(target=server.serve, daemon=True, name="server-loop")
    follower = fthread = None
    report: dict = dict(tasks=n_tasks, nodes=n_nodes, arrivals=arrivals,
                        device=str(server.device), build_bodies_s=build_s)
    try:
        kernels.reset_launches()
        loop.start()
        report["ingest"] = ingest(url, bodies)
        t_sync = time.perf_counter()
        post_ok(url, "/v1/sync", {})
        wait_for(lambda: ends, 600, "cycle 1")
        report["sync_to_cycle1_end_ms"] = (ends[0] - t_sync) * 1e3
        report["cycle1_ms"] = dict(sched.last_cycle_ms)
        status, body, report["bindings_ms"] = call(url, "GET", "/v1/bindings")
        rows = json.loads(body)
        report["bindings_bytes"] = len(body)
        if status != 200 or len(rows) != n_tasks:
            fail(f"/v1/bindings after cycle 1: {status}, {len(rows)} rows of {n_tasks}")
        report["bindings_digest"] = bindings_digest({r["pod"]: r["node"] for r in rows})
        # the arrivals: PodGroups, then pods, one list body each kind
        n_before = len(ends)
        report["arrivals_ingest"] = ingest(url, arrive)
        binds = cache.binder._backend.binds
        wait_for(lambda: len(binds) > n_tasks, 600, "the arrivals to bind")
        mark = len(ends)
        wait_for(lambda: len(ends) > mark, 600, "the cycle that bound the arrivals")
        sched.stop()
        loop.join(600)
        if loop.is_alive():
            fail("the scheduler loop did not stop")
        report["launches"] = dict(kernels.launches)
        report["cycles"] = len(ends)
        report["cycles_after_arrivals"] = len(ends) - n_before
        report["arrivals_bound"] = len(binds) - n_tasks
        report["save_state_ms"] = save_ms
        report["state_bytes"] = os.path.getsize(opt.state_file)
        report["cycle_last_ms"] = dict(sched.last_cycle_ms)

        # what-ifs: HTTP against the plane itself at one lease version
        lease = qp.broker.current()
        version = None if lease is None else lease.version
        http_ms, plane_ms, answers = [], [], []
        for body in _whatif_bodies(WHATIF_N):
            status, got, ms = call(url, "POST", "/v1/whatif", body)
            t0 = time.perf_counter()
            want = json.dumps(qp.submit(body).result(timeout=600)).encode()
            plane_ms.append((time.perf_counter() - t0) * 1e3)
            http_ms.append(ms)
            if status != 200 or got != want:
                fail(f"whatif over HTTP differs from the plane:\n {got[:300]!r}\n {want[:300]!r}")
            if json.loads(got)["snapshot_version"] != version:
                fail(f"whatif answered at version {json.loads(got)['snapshot_version']}, "
                     f"the lease is {version}")
            answers.append(got)
        status, sweep, _ = call(url, "POST", "/v1/whatif/sweep", SWEEP_BODY)
        if status != 200 or sweep != json.dumps(
                qp.submit_sweep(SWEEP_BODY).result(timeout=600)).encode():
            fail(f"sweep over HTTP differs from the plane: {sweep[:300]!r}")
        feasible = sum(json.loads(a)["feasible"] for a in answers)
        report["whatif"] = dict(
            requests=len(answers), feasible=feasible, lease_version=version,
            http_ms_p50=pct(http_ms, 50), http_ms_p99=pct(http_ms, 99),
            plane_ms_p50=pct(plane_ms, 50), plane_ms_p99=pct(plane_ms, 99),
            sweep_max_fit=json.loads(sweep)["max_fit"])

        # an HTTP follower: caught up, it answers the same bytes
        head = cache.replication.counters()["head_seq"]
        fopt = options.parse(["--listen-address", "127.0.0.1:0", "--follower", url])
        follower = FollowerServer(fopt, device=device)
        furl = f"http://127.0.0.1:{follower.admin.port}"
        t0 = time.perf_counter()
        fthread = threading.Thread(target=follower.serve, daemon=True, name="follower")
        fthread.start()
        applier = follower.follower.applier
        wait_for(lambda: applier.applied_seq >= head, 600, f"the follower to reach {head}")
        catch_up_ms = (time.perf_counter() - t0) * 1e3
        kernels.reset_launches()
        f_ms, lags = [], []
        for body, want in zip(_whatif_bodies(WHATIF_N), answers):
            status, got, ms = call(furl, "POST", "/v1/whatif", body)
            f_ms.append(ms)
            if status != 200 or got != want:
                fail(f"the HTTP follower differs from the leader:\n {got[:300]!r}\n "
                     f"{want[:300]!r}")
            lags.append(json.loads(got)["staleness"]["lag_cycles"])
        status, fsweep, _ = call(furl, "POST", "/v1/whatif/sweep", SWEEP_BODY)
        if status != 200 or fsweep != sweep:
            fail(f"the HTTP follower's sweep differs: {fsweep[:300]!r}")
        report["follower"] = dict(
            head_seq=head, applied_seq=applier.applied_seq, catch_up_ms=catch_up_ms,
            lag_cycles_max=max(lags), http_ms_p50=pct(f_ms, 50), http_ms_p99=pct(f_ms, 99),
            pull_errors=follower.follower.pull_errors, gaps=applier.gaps,
            k1_launches=kernels.launches["masked_best_node_raw"])

        report["exposition"] = check_exposition(url)
        # failover on the leader: warm, and the columns consistent
        t0 = time.perf_counter()
        rec = cache.failover_recover()
        report["failover"] = dict(rec, ms=(time.perf_counter() - t0) * 1e3)
        if rec["mode"] != "warm" or rec["errors"]:
            fail(f"failover_recover: {rec}")
        t0 = time.perf_counter()
        errors = cache.columns.check_consistency(cache)
        report["consistency"] = dict(errors=errors[:5], ms=(time.perf_counter() - t0) * 1e3)
        if errors:
            fail(f"check_consistency after failover: {errors[:5]}")
        return report
    finally:
        sched.stop()
        loop.join(600)
        if follower is not None:
            follower.stop()
            if fthread is not None:
                fthread.join(60)
            follower.close()
        server.close()


# --------------------------------------------------------------------------
# the process entry
# --------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Proc:
    """One server subprocess, its log file and its URL."""

    def __init__(self, name: str, args: List[str], device, workdir: str):
        self.name = name
        self.port = free_port()
        entry = (["-m", "kube_batch_tpu_torch.cmd.main"]
                 if device is None or str(device).startswith("cuda") else ["-c", CPU_ENTRY])
        self.log_path = os.path.join(workdir, f"{name}.log")
        self.log = open(self.log_path, "wb")
        env = dict(os.environ, KB_TRACE_DIR=os.path.join(workdir, "flight"),
                   PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable] + entry + ["--listen-address", f"127.0.0.1:{self.port}"] + args,
            cwd=str(ROOT), env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self.url = f"http://127.0.0.1:{self.port}"
        self.up_s = None
        self.killed = False

    def tail(self) -> str:
        if not self.log.closed:
            self.log.flush()
        with open(self.log_path, "rb") as f:
            return f.read()[-3000:].decode(errors="replace")

    def wait_up(self, timeout: float = 300) -> float:
        def up():
            if self.proc.poll() is not None:
                fail(f"{self.name} exited {self.proc.returncode}:\n{self.tail()}")
            try:
                return call(self.url, "GET", "/healthz", timeout=5)[0] == 200
            except OSError:
                return False

        wait_for(up, timeout, f"{self.name} to listen", poll=0.1)
        self.up_s = time.perf_counter() - self.t0
        return self.up_s

    def stop(self) -> Optional[int]:
        """SIGINT (the loop drains and the listener closes), then kill;
        ``killed`` says whether the kill was needed.  Idempotent."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.killed = True
                self.proc.kill()
                self.proc.wait(30)
        self.log.close()
        return self.proc.returncode

    def stop_clean(self) -> int:
        """:meth:`stop`, failing unless the process ran until the SIGINT
        and exited by it within the wait."""
        code = self.stop()
        if self.killed or code != -signal.SIGINT:
            fail(f"{self.name} did not stop cleanly on SIGINT: exit {code}"
                 f"{', killed after the wait' if self.killed else ''}")
        return code


def _saved_nodes(path: str) -> Dict[str, str]:
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return {}
    return {f"{p.get('namespace', 'default')}/{p['name']}": p["node_name"]
            for p in state["pods"] if p.get("node_name")}


def drive_server_process(n_tasks: int, n_nodes: int, device=None) -> dict:
    """Start, ingest, bind, stop, restart from the state file, and a
    follower process (module docstring)."""
    with _workdir("server-process-") as workdir:
        return _drive_server_process(n_tasks, n_nodes, device, workdir)


def _drive_server_process(n_tasks: int, n_nodes: int, device, workdir: str) -> dict:
    from kube_batch_tpu_torch.framework.conf import shipped_conf_path

    state = os.path.join(workdir, "state.json")
    args = ["--state-file", state, "--scheduler-conf", shipped_conf_path(),
            "--cache-sync-timeout", "300", "--schedule-period", "0.5"] + WIDE_BUCKET
    bodies = cluster_bodies(n_tasks, n_nodes)
    report: dict = dict(tasks=n_tasks, nodes=n_nodes, exits={})
    procs: List[Proc] = []
    try:
        first = Proc("leader", args, device, workdir)
        procs.append(first)
        report["leader_up_s"] = first.wait_up()
        report["ingest"] = ingest(first.url, bodies)
        t0 = time.perf_counter()
        post_ok(first.url, "/v1/sync", {})
        saved = wait_for(lambda: len(_saved_nodes(state)) == n_tasks and _saved_nodes(state),
                         600, "every pod bound and saved")
        report["sync_to_saved_ms"] = (time.perf_counter() - t0) * 1e3
        status, body, _ = call(first.url, "GET", "/v1/bindings")
        before = {r["pod"]: r["node"] for r in json.loads(body)}
        if before != saved:
            fail("the state file's placements differ from /v1/bindings")
        report["exits"]["leader"] = first.stop_clean()

        again = Proc("restarted", args, device, workdir)
        procs.append(again)
        report["restart_up_s"] = again.wait_up()

        def traced_cycles():
            st = json.loads(call(again.url, "GET", "/v1/trace")[1])
            return st["cycles_traced"] >= 2

        wait_for(traced_cycles, 300, "two cycles of the restarted leader")
        rows = json.loads(call(again.url, "GET", "/v1/bindings")[1])
        after = {r["pod"]: r["node"] for r in rows}
        statuses = sorted({r["status"] for r in rows})
        if after != before:
            moved = [k for k in before if after.get(k) != before[k]]
            fail(f"{len(moved)} bound pods moved or vanished across the restart, e.g. {moved[:3]}")
        if statuses != ["BOUND"]:
            fail(f"restored pods were placed again: statuses {statuses}")
        report["restart"] = dict(bound=len(after), statuses=statuses)

        follower = Proc("follower", ["--follower", again.url], device, workdir)
        procs.append(follower)
        report["follower_up_s"] = follower.wait_up()
        body = {"queue": "q0", "count": 2, "requests": {"cpu": 500.0, "memory": 2.0**30}}
        want = call(again.url, "POST", "/v1/whatif", body)

        def answered():
            got = call(follower.url, "POST", "/v1/whatif", body)
            return got[0] == 200 and got[1] == want[1] and got

        t0 = time.perf_counter()
        got = wait_for(answered, 300, "the follower process to answer as the leader",
                       poll=0.2)
        if want[0] != 200:
            fail(f"the leader's what-if: {want[0]} {want[1][:200]!r}")
        report["follower"] = dict(answer_equal=True, wait_ms=(time.perf_counter() - t0) * 1e3,
                                  feasible=json.loads(got[1])["feasible"],
                                  leader_ms=want[2], follower_ms=got[2])
        report["exits"]["follower"] = follower.stop_clean()
        report["exits"]["restarted"] = again.stop_clean()
        return report
    except BaseException:
        for p in procs:
            sys.stderr.write(f"--- {p.name} log ---\n{p.tail()}\n")
        raise
    finally:
        for p in procs:
            p.stop()


def main() -> None:
    ap = argparse.ArgumentParser(prog="server_drive")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    ap.add_argument("--tasks", type=int, default=4096)
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--arrivals", type=int, default=408)
    a = ap.parse_args()
    print(json.dumps(drive_server(a.tasks, a.nodes, a.arrivals, device=a.device)))
    print(json.dumps(drive_server_process(a.tasks, a.nodes, device=a.device)))


if __name__ == "__main__":
    main()
