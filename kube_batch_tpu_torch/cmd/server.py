"""HTTP server + process run loop (cmd/kube-batch/app/server.go), mirroring
``kube_batch_tpu/cmd/server.py`` endpoint for endpoint, status code for
status code.

The reference serves Prometheus `/metrics` (+ pprof) on --listen-address
(server.go:96-99) and ingests cluster state through ten API-server informers
(cache.go:256-336). Standalone, the same listener carries both:

- GET  /metrics                — Prometheus text exposition (same metric names)
- GET  /healthz                — liveness
- GET  /version
- GET  /debug/stacks, /debug/pprof?seconds=N — thread dump, sampling profile
- POST/DELETE /v1/pods         — informer-shaped ingest (JSON bodies per
- POST/DELETE /v1/nodes          api/serialize.py); POST is add-or-update,
- POST/DELETE /v1/podgroups      matching the informers' upsert handlers
- POST/DELETE /v1/queues         (event_handlers.go).  A LIST body batches:
- POST        /v1/priorityclasses  the whole batch applies under one cache
- POST/DELETE /v1/poddisruptionbudgets  lock acquisition + one dirty-version
- POST/DELETE /v1/persistentvolumes     advance ({"ok":true,"applied":N})
- POST /v1/sync                — the initial-sync barrier (WaitForCacheSync)
- GET  /v1/queues              — queue list w/ podgroup phase counts (the
                                 Queue CRD status the CLI renders, list.go:51)
- GET  /v1/jobs                — podgroup phases/conditions
- GET  /v1/bindings            — pod→node decisions made so far
- GET  /v1/guard               — result-integrity guard plane state
- GET  /v1/trace               — the last cycle's span tree + flight-recorder
                                 ring stats
- GET  /v1/trace/dumps         — flight-recorder dump index; append
                                 /<name>/<trace.json|meta.json> to stream
                                 one dump's files
- GET  /v1/alerts              — guard trip-rate SLO alert state
- POST /v1/whatif              — batched what-if probe against the lease
                                 (serve/)
- POST /v1/whatif/sweep        — capacity sweep against ONE lease
- GET  /v1/replicate?since=N   — the replication stream (replicate/)

:func:`run` mirrors app.Run (server.go:76-151): build cache + scheduler,
start the HTTP listener, then run the scheduling loop — optionally gated
behind leader election, with or without the in-place warm standby.
``--follower http://leader:port`` boots the replicated read plane instead
(:func:`run_follower`).  :class:`StandaloneServer` and
:class:`FollowerServer` are the two runs split in halves: the constructor
builds (for the leader the cache, scheduler, query plane, publisher and
listener), ``serve`` runs the loop and ``close`` shuts down in the JAX
package's order.

With ``--master http…`` the front end is the apiserver's: a list+watch
adapter (``k8s/watch.py``) seeds the cache and blocks the build until
every resource listed, binds POST ``pods/binding`` and evictions DELETE
the pod (``k8s/bind.py``), status writes PATCH the PodGroup, pod and Queue
status, the PV ledger pre-binds volumes (``cache/volume.K8sPVLedger``),
all through one shared egress bucket, and ``--leader-elect`` holds a
coordination.k8s.io Lease.

Where the port differs (ROADMAP Queue 3): the device is the keyword
``device=`` of :func:`run`, :func:`run_follower` and ``main`` (default
CUDA, raising without a card), not a flag; on CUDA the kernel library is
built and loaded at start, in place of the JAX package's persistent
compilation cache.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import threading
import time
import traceback
from collections import Counter
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.api import serialize
from kube_batch_tpu_torch.api.pod import PersistentVolume, PodDisruptionBudget
from kube_batch_tpu_torch.api.types import PodGroupPhase, queue_phase_counts
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.cmd.leader_election import LeaderElector, LostLeadership
from kube_batch_tpu_torch.cmd.options import ServerOption
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.guard import guard_of
from kube_batch_tpu_torch.obs.alerts import alerts_of
from kube_batch_tpu_torch.obs.trace import tracer_of
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.serve.batcher import QueueFull
from kube_batch_tpu_torch.serve.plane import WhatifError
from kube_batch_tpu_torch.version import version_string

logger = logging.getLogger("kube_batch_tpu_torch")

#: the values of KB_WHATIF / KB_REPLICATE that turn the plane off (any
#: other value, unset included, leaves it on: the JAX package's rule)
_OFF = ("0", "false", "off", "no")


def _on(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in _OFF


def _queue_status(cache) -> list:
    """Queue list with the CRD's status counts (types.go:211-223)."""
    with cache._lock:
        counts = {name: queue_phase_counts() for name in cache.queues}
        for job in cache.jobs.values():
            c = counts.get(job.queue)
            if c is None or job.pod_group is None:
                continue
            phase = job.pod_group.phase or PodGroupPhase.PENDING
            c[phase.value.lower()] = c.get(phase.value.lower(), 0) + 1
        return [
            {"name": name, "weight": q.weight, **counts[name]}
            for name, q in sorted(cache.queues.items())
        ]


def _job_status(cache) -> list:
    with cache._lock:
        rows = []
        for uid, job in sorted(cache.jobs.items()):
            pg = job.pod_group
            rows.append(
                {
                    "uid": uid,
                    "queue": job.queue,
                    "min_member": job.min_available,
                    "phase": (pg.phase.value if pg and pg.phase else "Pending"),
                    "running": pg.running if pg else 0,
                    "conditions": [
                        {"type": c.type, "status": c.status, "reason": c.reason,
                         "message": c.message}
                        for c in (pg.conditions if pg else [])
                    ],
                }
            )
        return rows


def _bindings(cache) -> list:
    with cache._lock:
        out = []
        for job in cache.jobs.values():
            for task in job.tasks.values():
                if task.node_name is not None:
                    out.append({"pod": task.key(), "node": task.node_name,
                                "status": task.status.name})
        return sorted(out, key=lambda r: r["pod"])


def _profile(seconds: float) -> str:
    """The CPU-profile analog of /debug/pprof: a wall-clock SAMPLING
    profiler over every thread but the caller's, sample counts per stack,
    hottest first."""
    interval = 0.01
    me = threading.get_ident()
    stacks: Counter = Counter()
    deadline = time.monotonic() + seconds
    n_samples = 0
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            # raw (code, lineno) pairs: stacks are formatted once at the end
            key = []
            f = frame
            while f is not None and len(key) < 12:
                key.append((f.f_code, f.f_lineno))
                f = f.f_back
            stacks[tuple(key)] += 1
        n_samples += 1
        # kbt: allow[KBT011] profiler sampling cadence — a
        # fixed-interval sampler, not a retry/backoff loop
        time.sleep(interval)  # the sampling cadence
    out = [
        f"samples: {n_samples} over {seconds:.1f}s "
        f"({len(stacks)} distinct stacks)",
        "NOTE: wall-clock sampler — blocked/sleeping stacks count "
        "the same as busy ones (a mostly-idle scheduler tops out "
        "in its sleep/select frames); read busy stacks relative "
        "to each other for the CPU picture",
    ]
    for key, count in stacks.most_common(40):
        out.append(f"\n{count} samples ({100.0 * count / max(1, n_samples):.0f}%):")
        out.extend(
            f"  {code.co_filename.rsplit('/', 1)[-1]}:{lineno} {code.co_name}"
            for code, lineno in reversed(key)
        )
    return "\n".join(out)


def make_handler(cache, query_plane=None):
    ingest = {
        # POST is add-or-update: update_pod is delete+add (event_handlers.go:116-130)
        "pods": (serialize.pod_from_dict, cache.update_pod, cache.delete_pod),
        "nodes": (serialize.node_from_dict, cache.add_node,
                  lambda n: cache.delete_node(n.name)),
        "podgroups": (serialize.pod_group_from_dict, cache.add_pod_group,
                      lambda pg: cache.delete_pod_group(pg.key())),
        "queues": (serialize.queue_from_dict, cache.add_queue,
                   lambda q: cache.delete_queue(q.name)),
        "priorityclasses": (serialize.priority_class_from_dict,
                            cache.add_priority_class,
                            lambda pc: cache.delete_priority_class(pc.name)),
        # legacy gang source (event_handlers.go:484-594)
        "poddisruptionbudgets": (
            lambda d: PodDisruptionBudget(**d), cache.add_pdb, cache.delete_pdb),
        # PV ledger ingest (the pv informer analog, cache.go:189-209); no-op
        # adds / deletes when the volume binder keeps no ledger
        "persistentvolumes": (
            lambda d: PersistentVolume(**d),
            lambda pv: getattr(cache.volume_binder, "add_pv", lambda _: None)(pv),
            lambda pv: getattr(cache.volume_binder, "delete_pv", lambda _: None)(pv.name),
        ),
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

        def _send(self, code: int, body: str, ctype="application/json"):
            self._send_bytes(code, body.encode(), ctype)

        def _send_bytes(self, code: int, data: bytes,
                        ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, metrics.render_prometheus(), "text/plain; version=0.0.4")
            elif self.path == "/healthz":
                self._send(200, "ok", "text/plain")
            elif self.path == "/version":
                self._send(200, version_string(), "text/plain")
            elif self.path == "/debug/stacks":
                # pprof goroutine-dump analog (main.go:25 net/http/pprof)
                out = []
                for tid, frame in sys._current_frames().items():
                    out.append(f"--- thread {tid} ---")
                    out.extend(line.rstrip() for line in traceback.format_stack(frame))
                self._send(200, "\n".join(out), "text/plain")
            elif self.path.startswith("/debug/pprof"):
                q = parse_qs(urlparse(self.path).query)
                try:
                    seconds = float(q.get("seconds", ["5"])[0])
                except ValueError:
                    self._send(400, "seconds must be a number", "text/plain")
                    return
                if not math.isfinite(seconds) or seconds <= 0:
                    self._send(400, "seconds must be a positive finite number",
                               "text/plain")
                    return
                self._send(200, _profile(min(seconds, 60.0)), "text/plain")
            elif self.path == "/v1/queues":
                self._send(200, json.dumps(_queue_status(cache)))
            elif self.path == "/v1/jobs":
                self._send(200, json.dumps(_job_status(cache)))
            elif self.path == "/v1/bindings":
                self._send(200, json.dumps(_bindings(cache)))
            elif self.path == "/v1/guard":
                # per-fast-path breaker, trips, audits, bundle paths
                self._send(200, json.dumps(guard_of(cache).state()))
            elif self.path == "/v1/trace":
                self._send(200, json.dumps(tracer_of(cache).state()))
            elif self.path == "/v1/trace/dumps" or self.path.startswith(
                "/v1/trace/dumps/"
            ):
                self._trace_dumps()
            elif self.path == "/v1/replicate" or self.path.startswith(
                "/v1/replicate?"
            ):
                self._replicate()
            elif self.path == "/v1/alerts":
                self._send(200, json.dumps(alerts_of(cache).state()))
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _replicate(self):
            """The leader's replication endpoint: one KBR1 frame per pull,
            chosen by the follower's applied cursor (a heartbeat when caught
            up, a synthesized full frame when the cursor fell off the ring)."""
            pub = getattr(cache, "replication", None)
            if pub is None:
                self._send(503, json.dumps({"error": "replication not enabled"}))
                return
            q = parse_qs(urlparse(self.path).query)
            try:
                since = int(q.get("since", ["-1"])[0])
            except ValueError:
                self._send(400, json.dumps({"error": "since must be an integer"}))
                return
            self._send_bytes(200, pub.record_for(since))

        def _trace_dumps(self):
            """The index lists every dump this process published;
            /<name>/<trace.json|meta.json> streams one file.  Only names
            the recorder itself registered resolve, so no path escapes."""
            recorder = tracer_of(cache).recorder
            dumps = recorder.stats()["dumps"] if recorder is not None else []
            by_name = {os.path.basename(p): p for p in dumps}
            rest = self.path[len("/v1/trace/dumps"):].strip("/")
            if not rest:
                self._send(200, json.dumps({
                    "dumps": sorted(by_name),
                    "directory": recorder.directory if recorder else None,
                }))
                return
            parts = rest.split("/")
            root = by_name.get(parts[0])
            if root is None or len(parts) != 2 or parts[1] not in (
                "trace.json", "meta.json"
            ):
                self._send(404, json.dumps({"error": "no such dump file"}))
                return
            try:
                with open(os.path.join(root, parts[1]), "rb") as f:
                    self._send_bytes(200, f.read(), "application/json")
            except OSError as e:
                self._send(404, json.dumps({"error": str(e)}))

        def _ingest(self, delete: bool):
            kind = self.path.rsplit("/", 1)[-1]
            entry = ingest.get(kind)
            if entry is None:
                self._send(404, json.dumps({"error": f"unknown kind {kind}"}))
                return
            parse, add, remove = entry
            apply_fn = remove if delete else add
            try:
                body = self._body()
                if isinstance(body, list):
                    # batched ingest: the whole batch parses before any
                    # element applies (a malformed element rejects it), then
                    # applies under ONE cache lock acquisition and ONE
                    # dirty-version advance (cache.ingest_batch)
                    ops = [(apply_fn, parse(d)) for d in body]
                    applied = cache.ingest_batch(ops)
                    if applied < len(ops):
                        # an element whose handler raised: the single-object
                        # path's 400, with the partial count
                        self._send(400, json.dumps({
                            "ok": False, "applied": applied,
                            "failed": len(ops) - applied}))
                        return
                    self._send(200, json.dumps({"ok": True, "applied": applied}))
                    return
                apply_fn(parse(body))
            except (TypeError, ValueError, KeyError) as e:
                self._send(400, json.dumps({"error": str(e)}))
                return
            self._send(200, json.dumps({"ok": True}))

        def do_POST(self):
            if self.path == "/v1/sync":
                # initial-sync barrier: a client that finished its re-list
                # signals the scheduler to start (WaitForCacheSync analog)
                cache.mark_synced()
                self._send(200, "{}")
                return
            if self.path == "/v1/whatif":
                self._whatif(lambda body: query_plane.submit(body))
                return
            if self.path == "/v1/whatif/sweep":
                self._whatif(lambda body: query_plane.submit_sweep(body))
                return
            self._ingest(delete=False)

        def _whatif(self, submit):
            """Validate, enqueue into the micro-batcher and block this
            handler thread on the request's future (every request has its
            own thread, so concurrent handlers share one probe dispatch)."""
            if query_plane is None:
                self._send(503, json.dumps({"error": "query plane not enabled"}))
                return
            try:
                body = self._body()
            except ValueError as e:  # json.JSONDecodeError included
                self._send(400, json.dumps({"error": str(e)}))
                return
            try:
                fut = submit(body)
                resp = fut.result(timeout=query_plane.dispatch_timeout + 8)
            except WhatifError as e:
                self._send(e.status, json.dumps({"error": str(e)}))
                return
            except QueueFull as e:
                self._send(503, json.dumps({"error": str(e)}))
                return
            except (FutureTimeout, TimeoutError):
                # abandon the queued probe: a cancelled future is skipped at
                # flush; a failed cancel means the flush is resolving it now
                fut.cancel()
                self._send(503, json.dumps({"error": "whatif probe timed out"}))
                return
            self._send(200, json.dumps(resp))

        def do_DELETE(self):
            self._ingest(delete=True)

    return Handler


class AdminServer:
    """The --listen-address listener (server.go:96-99).  With a
    ``query_plane`` the same listener serves ``POST /v1/whatif`` beside
    the admin and ingest API."""

    def __init__(self, cache, host: str = "127.0.0.1", port: int = 0,
                 query_plane=None):
        self.query_plane = query_plane
        self.httpd = ThreadingHTTPServer(
            (host, port), make_handler(cache, query_plane=query_plane)
        )
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="admin-http"
        )
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        # bounded join: don't hang stop() on a wedged in-flight handler
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class TokenBucket:
    """The client-side 50 QPS / 100-burst throttle of the reference
    (options.go:32-33, server.go:69-70).  The reference has ONE
    rest.Config — binder, evictor and status updater ride the same rate
    limiter — so one bucket instance is shared across every egress
    wrapper."""

    def __init__(self, qps: float, burst: int):
        self._qps = qps
        self._burst = float(burst)
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()
        self._time = time

    def take(self) -> None:
        """Reserve a token under the lock, sleep OUTSIDE it.  The balance
        may go negative: each waiter's debt is its reservation and its wait
        the time until its own token mints, so concurrent waiters sleep in
        parallel while tokens still mint at qps with a burst cap."""
        with self._lock:
            now = self._time.monotonic()
            self._tokens = min(self._burst, self._tokens + (now - self._last) * self._qps)
            self._last = now
            self._tokens -= 1.0
            wait = -self._tokens / self._qps if self._tokens < 0.0 else 0.0
        if wait > 0.0:
            self._time.sleep(wait)


class RateLimitedBackend:
    """Token-bucket throttle on the Binder / Evictor seam.  Pass a shared
    TokenBucket as ``bucket`` so several seams drain one budget; qps /
    burst build a private bucket."""

    def __init__(self, backend, qps: float = 0.0, burst: int = 0,
                 bucket: Optional[TokenBucket] = None):
        if bucket is None and qps <= 0.0:
            raise ValueError("RateLimitedBackend needs a shared bucket or qps > 0")
        self._backend = backend
        self._bucket = bucket if bucket is not None else TokenBucket(qps, burst)

    def _take(self) -> None:
        self._bucket.take()

    def bind(self, pod, hostname):
        self._take()
        return self._backend.bind(pod, hostname)

    def evict(self, pod):
        self._take()
        return self._backend.evict(pod)


class RateLimitedStatusUpdater(RateLimitedBackend):
    """The same token bucket on the StatusUpdater seam (server.go:69-70).
    ``parallel_safe`` and the writeback-breaker probe ``degraded`` pass
    through to the wrapped updater."""

    @property
    def parallel_safe(self):
        return getattr(self._backend, "parallel_safe", False)

    def degraded(self):
        probe = getattr(self._backend, "degraded", None)
        return bool(probe()) if probe is not None else False

    def update_pod_group(self, pg):
        self._take()
        return self._backend.update_pod_group(pg)

    def update_pod_condition(self, pod, cond):
        self._take()
        return self._backend.update_pod_condition(pod, cond)

    def update_queue_status(self, name, counts):
        self._take()
        return self._backend.update_queue_status(name, counts)


def run_warm_standby(elector, sched: Scheduler, cache: SchedulerCache,
                     max_takeovers: Optional[int] = None) -> None:
    """Leadership loop with in-place warm standby (beyond the reference's
    crash-on-loss): a lost lease stops the scheduling loop but not the
    process — the device-resident snapshot and the loaded kernels stay —
    and the elector re-contends.  On every re-acquire the cache recovers
    through ``failover_recover`` (rebuild from the pod store, then
    revalidate or drop the resident device cache).  ``max_takeovers``
    bounds the loop for tests; production runs forever."""
    takeovers = 0

    def lead():
        # recovery runs after the lease is won and before the new reign's
        # first cycle
        if takeovers > 1:
            cache.failover_recover()
        sched.run_forever()

    while max_takeovers is None or takeovers < max_takeovers:
        takeovers += 1
        try:
            elector.run(lead, on_stopped_leading=sched.stop)
            return  # clean stop (sched.stop() by other means)
        except LostLeadership:
            logger.warning(
                "leadership lost; demoting to warm standby (resident cache "
                "kept) and re-contending")
            elector.reset()


def _device_for(device):
    """Resolve the process's device and, on CUDA, build and load the kernel
    library before anything serves (the port's cold start is the nvcc
    build, not a compile cache)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from kube_batch_tpu_torch.ops import _build

        _build.load_library()
    return dev


class FollowerServer:
    """The replicated read plane's process (--follower URL): no scheduler,
    no ingest — a pull thread applies the leader's /v1/replicate records to
    a local device-resident replica, and the admin listener serves the same
    /v1/whatif stack (plus sweep, trace and metrics) against it.  The
    constructor builds and starts the listener; :meth:`serve` runs the
    pull loop until :meth:`stop`; :meth:`close` shuts down."""

    def __init__(self, opt: ServerOption, device=None):
        from kube_batch_tpu_torch.replicate.follower import FollowerCache, ReplicationFollower
        from kube_batch_tpu_torch.serve.plane import QueryPlane

        self.device = _device_for(device)
        self.cache = FollowerCache()
        self.query_plane = QueryPlane(self.cache, prewarm=True)
        try:
            self.follower = ReplicationFollower(opt.follower, cache=self.cache,
                                                query_plane=self.query_plane,
                                                device=self.device)
            host, port = opt.listen_host_port
            self.admin = AdminServer(self.cache, host, port, query_plane=self.query_plane)
        except BaseException:
            self.query_plane.close()
            raise
        self.admin.start()
        logger.info("follower serving on %s:%d, replicating from %s", host,
                    self.admin.port, opt.follower)

    def serve(self) -> None:
        self.follower.start()
        try:
            self.follower.join()
        finally:
            self.follower.stop()

    def stop(self) -> None:
        """End :meth:`serve` (the pull loop stops; the listener stays up
        until :meth:`close`)."""
        self.follower.stop()

    def close(self) -> None:
        self.follower.stop()
        self.query_plane.close()
        self.admin.stop()


def run_follower(opt: ServerOption, device=None) -> None:
    """The follower's process loop (``FollowerServer``), until its pull
    loop stops."""
    server = FollowerServer(opt, device=device)
    try:
        server.serve()
    finally:
        server.close()


class StandaloneServer:
    """``run``'s leader branches, split in two: the constructor builds
    what app.Run builds (the shared egress bucket over the binder and
    evictor, the status updater and the PV ledger; the cache — restored
    from ``--state-file`` when one exists, with a per-cycle save — the
    scheduler, the query plane and the replication publisher unless
    ``KB_WHATIF`` / ``KB_REPLICATE`` turn them off, the started listener
    and, with ``--master``, the watch adapter, started here so the build
    returns once every resource listed and the cache is synced);
    :meth:`serve` runs the loop; :meth:`close` shuts down (the watch, the
    planes, the listener, then the cache's workers and the PV ledger's
    writer and retry timer).

    Standalone, the binder and evictor are the recording fakes behind the
    ingest API and the ledger is ``StandalonePVBinder``; with ``--master
    http…`` they are ``K8sBackend`` and ``K8sPVLedger`` on the apiserver."""

    def __init__(self, opt: ServerOption, device=None):
        self.opt = opt
        self.device = _device_for(device)
        # with a k8s front end (--master), binds/evictions write back to
        # the apiserver (pods/binding POST, pod DELETE); standalone keeps
        # the recording fakes behind the ingest API
        self.k8s_mode = opt.master.startswith("http")
        # one bucket for ALL egress (binds + evictions + status writes): the
        # reference's writes share a single throttled rest.Config
        self.bucket = TokenBucket(opt.kube_api_qps, opt.kube_api_burst)
        self.auth: dict = {}
        if self.k8s_mode:
            from kube_batch_tpu_torch.cache.volume import K8sPVLedger
            from kube_batch_tpu_torch.k8s.bind import K8sBackend
            from kube_batch_tpu_torch.k8s.transport import in_cluster_auth

            self.auth = in_cluster_auth()
            backend = K8sBackend(opt.master, **self.auth)
            binder = evictor = backend
            status_updater = RateLimitedStatusUpdater(backend, bucket=self.bucket)
            # pv/pvc/storageclass watches feed this ledger; its claimRef /
            # selected-node PATCHes ride the backend's own transport AND the
            # same shared token bucket as every other egress write
            volume_binder = K8sPVLedger(transport=backend.transport, bucket=self.bucket)
        else:
            from kube_batch_tpu_torch.cache.fake import FakeBinder, FakeEvictor
            from kube_batch_tpu_torch.cache.volume import StandalonePVBinder

            binder, evictor = FakeBinder(), FakeEvictor()
            status_updater = None  # the cache default: the recording fake
            volume_binder = StandalonePVBinder()  # behind /v1/persistentvolumes
        cache = self.cache = SchedulerCache(
            scheduler_name=opt.scheduler_name,
            default_queue=opt.default_queue,
            binder=RateLimitedBackend(binder, bucket=self.bucket),
            evictor=RateLimitedBackend(evictor, bucket=self.bucket),
            status_updater=status_updater,
            volume_binder=volume_binder,
            resolve_priority=opt.enable_priority_class,
        )
        on_cycle_end = None
        if opt.state_file:
            from kube_batch_tpu_torch.cache.persistence import load_state, save_state

            if load_state(cache, opt.state_file):
                logger.info("restored cluster state from %s", opt.state_file)
                cache.mark_synced()  # the state file IS the initial listing
            on_cycle_end = lambda: save_state(cache, opt.state_file)  # noqa: E731
        self.sched = Scheduler(
            cache,
            conf_path=opt.scheduler_conf or None,
            schedule_period=opt.schedule_period,
            on_cycle_end=on_cycle_end,
            device=self.device,
        )
        # the read-side query plane: /v1/whatif rides the same listener;
        # KB_WHATIF=0 opts out
        self.query_plane = None
        if _on("KB_WHATIF"):
            from kube_batch_tpu_torch.serve.plane import QueryPlane

            self.query_plane = QueryPlane(cache, prewarm=True)
            # each lease goes out on GET /v1/replicate for followers;
            # KB_REPLICATE=0 opts out
            if _on("KB_REPLICATE"):
                from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher

                cache.replication = ReplicationPublisher(tracer=tracer_of(cache))
        self.watcher = None
        host, port = opt.listen_host_port
        try:
            self.admin = AdminServer(cache, host, port, query_plane=self.query_plane)
        except BaseException:
            self._close_planes()
            raise
        self.admin.start()
        logger.info("admin/metrics listening on %s:%d (whatif %s, device %s)", host,
                    self.admin.port, "on" if self.query_plane is not None else "off",
                    self.device)
        if self.k8s_mode:
            # the informers (cache.go:256-339): start() BLOCKS until every
            # resource finished its initial LIST and then marks the cache
            # synced — the reference's WaitForCacheSync gate before the
            # first cycle (scheduler.go:64); scheduling against a
            # half-seeded cache would overstate node idle capacity
            from kube_batch_tpu_torch.k8s.watch import WatchAdapter

            self.watcher = WatchAdapter(cache, api_server=opt.master, **self.auth)
            logger.info("seeding from kubernetes apiserver %s ...", opt.master)
            try:
                self.watcher.start()
            except BaseException:
                self.close()
                raise
            logger.info("kubernetes watch adapter synced against %s", opt.master)

    def serve(self) -> None:
        """WaitForCacheSync (bounded by ``--cache-sync-timeout``; off at 0),
        then the scheduling loop until ``sched.stop()`` — behind leader
        election when enabled (the Lease on the apiserver with
        ``--master``, else the file lock), in place as a warm standby with
        ``--leader-warm-standby``, else crashing on a lost lease."""
        opt, sched = self.opt, self.sched
        if opt.cache_sync_timeout > 0:
            self.cache.wait_for_cache_sync(timeout=opt.cache_sync_timeout)
        if opt.enable_leader_election:
            if self.k8s_mode:
                # cross-host HA rides the cluster API: a coordination.k8s.io
                # Lease in --lock-object-namespace (the reference's ConfigMap
                # resourcelock, server.go:106-151), no shared filesystem
                from kube_batch_tpu_torch.cmd.leader_election import K8sLeaseElector
                from kube_batch_tpu_torch.k8s.transport import ApiTransport

                elector = K8sLeaseElector(
                    ApiTransport(opt.master, role="lease", **self.auth),
                    namespace=opt.lock_object_namespace)
            else:
                elector = LeaderElector(opt.lock_object_namespace)
            if opt.leader_warm_standby:
                run_warm_standby(elector, sched, self.cache)
            else:
                # on lease loss the elector stops the loop so serve() raises
                # — the crash-on-loss contract (server.go:145)
                elector.run(sched.run_forever, on_stopped_leading=sched.stop)
        else:
            sched.run_forever()

    def _close_planes(self) -> None:
        if self.query_plane is not None:
            self.query_plane.close()
        pub = getattr(self.cache, "replication", None)
        if pub is not None:
            pub.close()

    def close(self) -> None:
        """The watch stops taking events (its threads end when their
        streams close: :meth:`WatchAdapter.join`), then the planes, the
        listener and the cache's workers, the PV ledger's writer and retry
        timer with them (``SchedulerCache.stop``)."""
        if self.watcher is not None:
            self.watcher.stop()
        self._close_planes()
        self.admin.stop()
        self.cache.stop()


def run(opt: ServerOption, device=None) -> None:
    """app.Run (server.go:76-151): the admin listener up front, then the
    scheduling loop.  Option validation and --version live in
    cmd/main.py."""
    if opt.follower:
        return run_follower(opt, device=device)
    server = StandaloneServer(opt, device=device)
    try:
        server.serve()
    finally:
        server.close()
