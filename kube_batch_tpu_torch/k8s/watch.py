"""List+watch front end: a Kubernetes API server → the SchedulerCache,
mirroring ``kube_batch_tpu/k8s/watch.py``.

The standalone analog of the reference's informer wiring (cache.go:256-339):
for each resource, LIST once to seed the cache, then WATCH from the list's
resourceVersion, translating every event through k8s/translate.apply_event.
Reconnects with backoff on stream errors; a 410 Gone (stale resourceVersion)
re-lists, which is also how a restarted scheduler converges — the cache is
reconstructible from the API server exactly like the reference's.

Transport is the port's ``k8s/transport.py`` (stdlib urllib with bearer
token and CA options), so the front end runs in-cluster (serviceaccount
token) or against a kubeconfig-style endpoint without any Kubernetes
client dependency.  The stream layer is injectable (``stream_factory``) so
tests drive recorded event lines through the exact dispatch path.

Beyond the JAX adapter, each resource's seed records its LIST and apply
times (``seed_stats``), ``start`` the time to ``mark_synced``
(``seeded_ms``), and :meth:`join` waits for the watch threads to end once
:meth:`stop` was called and their streams closed.  ``stop`` itself does
not wait: a watch thread may sit in an open stream until the server ends
it (the threads are daemons, as in the JAX package).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

from kube_batch_tpu_torch.k8s.translate import apply_event
from kube_batch_tpu_torch.k8s.transport import ApiTransport

logger = logging.getLogger("kube_batch_tpu_torch")

# resource kind → API path
RESOURCES: Dict[str, str] = {
    "pods": "/api/v1/pods",
    "nodes": "/api/v1/nodes",
    "podgroups": "/apis/scheduling.incubator.k8s.io/v1alpha1/podgroups",
    "queues": "/apis/scheduling.incubator.k8s.io/v1alpha1/queues",
    "poddisruptionbudgets": "/apis/policy/v1/poddisruptionbudgets",
    "priorityclasses": "/apis/scheduling.k8s.io/v1/priorityclasses",
    # the volume-binder feed (cache.go:189-209,258-269,311-320)
    "persistentvolumes": "/api/v1/persistentvolumes",
    "persistentvolumeclaims": "/api/v1/persistentvolumeclaims",
    "storageclasses": "/apis/storage.k8s.io/v1/storageclasses",
}


class WatchAdapter:
    """Replays a cluster's state + changes into a SchedulerCache."""

    def __init__(
        self,
        cache,
        api_server: str = "https://kubernetes.default.svc",
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure: bool = False,
        resources: Iterable[str] = tuple(RESOURCES),
        stream_factory: Optional[Callable] = None,
    ):
        self.cache = cache
        self.transport = ApiTransport(
            api_server, token=token, token_file=token_file,
            ca_file=ca_file, insecure=insecure, role="watch",
        )
        self.resources = tuple(resources)
        # injectable for tests: kind → iterable of (event_type, object);
        # replaces the LIST+WATCH transport, not the dispatch
        self._stream_factory = stream_factory
        self._stop = threading.Event()
        self._threads: list = []
        # kind → {"list_ms", "apply_ms", "items"} of its latest seed
        self.seed_stats: Dict[str, dict] = {}
        self.seeded_ms: Optional[float] = None  # start() → mark_synced

    # ---- transport ----------------------------------------------------
    def _get_json(self, path: str):
        return self.transport.get_json(path)

    def _watch_events(self, path: str):
        return self.transport.stream_lines(path)

    # ---- per-resource loop --------------------------------------------
    def _seed(self, kind: str) -> Optional[str]:
        """LIST → RECONCILE the cache against the listing; returns the
        collection's resourceVersion to watch from.

        A seed also runs after a 410 Gone against an already-populated
        cache, so items apply as upserts (MODIFIED — the cache handlers are
        add-or-update) and objects that vanished during the disconnect are
        deleted, or the scheduler would keep placing against phantom
        capacity."""
        t0 = time.perf_counter()
        listing = self._get_json(RESOURCES[kind])
        t1 = time.perf_counter()
        items = listing.get("items") or []
        for item in items:
            try:
                apply_event(self.cache, kind, "MODIFIED", item)
            except Exception:  # noqa: BLE001 — one bad object must not
                # poison the whole resource's seed (and so the sync barrier)
                logger.exception(
                    "seed: dropping unparseable %s object %s", kind,
                    (item.get("metadata") or {}).get("name"),
                )
        self._reconcile_deletions(kind, items)
        self.seed_stats[kind] = {"list_ms": (t1 - t0) * 1e3,
                                 "apply_ms": (time.perf_counter() - t1) * 1e3,
                                 "items": len(items)}
        return (listing.get("metadata") or {}).get("resourceVersion")

    def _reconcile_deletions(self, kind: str, items) -> None:
        def names():
            return {
                (i.get("metadata") or {}).get("namespace", "default")
                + "/" + (i.get("metadata") or {}).get("name", "")
                for i in items
            }

        cache = self.cache
        # snapshot the key sets under the cache lock: other threads (admin
        # ingest, resync repair) mutate these dicts concurrently
        if kind == "pods":
            listed = names()
            with cache._lock:
                # the STORED pod objects, not synthetic ones — deletion must
                # resolve the real job key (group annotation / owner) or the
                # task leaks in its job and on its node
                stale = [p for k, p in cache.pods.items() if k not in listed]
            for pod in stale:
                cache.delete_pod(pod)
        elif kind == "nodes":
            listed = {(i.get("metadata") or {}).get("name", "") for i in items}
            with cache._lock:
                stale_names = [n for n in cache.nodes if n not in listed]
            for name in stale_names:
                cache.delete_node(name)
        elif kind == "queues":
            listed = {(i.get("metadata") or {}).get("name", "") for i in items}
            with cache._lock:
                stale_names = [q for q in cache.queues if q not in listed]
            for name in stale_names:
                cache.delete_queue(name)
        elif kind == "podgroups":
            listed = names()
            with cache._lock:
                stale_uids = [
                    uid for uid, job in cache.jobs.items()
                    if job.pod_group is not None and not job.pod_group.shadow
                    and uid not in listed
                ]
            for uid in stale_uids:
                cache.delete_pod_group(uid)
        elif kind == "persistentvolumes":
            binder = cache.volume_binder
            # a capability probe, not an event drop: a binder without a pv
            # ledger has nothing to reconcile; ingest misses are surfaced
            # by translate._volume_ingest
            # kbt: allow[KBT008] capability probe, not an event drop: a
            # binder without a pv ledger has nothing to reconcile; ingest
            # misses are separately surfaced by translate._volume_ingest
            pvs = getattr(binder, "pvs", None)
            if pvs is not None:
                listed = {(i.get("metadata") or {}).get("name", "") for i in items}
                for name in [n for n in list(pvs) if n not in listed]:
                    binder.delete_pv(name)
        elif kind == "persistentvolumeclaims":
            binder = cache.volume_binder
            # kbt: allow[KBT008] capability probe (see the pv branch above)
            claims = getattr(binder, "claims", None)  # capability probe
            if claims is not None:
                listed = names()
                for key in [k for k in list(claims) if k not in listed]:
                    binder.delete_pvc(key)
        elif kind == "storageclasses":
            # no other object's events touch the class ledger — a stale
            # provisioner entry would keep its claims "dynamically
            # provisionable" forever
            binder = cache.volume_binder
            # kbt: allow[KBT008] capability probe (see the pv branch above)
            classes = getattr(binder, "storage_classes", None)  # capability probe
            if classes is not None:
                listed = {(i.get("metadata") or {}).get("name", "") for i in items}
                for name in [n for n in list(classes) if n not in listed]:
                    binder.delete_storage_class(name)
        # priorityclasses/pdbs: stale entries are harmless until their next
        # watch event; deletions reconcile through the objects they affect

    def _run_resource(self, kind: str, on_seeded: Callable[[], None]) -> None:
        if self._stream_factory is not None:
            for etype, obj in self._stream_factory(kind):
                if self._stop.is_set():
                    return
                apply_event(self.cache, kind, etype, obj)
            on_seeded()
            return
        # reconnect delays come from the transport's shared RetryPolicy
        # (decorrelated jitter, capped), so resources do not reconnect in
        # lockstep
        backoff = self.transport.retry.backoff_state()
        rv: Optional[str] = None
        seeded = False
        while not self._stop.is_set():
            try:
                if rv is None:
                    rv = self._seed(kind)
                    if not seeded:
                        seeded = True
                        on_seeded()
                path = (
                    f"{RESOURCES[kind]}?watch=true&allowWatchBookmarks=true"
                    + (f"&resourceVersion={rv}" if rv else "")
                )
                for event in self._watch_events(path):
                    if self._stop.is_set():
                        return
                    etype = event.get("type")
                    obj = event.get("object") or {}
                    new_rv = (obj.get("metadata") or {}).get("resourceVersion")
                    if new_rv:
                        rv = new_rv
                    if etype == "BOOKMARK":
                        continue
                    if etype == "ERROR":
                        if obj.get("code") == 410:  # Gone → re-list
                            rv = None
                            break
                        raise RuntimeError(f"watch error for {kind}: {obj}")
                    apply_event(self.cache, kind, etype, obj)
                backoff.reset()
            except Exception as e:  # noqa: BLE001 — reconnect with backoff
                delay = backoff.next()
                logger.warning("watch %s failed (%s); reconnecting in %.1fs",
                               kind, e, delay)
                if self._stop.wait(delay):
                    return

    # ---- lifecycle ----------------------------------------------------
    def replay(self, events: Iterable[Tuple[str, str, dict]]) -> None:
        """Feed (kind, event_type, object) triples straight through the
        dispatch path — what the watch threads do, minus the transport."""
        for kind, etype, obj in events:
            apply_event(self.cache, kind, etype, obj)

    def start(self) -> None:
        """One daemon thread per resource (the informer goroutines);
        mark_synced once every resource finished its initial LIST — the
        WaitForCacheSync barrier (cache.go:363-384)."""
        t0 = time.perf_counter()
        remaining = set(self.resources)
        lock = threading.Lock()
        all_seeded = threading.Event()

        def make_on_seeded(kind):
            def on_seeded():
                with lock:
                    remaining.discard(kind)
                    if not remaining:
                        all_seeded.set()
            return on_seeded

        for kind in self.resources:
            t = threading.Thread(
                target=self._run_resource, args=(kind, make_on_seeded(kind)),
                name=f"kb-watch-{kind}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        if not all_seeded.wait(timeout=600):
            logger.warning("not every watch seeded in time; proceeding")
        self.cache.mark_synced()
        self.seeded_ms = (time.perf_counter() - t0) * 1e3

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float) -> bool:
        """Wait up to ``timeout`` seconds in all for the watch threads to
        end (after :meth:`stop`, once their streams closed); True when
        every one did."""
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self._threads)
