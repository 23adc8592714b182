"""Standalone PV ledger — a real VolumeBinder behind the cache's seams.

Mirrors ``StandalonePVBinder`` of ``kube_batch_tpu/cache/volume.py``.  The
reference wraps the k8s volumebinder: AllocateVolumes assumes the pod's
PVC→PV bindings for a host (and can fail the placement), BindVolumes makes
them durable (cache.go:189-209, 258-269).  Standalone there is no
apiserver, so the ledger is the source of truth: PersistentVolumes are
ingested like nodes, claims resolve against them at allocate time, and a
node from which a required PV is unreachable fails the placement
(FitFailure: the action falls back to the next candidate).

``allocate_volumes`` is idempotent per task: it drops the task's previous
reservation, then reserves for the new host, so the allocate replay's
volume pre-check and a demoted job's sequential replay never double-book.
One re-entrant lock covers the ledgers: ingest arrives on other threads
(the staging thread applies ``delete_pod``, whose ``release_task`` lands
here) while the cycle thread allocates and the bind replay binds.

``K8sPVLedger`` is the ``--master`` ledger, fed by the pv, pvc and
storageclass watches, writing its durable bindings back to the apiserver.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from kube_batch_tpu_torch.api.pod import (
    HOSTNAME_TOPOLOGY,
    PersistentVolume,
    PersistentVolumeClaim,
    node_selector_terms_match,
)

logger = logging.getLogger("kube_batch_tpu_torch")


class _Taken:
    """One probe's taken-PV state: the task, its picks so far (a live view
    the caller appends to) and the memoized ledger scan."""

    __slots__ = ("task_uid", "picked", "base")

    def __init__(self, task_uid: str, picked):
        self.task_uid = task_uid
        self.picked = picked
        self.base: Optional[set] = None


class StandalonePVBinder:
    """VolumeBinder over a local PV ledger."""

    noop = False  # the allocate replay must run its volume pre-check

    def __init__(self):
        self.pvs: Dict[str, PersistentVolume] = {}
        self.bound: Dict[str, str] = {}  # claim → pv name (durable binding)
        # task uid → {claim: pv name}, assumed this cycle
        self.reservations: Dict[str, Dict[str, str]] = {}
        # node name → labels, fed by the cache's node ingest: the node terms
        # of a topology-restricted PV evaluate against these
        self.node_labels: Dict[str, Dict[str, str]] = {}
        self._sorted_pvs: Optional[list] = None  # memo; reset on ledger change
        self._lock = threading.RLock()

    # -- ledger ingest (the pv informer's analog) -------------------------
    def add_pv(self, pv: PersistentVolume) -> None:
        with self._lock:
            self.pvs[pv.name] = pv
            self._sorted_pvs = None

    def delete_pv(self, name: str) -> None:
        with self._lock:
            self.pvs.pop(name, None)
            self._sorted_pvs = None

    # -- node-label ingest (the cache's add_node / delete_node) -----------
    def set_node_labels(self, name: str, labels: Dict[str, str]) -> None:
        # the kubelet-set hostname label and metadata.name both equal the
        # node name: merged once here, not per reachability probe
        merged = {HOSTNAME_TOPOLOGY: name, "metadata.name": name, **(labels or {})}
        with self._lock:
            self.node_labels[name] = merged

    def forget_node_labels(self, name: str) -> None:
        with self._lock:
            self.node_labels.pop(name, None)

    def _reachable(self, pv: PersistentVolume, hostname: str) -> bool:
        """Can ``hostname`` attach ``pv``?  A single-node pin (or no
        affinity) answers without labels; a topology-restricted PV
        evaluates its node terms against the node's labels.  A node whose
        labels were never ingested decides hostname-shaped terms only and
        fails closed on any other key."""
        if pv.node is None or pv.node == hostname:
            return True
        terms = pv.node_terms
        if not terms:
            return False
        labels = self.node_labels.get(hostname)
        if labels is None:
            hostname_keys = (HOSTNAME_TOPOLOGY, "metadata.name")
            if any(key not in hostname_keys
                   for term in terms for key, _op, _vals in term):
                return False
            labels = {HOSTNAME_TOPOLOGY: hostname, "metadata.name": hostname}
        return node_selector_terms_match(terms, labels)

    def _candidates(self) -> list:
        """PVs in match order (pre-bound first, then by name), memoized."""
        if self._sorted_pvs is None:
            self._sorted_pvs = sorted(self.pvs.values(),
                                      key=lambda pv: (pv.claim is None, pv.name))
        return self._sorted_pvs

    # -- internals --------------------------------------------------------
    def _reserved_pvs(self, excluding_task: Optional[str] = None) -> set:
        held = set(self.bound.values())
        for uid, res in self.reservations.items():
            if uid != excluding_task:
                held.update(res.values())
        return held

    def _resolve(self, claim: str, hostname: str, taken: "_Taken") -> Optional[str]:
        """A PV for ``claim`` reachable from ``hostname``: a durable binding
        wins, then a pre-bound PV, then any free wildcard PV.  The PVs
        already taken (``_held(taken)``) are read only when a free PV must
        be found."""
        bound_pv = self.bound.get(claim)
        if bound_pv is not None:
            pv = self.pvs.get(bound_pv)
            if pv is not None and self._reachable(pv, hostname):
                return bound_pv
            return None
        held = self._held(taken)
        for pv in self._candidates():
            if pv.claim is not None and pv.claim != claim:
                continue
            if not self._reachable(pv, hostname):
                continue
            if pv.name in held:
                continue
            return pv.name
        return None

    def _held(self, taken: "_Taken") -> set:
        """The PVs taken for ``taken.task_uid``: everything bound or
        reserved by another task, plus this task's picks so far; the ledger
        scan runs once per outer probe (memoized on ``taken``).  A method
        of its own, called only from the resolvers under the lock, so that
        tier D credits the ledger reads with the lock."""
        if taken.base is None:
            taken.base = self._reserved_pvs(excluding_task=taken.task_uid)
        return taken.base | set(taken.picked)

    def volume_feasible(self, task, hostname: str) -> bool:
        """A probe without side effects: could ``allocate_volumes`` succeed
        now?  The sequential placement path uses it as a host predicate."""
        claims = task.pod.volume_claims
        if not claims:
            return True
        with self._lock:
            picked: list = []
            taken = _Taken(task.uid, picked)
            for claim in claims:
                pv = self._resolve(claim, hostname, taken)
                if pv is None:
                    return False
                picked.append(pv)
            return True

    # -- VolumeBinder seam ------------------------------------------------
    def allocate_volumes(self, task, hostname: str) -> None:
        """Assume the task's claims onto PVs reachable from ``hostname``,
        replacing any reservation the task held; raises FitFailure when a
        claim cannot be satisfied there."""
        from kube_batch_tpu_torch.framework.session import FitFailure

        claims = task.pod.volume_claims
        with self._lock:
            self.reservations.pop(task.uid, None)
            if not claims:
                return
            picked: Dict[str, str] = {}
            taken = _Taken(task.uid, picked.values())
            for claim in claims:
                pv = self._resolve(claim, hostname, taken)
                if pv is None:
                    raise FitFailure(
                        f"volume claim {claim!r} has no PV reachable from {hostname}")
                picked[claim] = pv
            self.reservations[task.uid] = picked

    def bind_volumes(self, task) -> None:
        """Make the task's assumed bindings durable (BindVolumes,
        cache.go:258-269)."""
        with self._lock:
            picked = self.reservations.pop(task.uid, None)
            if picked:
                self.bound.update(picked)

    def release_task(self, task_uid: str) -> None:
        """Drop a task's assumed, unbound reservation (its pod left the
        cluster, or its placement was discarded), so the PVs free up."""
        with self._lock:
            self.reservations.pop(task_uid, None)


# k8s dynamic-provisioning marker class; every other provisioner value means
# the cluster creates a volume on demand (the static marker is the k8s
# convention for local/manual PVs)
NO_PROVISIONER = "kubernetes.io/no-provisioner"
# the WaitForFirstConsumer hand-off annotation the scheduler writes so the
# PV controller binds the claim to a volume reachable from the chosen node
SELECTED_NODE_ANNOTATION = "volume.kubernetes.io/selected-node"


class K8sPVLedger(StandalonePVBinder):
    """The --master mode VolumeBinder, fed by the pv/pvc/storageclass
    watches (the reference's volumebinder informers,
    cache.go:189-209,258-269,311-320), mirroring the JAX package's.

    Differences from the standalone ledger:
    - claim identity is NAMESPACED ("ns/name"); a pod's claim names resolve
      in the pod's own namespace
    - PVC objects are first-class: spec.volumeName is the durable binding,
      an unknown claim fails placement (the pod references a PVC the
      cluster doesn't have — FindPodVolumes errors the same way)
    - StorageClasses gate unbound claims: a provisioner-backed class is
      dynamically provisionable (feasible on every node — the volume is
      created after scheduling), while kubernetes.io/no-provisioner
      classes must match a free static PV from the ledger, storage class
      and node reachability included
    - bind_volumes makes the binding durable CLUSTER-SIDE too: static
      claims pre-bind their PV by claimRef PATCH (what the k8s volume
      binder's BindPodVolumes does), dynamic claims get the
      WaitForFirstConsumer selected-node annotation so the PV controller
      provisions on the chosen node; every write rides the shared kube-api
      token bucket and failed writes queue for retry on later binds
    """

    # failed cluster writes kept for retry — bounded so an apiserver outage
    # can't grow the queue (and replay staleness) without limit
    MAX_PENDING_WRITES = 256
    # seconds between timer-driven retry flushes while writes are queued —
    # an IDLE scheduler (no further binds) must still drain the queue
    RETRY_FLUSH_INTERVAL = 5.0

    def __init__(self, transport=None, bucket=None):
        super().__init__()
        self.claims: Dict[str, PersistentVolumeClaim] = {}
        self.storage_classes: Dict[str, str] = {}  # name → provisioner
        self.transport = transport
        self.bucket = bucket  # shared egress TokenBucket (cmd/server.py)
        self._selected_node: Dict[str, str] = {}  # task uid → chosen host
        self._pending_writes: list = []  # failed PATCHes awaiting retry
        self._writer = None  # lazy single-thread pool for cluster writes
        self._retry_timer = None  # armed while _pending_writes is non-empty

    # -- ingest (pvc / storageclass informer analogs) --------------------
    def add_pvc(self, pvc: PersistentVolumeClaim) -> None:
        with self._lock:
            key = pvc.key()
            self.claims[key] = pvc
            if pvc.volume_name:
                self.bound[key] = pvc.volume_name
            # an unbound PVC event does NOT clear a local binding: our
            # claimRef patch / the PV controller round-trip lags the watch,
            # and dropping the entry here would free the PV for a second
            # claim while the first pod's binding is still in flight

    def delete_pvc(self, key: str) -> None:
        with self._lock:
            self.claims.pop(key, None)
            self.bound.pop(key, None)

    def add_storage_class(self, name: str, provisioner: str) -> None:
        with self._lock:
            self.storage_classes[name] = provisioner

    def delete_storage_class(self, name: str) -> None:
        with self._lock:
            self.storage_classes.pop(name, None)

    # -- resolution -------------------------------------------------------
    def _dynamic(self, pvc: PersistentVolumeClaim) -> bool:
        prov = self.storage_classes.get(pvc.storage_class)
        return bool(prov) and prov != NO_PROVISIONER

    def _resolve_k8s(self, key: str, hostname: str, taken: "_Taken") -> Optional[str]:
        """Pick a PV for claim ``key`` reachable from hostname, or the empty
        string for a dynamically-provisionable claim (nothing to reserve),
        or None when the placement must fail.  The PVs already taken
        (``_held(taken)``) are read only when a free PV must be found."""
        pvc = self.claims.get(key)
        if pvc is None:
            return None  # unknown claim — the cluster can't satisfy it
        # a binding we already made locally wins even before the PVC watch
        # round-trips spec.volumeName back (the claimRef PATCH is in
        # flight): without this, the claim's own PV sits in the held set
        # and the claim reads as unsatisfiable everywhere
        bound_pv = self.bound.get(key) or pvc.volume_name
        if bound_pv:
            pv = self.pvs.get(bound_pv)
            if pv is not None and self._reachable(pv, hostname):
                return pv.name
            return None
        if self._dynamic(pvc):
            return ""  # provisioned after scheduling; feasible anywhere
        held = self._held(taken)
        for pv in self._candidates():
            if pv.claim is not None and pv.claim != key:
                continue
            if pv.storage_class != pvc.storage_class:
                continue
            if not self._reachable(pv, hostname):
                continue
            if pv.name in held:
                continue
            return pv.name
        return None

    def _claim_keys(self, task) -> list:
        ns = task.pod.namespace
        return [f"{ns}/{c}" for c in task.pod.volume_claims]

    # -- VolumeBinder seam ------------------------------------------------
    def volume_feasible(self, task, hostname: str) -> bool:
        keys = self._claim_keys(task)
        if not keys:
            return True
        with self._lock:
            picked: list = []
            taken = _Taken(task.uid, picked)
            for key in keys:
                pv = self._resolve_k8s(key, hostname, taken)
                if pv is None:
                    return False
                if pv:
                    picked.append(pv)
            return True

    def allocate_volumes(self, task, hostname: str) -> None:
        from kube_batch_tpu_torch.framework.session import FitFailure

        keys = self._claim_keys(task)
        with self._lock:
            self.reservations.pop(task.uid, None)
            self._selected_node.pop(task.uid, None)
            if not keys:
                return
            picked: Dict[str, str] = {}
            taken = _Taken(task.uid, picked.values())
            for key in keys:
                pv = self._resolve_k8s(key, hostname, taken)
                if pv is None:
                    raise FitFailure(
                        f"volume claim {key!r} has no PV reachable from {hostname}")
                # dynamic claims reserve the empty string: nothing to hold,
                # but bind time still needs the claim key for the hand-off
                picked[key] = pv
            self._selected_node[task.uid] = hostname
            self.reservations[task.uid] = picked

    def release_task(self, task_uid: str) -> None:
        with self._lock:
            self.reservations.pop(task_uid, None)
            self._selected_node.pop(task_uid, None)

    def bind_volumes(self, task) -> None:
        """Durable binding, ledger AND cluster: a static claim pre-binds its
        PV by claimRef PATCH (BindPodVolumes' UpdatePV), a dynamic claim
        gets the selected-node annotation so the PV controller provisions on
        the chosen node (BindVolumes, cache.go:258-269).  Failed writes
        queue and retry on later binds."""
        writes = []
        with self._lock:
            picked = self.reservations.pop(task.uid, None) or {}
            hostname = self._selected_node.pop(task.uid, None)
            for key, pv in picked.items():
                ns, name = key.split("/", 1)
                if pv:
                    self.bound[key] = pv
                    writes.append((
                        f"/api/v1/persistentvolumes/{pv}",
                        {"spec": {"claimRef": {
                            "apiVersion": "v1",
                            "kind": "PersistentVolumeClaim",
                            "namespace": ns, "name": name,
                        }}},
                    ))
                elif hostname:
                    writes.append((
                        f"/api/v1/namespaces/{ns}/persistentvolumeclaims/{name}",
                        {"metadata": {"annotations": {
                            SELECTED_NODE_ANNOTATION: hostname}}},
                    ))
        if (writes or self._pending_writes) and self.transport is not None:
            # the writes run OFF-CYCLE on a single worker (the cache's pod
            # binds are likewise async, cache.go:478-484): a slow apiserver
            # must not stall the scheduling cycle's bind loop.  Earlier
            # failures retry first (ordering preserved by the 1-thread
            # pool), and a bind with NO new writes still flushes the retry
            # queue — a stranded claimRef PATCH must not wait for another
            # volume-carrying bind that may never come.
            self._submit_writes(writes)

    def drain_writes(self) -> None:
        """Block until every submitted cluster write ran (tests, shutdown)."""
        with self._lock:
            writer = self._writer
        # result() outside the lock: the queued _run_writes needs it
        if writer is not None:
            writer.submit(lambda: None).result()

    def close(self) -> None:
        """Retire the pv-writes worker with a bounded drain and cancel the
        retry timer (``SchedulerCache.stop()`` calls this).  Queued retries
        are NOT replayed first: shutdown must not block on an unreachable
        apiserver; they stay in _pending_writes and a later bind on a
        revived ledger re-submits them."""
        with self._lock:
            timer, self._retry_timer = self._retry_timer, None
            writer, self._writer = self._writer, None
        if timer is not None:
            timer.cancel()
        if writer is not None:
            writer.shutdown(wait=True)
            # a write that failed during the drain armed a fresh timer
            with self._lock:
                timer, self._retry_timer = self._retry_timer, None
            if timer is not None:
                timer.cancel()

    # -- throttled, retried, OFF-CYCLE cluster writes ---------------------
    def _submit_writes(self, writes) -> None:
        from kube_batch_tpu_torch.utils.blocking import allow_blocking

        # create + submit under the lock: the retry timer races the bind
        # dispatch thread here, two lazily-built executors would break the
        # single-writer ordering (and drain_writes' fence), and submits must
        # enqueue in lock order for the earlier-failures-retry-first contract
        with self._lock:
            if self._writer is None:
                from concurrent.futures import ThreadPoolExecutor

                self._writer = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="pv-writes")
            with allow_blocking(
                "only the FIRST submit blocks (one-time pv-writes worker "
                "spawn, bounded); the lock is the submit-ordering fence"
            ):
                self._writer.submit(self._run_writes, writes)

    def _run_writes(self, writes) -> None:
        with self._lock:
            pending, self._pending_writes = self._pending_writes, []
        for path, body in pending + list(writes):
            if self.bucket is not None:
                self.bucket.take()
            try:
                self.transport.request(
                    "PATCH", path, body,
                    content_type="application/merge-patch+json", timeout=10,
                )
            except Exception as e:  # noqa: BLE001 — queue for a later flush
                logger.warning("volume write %s failed (%s); queued for retry",
                               path, e)
                with self._lock:
                    self._pending_writes.append((path, body))
                    overflow = len(self._pending_writes) - self.MAX_PENDING_WRITES
                    if overflow > 0:
                        dropped = self._pending_writes[:overflow]
                        del self._pending_writes[:overflow]
                        self._forget_dropped_writes(dropped)
                        logger.warning(
                            "volume write retry queue full; dropped %d oldest "
                            "and released their ledger bindings so later "
                            "cycles re-derive them", overflow,
                        )
        with self._lock:
            timer = self._arm_retry_timer_locked() if self._pending_writes else None
        if timer is not None:
            # start OUTSIDE the lock: Thread.start blocks on the spawned
            # thread's startup handshake; the timer can't fire before
            # start, so arming under the lock and starting after it is
            # race-free
            timer.start()

    def _forget_dropped_writes(self, dropped) -> None:
        """A dropped claimRef PATCH must also drop its `bound` entry, or the
        cluster-side bind is lost for good: the unbound-PVC watch event
        deliberately doesn't clear `bound` (the in-flight-PATCH race above),
        so nothing else would ever re-derive the write.  Selected-node
        annotation drops need no ledger undo — the claim re-annotates on
        the task's next allocate/bind.  Caller holds the lock."""
        for path, body in dropped:
            ref = ((body.get("spec") or {}).get("claimRef") or {})
            if not ref.get("name"):
                continue
            key = f"{ref.get('namespace', 'default')}/{ref['name']}"
            pv = path.rsplit("/", 1)[-1]
            if self.bound.get(key) == pv:
                del self.bound[key]

    def _arm_retry_timer_locked(self):
        """Create + register a timer-driven flush so queued retries drain
        even when no further bind_volumes call arrives.  One timer at a
        time; it disarms itself and re-arms from _run_writes while work
        remains.  Returns the timer for the CALLER to start after releasing
        the lock (or None when one is already armed)."""
        if self._retry_timer is not None:
            return None
        t = threading.Timer(self.RETRY_FLUSH_INTERVAL, self._timer_flush)
        t.daemon = True
        self._retry_timer = t
        return t

    def _timer_flush(self) -> None:
        with self._lock:
            self._retry_timer = None
            if not self._pending_writes or self.transport is None:
                return
        self._submit_writes([])
