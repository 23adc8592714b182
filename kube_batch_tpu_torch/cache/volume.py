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

Not ported: the k8s-backed ledger (``K8sPVLedger``), which needs the k8s
transport.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from kube_batch_tpu_torch.api.pod import (
    HOSTNAME_TOPOLOGY,
    PersistentVolume,
    node_selector_terms_match,
)


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

    def _resolve(self, claim: str, hostname: str, held_of) -> Optional[str]:
        """A PV for ``claim`` reachable from ``hostname``: a durable binding
        wins, then a pre-bound PV, then any free wildcard PV.  ``held_of()``
        returns the PVs already taken; it is called only when a free PV must
        be found."""
        bound_pv = self.bound.get(claim)
        if bound_pv is not None:
            pv = self.pvs.get(bound_pv)
            if pv is not None and self._reachable(pv, hostname):
                return bound_pv
            return None
        held = held_of()
        for pv in self._candidates():
            if pv.claim is not None and pv.claim != claim:
                continue
            if not self._reachable(pv, hostname):
                continue
            if pv.name in held:
                continue
            return pv.name
        return None

    def _held_of(self, task_uid: str, picked):
        """``_resolve``'s taken-PV thunk: everything bound or reserved by
        another task, plus this task's picks so far; the ledger scan runs
        once per call to the outer probe."""
        base = []

        def held() -> set:
            if not base:
                base.append(self._reserved_pvs(excluding_task=task_uid))
            return base[0] | set(picked)
        return held

    def volume_feasible(self, task, hostname: str) -> bool:
        """A probe without side effects: could ``allocate_volumes`` succeed
        now?  The sequential placement path uses it as a host predicate."""
        claims = task.pod.volume_claims
        if not claims:
            return True
        with self._lock:
            picked: list = []
            held_of = self._held_of(task.uid, picked)
            for claim in claims:
                pv = self._resolve(claim, hostname, held_of)
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
            held_of = self._held_of(task.uid, picked.values())
            for claim in claims:
                pv = self._resolve(claim, hostname, held_of)
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
