"""Cache state persistence — the standalone durable-state story, mirroring
``kube_batch_tpu/cache/persistence.py`` in the same JSON format (a state
file written by either package loads into the other).

The reference keeps ALL durable state in the API server/etcd and rebuilds its
cache by re-list + re-watch on restart (cache.go:342-384, SURVEY.md §5.4);
the `Inqueue` phase persisted on PodGroup.Status survives restarts
(enqueue.go:115). Standalone there is no etcd, so the cache itself snapshots
to a JSON state file: save after each cycle (atomic tmp+rename), load at
startup. Shadow PodGroups are skipped — add_pod regenerates them."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

from kube_batch_tpu_torch.api import serialize
from kube_batch_tpu_torch.api.pod import PersistentVolume, PodDisruptionBudget, PriorityClass


def save_state(cache, path: str) -> None:
    # Snapshot object references under the lock (shallow list/dict copies —
    # O(objects), no serialization); build the dicts and write the file
    # outside it, so a per-cycle save at 50k pods doesn't block the ingest /
    # bind / evict handlers for the full serialization time. Pod/Node/Queue
    # objects are immutable-by-convention after ingest (handlers replace,
    # not mutate) EXCEPT pod.node_name, which the async binder ack mutates —
    # drain in-flight dispatches first so the state file can't miss a
    # just-acked binding (restoring such a pod as Pending).
    flush = getattr(cache, "flush_binds", None)
    if flush is not None:
        flush()
    with cache._lock:
        pods = list(cache.pods.values())
        nodes = [n.node for n in cache.nodes.values() if n.node is not None]
        pod_groups = [
            j.pod_group
            for j in cache.jobs.values()
            if j.pod_group is not None and not j.pod_group.shadow
        ]
        pdbs = [j.pdb for j in cache.jobs.values() if j.pdb is not None]
        queues = [q.queue for q in cache.queues.values()]
        priority_classes = list(cache.priority_classes.values())
        pod_conditions = dict(cache.pod_conditions)
        pvs = list(getattr(cache.volume_binder, "pvs", {}).values())
        pv_bound = dict(getattr(cache.volume_binder, "bound", {}))
    state = {
        "pods": [serialize.pod_to_dict(p) for p in pods],
        "nodes": [serialize.node_to_dict(n) for n in nodes],
        "pod_groups": [serialize.pod_group_to_dict(pg) for pg in pod_groups],
        "queues": [serialize.queue_to_dict(q) for q in queues],
        "priority_classes": [
            {"name": pc.name, "value": pc.value, "global_default": pc.global_default}
            for pc in priority_classes
        ],
        "pod_conditions": pod_conditions,
        "pdbs": [dataclasses.asdict(p) for p in pdbs],
        "pvs": [dataclasses.asdict(p) for p in pvs],
        "pv_bound": pv_bound,
    }
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    with os.fdopen(fd, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def load_state(cache, path: str) -> bool:
    """Replay a saved state file through the cache's ingest handlers (the
    re-list analog). Returns False when no state file exists."""
    try:
        with open(path) as f:
            state = json.load(f)
    except FileNotFoundError:
        return False
    for q in state.get("queues", []):
        cache.add_queue(serialize.queue_from_dict(q))
    for pc in state.get("priority_classes", []):
        cache.add_priority_class(PriorityClass(**pc))
    for n in state.get("nodes", []):
        cache.add_node(serialize.node_from_dict(n))
    for pg in state.get("pod_groups", []):
        cache.add_pod_group(serialize.pod_group_from_dict(pg))
    for pdb in state.get("pdbs", []):
        cache.add_pdb(PodDisruptionBudget(**pdb))
    for p in state.get("pods", []):
        cache.add_pod(serialize.pod_from_dict(p))
    cache.pod_conditions.update(state.get("pod_conditions", {}))
    # capability = "carries a durable pv binding ledger", probed on the
    # ledger itself — NOT on add_pv presence: the fake binder implements
    # the full ingest surface as explicit no-ops (cache/interface.py), so
    # a method probe would pass and then write into ledgers it lacks
    binder = cache.volume_binder
    if getattr(binder, "bound", None) is not None:
        for pv in state.get("pvs", []):
            binder.add_pv(PersistentVolume(**pv))
        binder.bound.update(state.get("pv_bound", {}))
    return True
