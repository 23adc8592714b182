"""Fault injection for the simulator: node crash/re-add, binder failure
windows, watch-stream flaps, and eviction-termination delay.

Faults are ordinary `SimEvent`s on the heap; the runner hands the fault
kinds here. Each handler mutates the cluster through the same ingest
surface a real failure would use (delete_node / update_pod / binder
errors), so the scheduler sees faults exactly as it would in production —
then schedules the deterministic fallout (pod losses, node return).

Mirrors ``kube_batch_tpu/sim/faults.py``.  The one difference is where a
corruption lands: the port's resident tensors live in dicts keyed by the
scheduler's ``torch.device`` and are written in place.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from kube_batch_tpu_torch.api.pod import Node
from kube_batch_tpu_torch.api.types import PodPhase, TaskStatus
from kube_batch_tpu_torch.sim import events as ev

# resolve-at-apply-time crash target: the node carrying the most resident
# sim pods when the fault fires (ties break by name) — guarantees the crash
# actually displaces work regardless of where the solver placed it
BUSIEST = "@busiest"


def node_crash_script(t: float, node: str = BUSIEST, down_for: float = 10.0,
                      pod_fail_after: float = 1.0) -> List[ev.SimEvent]:
    """Crash `node` at t; its residents are lost pod_fail_after later (the
    node-lifecycle controller's pod GC analog); the node returns at
    t + down_for (re-add is scheduled at apply time, once the target
    resolves)."""
    return [ev.SimEvent(t, ev.NODE_CRASH, {
        "node": node, "down_for": down_for,
        "pod_fail_after": pod_fail_after,
    })]


def bind_fail_script(t: float, count: int) -> List[ev.SimEvent]:
    return [ev.SimEvent(t, ev.BIND_FAIL, {"count": count})]


def watch_flap_script(t: float) -> List[ev.SimEvent]:
    return [ev.SimEvent(t, ev.WATCH_FLAP, {})]


def brownout_script(t: float, duration: float = 8.0) -> List[ev.SimEvent]:
    """Apiserver brownout: every egress call (bind/evict) fails from t to
    t + duration — the circuit breaker opens, the degraded cycle parks
    decisions in the resync queue, and the loop must keep ticking."""
    return [ev.SimEvent(t, ev.BROWNOUT, {"duration": duration})]


def leader_failover_script(t: float) -> List[ev.SimEvent]:
    """Leadership loss mid-run: the warm standby takes over — the cache
    rebuilds from the pod store and revalidates (keeps) the resident
    device cache (cache.failover_recover)."""
    return [ev.SimEvent(t, ev.LEADER_FAILOVER, {})]


def corruption_script(t: float, kind: str) -> List[ev.SimEvent]:
    """Flip a word in a resident DEVICE column at t — the HBM-bit-flip /
    silent-divergence model the guard plane exists to catch.  The host
    columns (the truth) stay intact; only the device copy the solves
    consume is corrupted, and the mirror is left agreeing with the host so
    the scatter-delta diff does NOT silently heal it.  Kinds:

    - ``ledger``: zero a live node's ``node_alloc`` capacity word in the
      static feature cache (node features only re-upload on a node-change
      version bump, so the flip persists) — the sentinel's capacity
      cross-check (idle+used ≤ allocatable) condemns the next solve;
    - ``score``: NaN a live node's ``node_releasing`` ledger word (a
      fit/score input) — the sentinel's all-finite sweep condemns the
      next solve;
    - ``pending``: flip a long-lived RUNNING row's ``task_pending`` on —
      the device would re-bid an already-placed task (a duplicate bind if
      dispatched); the host eligibility-checksum cross-check condemns the
      solve even when a fairness gate blocks the phantom bid."""
    return [ev.SimEvent(t, ev.CORRUPT, {"kind": kind})]


class FaultInjector:
    """Applies fault events against a running simulation. The runner owns
    the clock/heap/trace; this class owns what a fault *means*."""

    def __init__(self, runner):
        self.runner = runner
        self.crashed_nodes = {}   # name -> Node object to re-add
        self.displaced_jobs = set()  # job uids that lost pods to crashes
        self.corruptions_applied = 0  # resident-corrupt faults that landed

    def apply(self, event: ev.SimEvent) -> None:
        handler = {
            ev.NODE_CRASH: self._node_crash,
            ev.NODE_READD: self._node_readd,
            ev.BIND_FAIL: self._bind_fail,
            ev.WATCH_FLAP: self._watch_flap,
            ev.BROWNOUT: self._brownout,
            ev.BROWNOUT_END: self._brownout_end,
            ev.LEADER_FAILOVER: self._leader_failover,
            ev.CORRUPT: self._corrupt,
        }[event.kind]
        handler(event)

    # ---- handlers --------------------------------------------------------
    def _resolve_node(self, name: str) -> str:
        if name != BUSIEST:
            return name
        counts = {}
        for pod in self.runner.cache.pods.values():
            if pod.node_name:
                counts[pod.node_name] = counts.get(pod.node_name, 0) + 1
        if not counts:  # nothing placed yet — crash the first node
            return next(iter(self.runner.cache.nodes), "")
        return max(counts, key=lambda n: (counts[n], n))

    def _node_crash(self, event: ev.SimEvent) -> None:
        runner = self.runner
        name = self._resolve_node(event.data["node"])
        node_info = runner.cache.nodes.get(name)
        if node_info is None or node_info.node is None:
            return
        # keep the Node spec for the re-add; record resolved target in trace
        self.crashed_nodes[name] = dataclasses.replace(node_info.node)
        residents = sorted(
            pod.key() for pod in runner.cache.pods.values()
            if pod.node_name == name and pod.phase in (PodPhase.PENDING,
                                                       PodPhase.RUNNING)
        )
        runner.trace.record(ev.SimEvent(event.time, ev.NODE_CRASH, {
            "node": name, "residents": residents,
        }))
        runner.cache.delete_node(name)
        t = event.time
        for key in residents:
            job = runner.job_of_pod(key)
            if job is not None:
                self.displaced_jobs.add(job)
            runner.heap.push(ev.SimEvent(
                t + event.data.get("pod_fail_after", 1.0), ev.POD_FAILED,
                {"key": key, "node": name},
            ))
        runner.heap.push(ev.SimEvent(
            t + event.data.get("down_for", 10.0), ev.NODE_READD, {"node": name}
        ))

    def _node_readd(self, event: ev.SimEvent) -> None:
        name = event.data["node"]
        node = self.crashed_nodes.pop(name, None)
        if node is None:
            return
        self.runner.trace.record(event)
        self.runner.cache.add_node(Node(
            name=node.name, allocatable=dict(node.allocatable),
            capacity=dict(node.capacity), labels=dict(node.labels),
            taints=list(node.taints),
        ))

    def _bind_fail(self, event: ev.SimEvent) -> None:
        self.runner.trace.record(event)
        self.runner.kubelet.fail_next_binds(event.data["count"])

    def _brownout(self, event: ev.SimEvent) -> None:
        runner = self.runner
        duration = float(event.data.get("duration", 8.0))
        runner.trace.record(ev.SimEvent(event.time, ev.BROWNOUT,
                                        {"duration": duration}))
        runner.kubelet.set_brownout(True)
        runner.heap.push(ev.SimEvent(event.time + duration,
                                     ev.BROWNOUT_END, {}))

    def _brownout_end(self, event: ev.SimEvent) -> None:
        self.runner.trace.record(event)
        self.runner.kubelet.set_brownout(False)

    def _leader_failover(self, event: ev.SimEvent) -> None:
        """Leadership loss: the warm standby takes over through the real
        recovery path (SchedulerCache.failover_recover — pod-store rebuild
        + resident-cache revalidation), exactly what cmd/server.py's
        run_warm_standby does on LostLeadership."""
        runner = self.runner
        report = runner.failover()
        runner.trace.record(ev.SimEvent(event.time, ev.LEADER_FAILOVER, {
            "mode": report["mode"],
        }))

    def _corrupt(self, event: ev.SimEvent) -> None:
        """Flip a word in a resident DEVICE column (corruption_script) —
        the host columns stay intact, the mirror keeps agreeing with the
        host, so only the device copy the solves consume diverges, exactly
        like an HBM bit-flip.  The word is written into the resident
        tensor in place (the port's swaps update those tensors in place
        too).  A cold resident cache (nothing uploaded yet) retries one
        virtual second later."""
        runner = self.runner
        kind = event.data["kind"]
        cols = runner.cache.columns
        device = runner.scheduler.device

        def retry():
            runner.heap.push(ev.SimEvent(
                event.time + 1.0, ev.CORRUPT, dict(event.data)))

        live = np.flatnonzero(np.asarray(cols.n_valid))
        # per-cycle corruptions must diverge device-from-MIRROR the way an
        # HBM flip does: the next swap's diff compares mirror vs host, so
        # the mirror row is pinned to the CURRENT host truth — the diff
        # stays silent and the corrupt device word survives into the solve
        # (a stale mirror row would make the swap scatter-heal it first)
        if kind == "pending":
            # flip a RUNNING row's device pending bit on; detection is the
            # action's HOST pending cross-check when the (full-matrix)
            # solve re-assigns the row
            rc = cols._per_cycle_dev.get(device)
            dev = rc._dev.get("task_pending") if rc is not None else None
            if dev is None:
                return retry()
            rows = np.flatnonzero(
                np.asarray(cols.t_status) == int(TaskStatus.RUNNING)
            )
            if rows.size == 0:
                return retry()
            # the flip must OUTLIVE the next few dispatches: a task that
            # completes first frees its row (or drops out of the session),
            # dissolving the corruption into legitimate/inert state before
            # a solve can be condemned by it.  The heap KNOWS every
            # running pod's scheduled completion — pick the row whose
            # POD_SUCCEEDED is furthest out, and require ≥ 5 vt of life
            succeed_at = {
                e.item.data.get("key"): e.item.time
                for e in runner.heap._pq._heap
                if e.item.kind == ev.POD_SUCCEEDED
            }
            best, best_t = -1, event.time + 5.0
            for row in rows.tolist():
                task = cols.task_by_row[row]
                if task is None:
                    continue
                # a KNOWN future completion only: a pod missing from the
                # heap has its success event in THIS instant's due batch —
                # it is about to be deleted, the worst possible target
                t_done = succeed_at.get(task.pod.key())
                if t_done is not None and t_done > best_t:
                    best, best_t = row, t_done
            if best < 0:
                return retry()
            dev[best] = True
            rc._mirror["task_pending"][best] = False  # host truth: not pending
            field = "task_pending"
        elif kind == "score":
            # NaN a live node's releasing word — a fit/score input; the
            # sentinel's all-finite sweep condemns the next solve.  (Task-
            # axis feature columns re-upload on every arrival's version
            # bump, which would silently heal the corruption before a
            # solve ever saw it — node ledgers only scatter at moved rows)
            rc = cols._per_cycle_dev.get(device)
            dev = rc._dev.get("node_releasing") if rc is not None else None
            if dev is None or live.size == 0:
                return retry()
            r = int(live[0])
            dev[r, 0] = float("nan")
            rc._mirror["node_releasing"][r] = np.asarray(cols.n_rel32)[r]
            field = "node_releasing"
        else:
            # static feature column (version-keyed cache): node features
            # only re-upload on a node-change version bump, so a zeroed
            # capacity word persists until the guard's trip-heal drops the
            # cache.  The row must be a LIVE node (the row allocator may
            # start live rows past 0 when the axis was pre-reserved)
            field = "node_alloc"
            entry = cols._dev_cache.get(device, {}).get(field)
            if entry is None or live.size == 0:
                return retry()
            _version, dev = entry
            dev[int(live[0])] = 0.0
        self.corruptions_applied += 1
        runner.trace.record(ev.SimEvent(event.time, ev.CORRUPT, {
            "kind": kind, "field": field,
        }))

    def _watch_flap(self, event: ev.SimEvent) -> None:
        """Watch reconnect: the stream replays the whole store as MODIFIED
        (StubApiServer's list→watch gap closure) — every pod re-ingests
        through update_pod's upsert path."""
        runner = self.runner
        pods = list(runner.cache.pods.values())
        runner.trace.record(ev.SimEvent(event.time, ev.WATCH_FLAP,
                                        {"replayed": len(pods)}))
        for pod in pods:
            runner.cache.update_pod(dataclasses.replace(pod))
