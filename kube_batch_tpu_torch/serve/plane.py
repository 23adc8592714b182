"""QueryPlane — request encoding, probe dispatch, decode, publication.

Mirrors ``kube_batch_tpu/serve/plane.py``.  One instance rides a
``SchedulerCache`` (``cache.query_plane``).  The scheduling cycle
publishes a :class:`serve.lease.SnapshotLease` after its resident swap
(``actions/allocate.py`` ``republish_query_lease``, on the solve path and
the idle path, and after reclaim's, preempt's and backfill's swaps);
callers :meth:`QueryPlane.submit` requests; the micro-batcher flushes them
as one :func:`ops.probe.probe_solve` call against the lease's resident
tensors.  The flush runs on the batcher's thread: the probe is the one
device work the port launches off the cycle's thread (``ops/probe.py``).

Probe answers are oracle-exact on a frozen cache; the lease's
``snapshot_version`` tells clients which cache state answered them, and
every verdict carries a ``staleness`` block (the lease's seq and version
against the publisher's head; on a leader, ``head_fn`` unset, the lag is
0 by construction).  With a replication publisher attached
(``cache.replication``, ``replicate/publisher.py``) each publish first
puts the lease's state on the stream and stamps the lease with the
record's seq; a follower's plane (``replicate/follower.py``) sets
``head_fn`` to its applier's head.

Where the port differs from the JAX package:

- a lease published by a sharded cycle holds the session's mesh and its
  ``ShardedSnapshot``, and its probes run sharded
  (``parallel/mesh.sharded_probe_solve``: K1 per shard at the probe's
  rows), as the JAX package's;
- the batch is not padded to ``max_batch`` gangs: nothing is compiled per
  shape, so a flush probes exactly its requests (the gang axis keeps the
  JAX package's G bucket, so each gang's rows are the same);
- ``prewarm=True`` loads the kernel library (its nvcc build at first use
  in a process) in a background thread at the first publish on a CUDA
  device: that load is the port's only cold cost, where the JAX package
  compiles a zeros twin of each new lease shape;
- the plane keeps its own counters too (``dispatches``,
  ``requests_served``, ``batcher.rejected``).

The ``volcano_whatif_*`` series (``metrics/``) are fed as the JAX package
feeds them: requests by verdict, dispatches, batch size and queue depth
per flush, enqueue → verdict latency, sweeps, and the published lease's
version.

A failed dispatch fails its own sub-batch only, and is never retried on
the CPU.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.serve.batcher import MicroBatcher, env_float
from kube_batch_tpu_torch.serve.lease import LeaseBroker, SnapshotLease
from kube_batch_tpu_torch.utils import telemetry

logger = logging.getLogger("kube_batch_tpu_torch")

#: hard cap on a speculative gang's size (the G bucket's ceiling)
MAX_GANG = 64

#: the probe batch's integer columns are i32: out-of-range values fail
#: their own request at parse time, never the flush
_I32_MAX = 2**31 - 1

#: the sweep's geometric count grid, probed first to bracket the
#: feasibility boundary before the binary search
_SWEEP_GRID = (1, 2, 4, 8, 16, 32, 64)


class WhatifError(Exception):
    """A request-level failure with an HTTP status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def _parse_request(body: dict, spec) -> dict:
    """Validate and normalize one what-if body: queue, count,
    requests{cpu, memory, ...}, and optional min_available, priority,
    node_selector, tolerations, min_resources and evictions."""
    if not isinstance(body, dict):
        raise WhatifError(400, "body must be a JSON object")
    queue = body.get("queue", "default")
    try:
        count = int(body.get("count", 1))
    except (TypeError, ValueError):
        raise WhatifError(400, "count must be an integer")
    if count < 1:
        raise WhatifError(400, "count must be >= 1")
    if count > MAX_GANG:
        raise WhatifError(400, f"count {count} exceeds the gang cap {MAX_GANG}")
    requests = body.get("requests") or {}
    if not isinstance(requests, dict):
        raise WhatifError(400, "requests must be a resource map")
    try:
        min_avail = int(body.get("min_available", count))
    except (TypeError, ValueError):
        raise WhatifError(400, "min_available must be an integer")
    # no upper clamp to count: min_available > count is a gang that can
    # never be ready, and the commit gate must see the real value
    min_avail = max(1, min_avail)
    if min_avail > _I32_MAX:
        raise WhatifError(400, "min_available out of range")
    selector = body.get("node_selector") or {}
    if not isinstance(selector, dict):
        raise WhatifError(400, "node_selector must be a label map")
    raw_tol = body.get("tolerations") or []
    if not isinstance(raw_tol, list):
        raise WhatifError(400, "tolerations must be a list")
    from kube_batch_tpu_torch.api.pod import Toleration

    try:
        tolerations = [Toleration(**d) for d in raw_tol]
    except TypeError:
        raise WhatifError(400, "malformed toleration")
    min_resources = body.get("min_resources")
    if min_resources is not None:
        if not isinstance(min_resources, dict):
            raise WhatifError(400, "min_resources must be a resource map")
        try:
            min_resources = {str(k): float(v) for k, v in min_resources.items()}
        except (TypeError, ValueError):
            raise WhatifError(400, "min_resources values must be numeric")
    try:
        priority = int(body.get("priority", 0) or 0)
    except (TypeError, ValueError):
        raise WhatifError(400, "priority must be an integer")
    if not -_I32_MAX - 1 <= priority <= _I32_MAX:
        raise WhatifError(400, "priority out of range")
    # the member's resource vector: the conversion an ingested pod's
    # TaskInfo applies (pods dimension included)
    from kube_batch_tpu_torch.api.task_info import _requests_to_resource

    try:
        res = _requests_to_resource({k: float(v) for k, v in requests.items()}, spec)
        req_vec = res.vec.astype(np.float32)
        # a best-effort member is the backfill path's; the verdict says so
        best_effort = bool(res.is_empty())
    except (TypeError, ValueError):
        raise WhatifError(400, "requests values must be numeric")
    return {
        "queue": str(queue),
        "count": count,
        "min_avail": min_avail,
        "priority": priority,
        "selector": {str(k): str(v) for k, v in selector.items()},
        "tolerations": tolerations,
        "min_resources": min_resources,
        "req_vec": req_vec,
        "best_effort": best_effort,
        "evictions": bool(body.get("evictions", False)),
        "_t0": telemetry.perf_counter(),
    }


def warm_kernels(device: torch.device) -> None:
    """The probe's cold cost on ``device``: the kernel library's build and
    load on CUDA (nothing on the CPU, whose plain versions need none)."""
    if device.type == "cuda":
        from kube_batch_tpu_torch.ops._build import load_library

        load_library()


class QueryPlane:
    def __init__(self, cache, max_batch: Optional[int] = None,
                 window_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 dispatch_timeout: Optional[float] = None,
                 start_thread: bool = True, prewarm: bool = False):
        cols = getattr(cache, "columns", None)
        if cols is None:
            raise ValueError("QueryPlane requires a columnar SchedulerCache")
        self.cache = cache
        self.broker = LeaseBroker()
        # KB_WHATIF_TIMEOUT_S bounds the wait for a lease inside a flush
        self.dispatch_timeout = (
            dispatch_timeout if dispatch_timeout is not None
            else env_float("KB_WHATIF_TIMEOUT_S", 2.0)
        )
        self.max_gang = MAX_GANG
        self._prewarm = prewarm
        self._warm_lock = threading.Lock()
        self._warmed: set = set()
        self._warm_threads: List[threading.Thread] = []
        self._gate_gap_warned = False
        # probes and the cycle's swaps exclude each other through the
        # broker; the bound method is kept once, so close() can detach it
        # by identity
        self._swap_guard = self.broker.swap_guard
        cols.resident_swap_guard = self._swap_guard
        cache.query_plane = self
        # the replication head for the staleness block: None (the lease is
        # the head) or a () -> (head_seq, head_version) callable
        self.head_fn = None
        self.batcher = MicroBatcher(
            self._flush, max_batch=max_batch, window_s=window_s,
            max_queue=max_queue, start_thread=start_thread,
        )
        self.dispatches = 0
        self.requests_served = 0

    def close(self) -> None:
        self.batcher.stop()
        for t in self._warm_threads:
            t.join(timeout=5.0)
        self._warm_threads = []
        cols = getattr(self.cache, "columns", None)
        if cols is not None and cols.resident_swap_guard is self._swap_guard:
            cols.resident_swap_guard = None
        if getattr(self.cache, "query_plane", None) is self:
            self.cache.query_plane = None

    # ------------------------------------------------------------------
    # publication (from the cycle: actions/allocate.py)
    # ------------------------------------------------------------------
    def needs_publish(self, version: int) -> bool:
        """False when the live lease already carries ``version``: an idle
        cycle with no ingest since the last publish skips the snapshot
        build and the swap."""
        lease = self.broker.current()
        return lease is None or lease.version < version

    def publish_session(self, ssn, snap, meta) -> None:
        """Publish this cycle's lease: the resident snapshot the solve
        consumed (memoized: the swap already ran for the dispatch), the
        session's solve configurations, the dirty-tracker version token,
        and the row allocator's peek for the tie hash."""
        cols = ssn.columns
        if cols is None:
            return  # an isolated session: nothing resident to lease
        from kube_batch_tpu_torch.actions.allocate import session_allocate_config, solve_target
        from kube_batch_tpu_torch.actions.reclaim import victim_gates
        from kube_batch_tpu_torch.api.columns import resident_snap
        from kube_batch_tpu_torch.ops.eviction import EvictConfig

        # the cycle's own placement: its mesh when its solves sharded
        target = solve_target(ssn, snap.node_alloc.shape[0])
        mesh = None if target is ssn.device else target
        dev = resident_snap(cols, snap, target)
        config = session_allocate_config(ssn)
        gates = victim_gates(ssn, "preempt")
        if not self._gate_gap_warned and gates & {"drf", "proportion"}:
            # a conf whose first voting preempt tier holds drf or
            # proportion victim gates is outside the eviction probe's model
            self._gate_gap_warned = True
            logger.warning(
                "whatif eviction probe does not model the conf's %s victim "
                "gate(s): evictions answers may diverge from the committed "
                "preempt solve under this conf",
                sorted(gates & {"drf", "proportion"}),
            )
        evict_config = EvictConfig(
            mode="preempt",
            gang=ssn.plugin_enabled("gang"),
            drf=ssn.plugin_enabled("drf"),
            proportion=ssn.plugin_enabled("proportion"),
            victim_gang="gang" in gates,
            victim_conformance="conformance" in gates,
            # the drf and proportion victim gates are not modeled (each
            # response names them in `unmodeled`)
            victim_drf=False,
            victim_proportion=False,
            weights=ssn.score_weights,
        )
        queue_rows = {name: i for i, name in enumerate(meta.queue_names) if name}
        lease = SnapshotLease(
            snap=dev,
            meta=meta,
            version=int(getattr(ssn.cache, "last_open_version", 0)),
            config=config,
            evict_config=evict_config,
            mesh=mesh,
            probe_rows=tuple(cols.peek_task_rows(self.max_gang)),
            queue_rows=queue_rows,
            unmodeled_gates=tuple(sorted(gates & {"drf", "proportion"})),
        )
        pub = getattr(self.cache, "replication", None)
        if pub is not None:
            # the record goes onto the replication stream before the broker
            # install, so the lease carries its seq and a leader's verdicts
            # report the staleness coordinates a caught-up follower's do;
            # the swap's own delta record rides along as the diff's fast path
            try:
                hint, hint_version = cols.export_delta_record(target)
                seq = pub.publish_cycle(snap, meta, lease, delta_hint=hint,
                                        cache_version=hint_version)
                lease = lease._replace(seq=seq)
            except Exception:  # noqa: BLE001 — replication must never stall the cycle
                logger.exception("replication publish failed; followers will resync")
        self.broker.publish(lease)
        metrics.set_whatif_snapshot_version(lease.version)
        if self._prewarm:
            self._maybe_prewarm(lease)

    def _maybe_prewarm(self, lease: SnapshotLease) -> None:
        """Load the kernel library in a background thread the first time a
        lease is published on a device, so the first window does not pay
        the build behind its timeout.  It touches no lease tensor, so it
        never holds a swap back."""
        device = lease.snap.task_req.device
        with self._warm_lock:
            if device in self._warmed:
                return
            self._warmed.add(device)

        def warm():
            try:
                warm_kernels(device)
            except Exception:  # noqa: BLE001 — warm-up only; the first probe retries the load
                logger.exception("whatif probe pre-warm failed")

        t = threading.Thread(target=warm, daemon=True, name="whatif-prewarm")
        self._warm_threads = [w for w in self._warm_threads if w.is_alive()]
        self._warm_threads.append(t)
        t.start()

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def submit(self, body: dict) -> Future:
        """Validate and enqueue one request; the future resolves to the
        response dict (WhatifError for request-level failures)."""
        req = _parse_request(body, self.cache.spec)  # raises WhatifError(400)
        return self.batcher.submit(req)

    def submit_sweep(self, body: dict) -> Future:
        """Validate and enqueue one sweep request: the largest replica count
        of this gang that fits, by binary search against one lease.  The
        body is a what-if body plus ``max_count`` (default the gang cap);
        ``count`` and ``min_available`` are ignored (each probed point c is
        a gang of c members, all required)."""
        req = _parse_request(body, self.cache.spec)
        if req["evictions"]:
            raise WhatifError(400, "sweep does not support evictions")
        try:
            max_count = int(body.get("max_count", MAX_GANG))
        except (TypeError, ValueError):
            raise WhatifError(400, "max_count must be an integer")
        if not 1 <= max_count <= MAX_GANG:
            raise WhatifError(400, f"max_count must be in [1, {MAX_GANG}]")
        req["max_count"] = max_count
        req["_sweep"] = True
        return self.batcher.submit(req)

    # ------------------------------------------------------------------
    # the flush: one probe call for every queued request of a kind
    # ------------------------------------------------------------------
    def _flush(self, batch) -> None:
        # a caller that gave up cancelled its future: no device time for it
        batch = [(r, f) for r, f in batch if not f.cancelled()]
        if not batch:
            return
        metrics.observe_whatif_batch(len(batch), self.batcher.depth())
        # a mixed window splits by the evictions flag, so one evictions
        # request does not make the plain probes pay the eviction pass;
        # sweeps run their own search; all against the same lease
        sweeps = [(r, f) for r, f in batch if r.get("_sweep")]
        plain = [(r, f) for r, f in batch if not r.get("_sweep")]
        subs = [
            [(r, f) for r, f in plain if not r["evictions"]],
            [(r, f) for r, f in plain if r["evictions"]],
        ]
        done = []
        done_sweeps = []
        with self.broker.dispatch(timeout=self.dispatch_timeout) as lease:
            if lease is None:
                err = WhatifError(503, "no snapshot lease published yet (scheduler warming)")
                for _req, fut in batch:
                    if self._deliver(fut, error=err):
                        metrics.register_whatif_request("error")
                return
            for sub in subs:
                if not sub:
                    continue
                try:
                    done.append((sub, self._probe(lease, [req for req, _ in sub])))
                except Exception as e:  # noqa: BLE001 — fail this sub-batch, keep serving
                    logger.exception("whatif probe dispatch failed")
                    for _req, fut in sub:
                        if self._deliver(fut, error=WhatifError(500, f"probe failed: {e}")):
                            metrics.register_whatif_request("error")
            for req, fut in sweeps:
                try:
                    done_sweeps.append((req, fut, self._sweep(lease, req)))
                except Exception as e:  # noqa: BLE001 — fail this sweep, keep serving
                    logger.exception("whatif sweep failed")
                    if self._deliver(fut, error=WhatifError(500, f"sweep failed: {e}")):
                        metrics.register_whatif_request("error")
        for req, fut, resp in done_sweeps:
            if not self._deliver(fut, result=resp):
                continue
            metrics.register_whatif_sweep()
            metrics.observe_whatif_latency((telemetry.perf_counter() - req["_t0"]) * 1e3)
            self.requests_served += 1
        for sub, results in done:
            for (req, fut), resp in zip(sub, results):
                if not self._deliver(fut, result=resp):
                    continue  # the caller gave up mid-dispatch
                metrics.register_whatif_request(
                    "feasible" if resp["feasible"] else "infeasible")
                metrics.observe_whatif_latency((telemetry.perf_counter() - req["_t0"]) * 1e3)
                self.requests_served += 1

    def _sweep(self, lease: SnapshotLease, req: dict) -> dict:
        """The largest count whose gang fits, against one lease: a
        geometric grid brackets the boundary, then a binary search refines
        it (feasibility is monotone in the count on a frozen snapshot)."""
        max_count = req["max_count"]
        feasible: Dict[int, bool] = {}
        probes = 0

        def probe(counts: List[int]) -> None:
            nonlocal probes
            for i in range(0, len(counts), self.batcher.max_batch):
                chunk = counts[i:i + self.batcher.max_batch]
                reqs = [dict(req, count=c, min_avail=c) for c in chunk]
                for c, r in zip(chunk, self._probe(lease, reqs)):
                    feasible[c] = bool(r["feasible"])
                probes += len(chunk)

        grid = sorted({c for c in _SWEEP_GRID if c < max_count} | {max_count})
        probe(grid)
        if not feasible[grid[0]]:
            lo = 0
        elif feasible[max_count]:
            lo = max_count
        else:
            lo = max(c for c in grid if feasible[c])
            hi = min(c for c in grid if not feasible[c])
            while hi - lo > 1:
                mid = (lo + hi) // 2
                probe([mid])
                if feasible[mid]:
                    lo = mid
                else:
                    hi = mid
        return {
            "snapshot_version": lease.version,
            "max_fit": lo,
            "feasible": lo >= 1,
            "max_count": max_count,
            "probes": probes,
            "staleness": self._staleness(lease),
        }

    @staticmethod
    def _deliver(fut: Future, result=None, error=None) -> bool:
        """Resolve a request's future, tolerating a concurrent cancel;
        returns whether the answer was delivered."""
        try:
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(result)
            return True
        except Exception:  # noqa: BLE001 — cancelled between the check and the set
            return False

    # ---- encoding ----------------------------------------------------
    def _encode(self, lease: SnapshotLease, reqs: List[dict]):
        """(ProbeBatch of numpy arrays, probe rows [G] i32) for ``reqs``:
        one gang per request, G the JAX package's gang bucket."""
        from kube_batch_tpu_torch.api.snapshot import _pack_bits, _TaintView, bucket
        from kube_batch_tpu_torch.ops.probe import ProbeBatch

        snap, meta = lease.snap, lease.meta
        R = int(snap.task_req.shape[1])
        W = int(snap.task_sel_bits.shape[1])
        Wt = int(snap.task_tol_bits.shape[1])
        B = len(reqs)
        G = min(self.max_gang, bucket(max(r["count"] for r in reqs), floor=8))
        spec = self.cache.spec

        req_arr = np.zeros((B, G, R), np.float32)
        valid = np.zeros((B, G), bool)
        min_avail = np.ones(B, np.int32)
        queue = np.full(B, -1, np.int32)
        prio = np.zeros(B, np.int32)
        sel_bits = np.zeros((B, W), np.uint32)
        sel_imp = np.zeros(B, bool)
        tol_bits = np.zeros((B, Wt), np.uint32)
        min_res = np.zeros((B, R), np.float32)
        has_min_res = np.zeros(B, bool)
        taint_list = list(meta.taint_bit.items())
        for b, r in enumerate(reqs):
            n = r["count"]
            req_arr[b, :n] = r["req_vec"]
            valid[b, :n] = True
            min_avail[b] = r["min_avail"]
            queue[b] = lease.queue_rows.get(r["queue"], -1)
            prio[b] = r["priority"]
            # selector pairs → required label bits (build_snapshot's
            # encoding: a pair no node carries makes the selector impossible)
            bits: List[int] = []
            for k, v in r["selector"].items():
                bit = meta.label_pair_bit.get((k, v))
                if bit is None:
                    sel_imp[b] = True
                else:
                    bits.append(bit)
            if bits:
                sel_bits[b] = _pack_bits(bits, W)
            if r["tolerations"] and taint_list:
                tb = [bit for (tk, tv, te), bit in taint_list
                      if any(t.tolerates(_TaintView(tk, tv, te)) for t in r["tolerations"])]
                if tb:
                    tol_bits[b] = _pack_bits(tb, Wt)
            mr = r["min_resources"]
            if mr is not None:
                has_min_res[b] = True
                for name, v in mr.items():
                    if name in spec:
                        min_res[b, spec.index(name)] = v
        pbatch = ProbeBatch(
            req=req_arr, valid=valid, min_avail=min_avail, queue=queue,
            prio=prio, sel_bits=sel_bits, sel_impossible=sel_imp,
            tol_bits=tol_bits, min_res=min_res, has_min_res=has_min_res,
        )
        rows = np.asarray(lease.probe_rows[:G], np.int32)
        return pbatch, rows

    # ---- dispatch and decode -----------------------------------------
    def _probe(self, lease: SnapshotLease, reqs: List[dict]) -> List[dict]:
        from kube_batch_tpu_torch.api.convert import read_back
        from kube_batch_tpu_torch.ops.probe import probe_batch_from_numpy, probe_solve

        pbatch, rows = self._encode(lease, reqs)
        with_evictions = any(r["evictions"] for r in reqs)
        dev = lease.snap.task_req.device
        args = (probe_batch_from_numpy(pbatch, dev), torch.from_numpy(rows).to(dev))
        if lease.mesh is not None:
            from kube_batch_tpu_torch.parallel.mesh import sharded_probe_solve

            res = sharded_probe_solve(lease.snap, *args, lease.mesh, lease.config,
                                      lease.evict_config, with_evictions)
        else:
            res = probe_solve(lease.snap, *args, lease.config, lease.evict_config,
                              with_evictions)
        self.dispatches += 1
        metrics.register_whatif_dispatch()
        fields = ["assigned", "pipelined", "committed", "feasible", "reasons",
                  "enqueue_ok"]
        if with_evictions:
            # victims is [B, T]: read only when a request asked for it
            fields += ["claim_node", "victims", "evict_covered"]
        # kbt: allow[KBT010] THE sanctioned serving choke point: one
        # blocking copy per sub-batch, inside the dispatch region
        host = dict(zip(fields, read_back(getattr(res, f) for f in fields)))
        return [self._decode(lease, r, host, b) for b, r in enumerate(reqs)]

    def _staleness(self, lease: SnapshotLease) -> dict:
        """The staleness block every verdict carries: this lease's
        replication coordinates against the stream's head (the lease itself
        on a leader, lag 0)."""
        head_seq, head_version = (
            self.head_fn() if self.head_fn is not None else (lease.seq, lease.version)
        )
        return {
            "seq": lease.seq,
            "version": lease.version,
            "head_seq": head_seq,
            "head_version": head_version,
            "lag_cycles": max(0, head_seq - lease.seq),
        }

    def _decode(self, lease: SnapshotLease, req: dict, host: dict, b: int) -> dict:
        from kube_batch_tpu_torch.ops.feasibility import REASON_MESSAGES

        meta = lease.meta
        n = req["count"]
        assigned = host["assigned"][b][:n]
        pipelined = host["pipelined"][b][:n]
        node_names = meta.node_names
        nodes = [node_names[i] if 0 <= i < len(node_names) else None
                 for i in assigned.tolist()]
        unplaced = int(np.sum(assigned < 0))
        # every gap between this probe's model and the committed pipeline
        # that applies to this request is named in the response
        unmodeled = []
        if req["evictions"]:
            unmodeled += [
                f"preempt victim gate '{g}' (conf tier) is not modeled by "
                "the eviction probe — victim sets may diverge from the "
                "committed preempt solve"
                for g in lease.unmodeled_gates
            ]
        if req.get("best_effort"):
            unmodeled.append(
                "all members are BestEffort (sub-quanta requests): the "
                "committed pipeline binds them via backfill, which this "
                "probe does not model — 'infeasible' here is expected"
            )
        out = {
            "snapshot_version": lease.version,
            "feasible": bool(host["feasible"][b]),
            "committed": bool(host["committed"][b]),
            "enqueue_admitted": bool(host["enqueue_ok"][b]),
            "nodes": nodes,
            "pipelined": [bool(p) for p in pipelined.tolist()],
            "unplaced": unplaced,
            "unmodeled": unmodeled,
            "staleness": self._staleness(lease),
        }
        if unplaced:
            # the unplaced members' fit-error histogram: the rows the
            # committed cycle would record as FitErrors
            hist = host["reasons"][b][:n][assigned < 0].sum(axis=0)
            out["fit_errors"] = {msg: int(c) for msg, c in zip(REASON_MESSAGES, hist.tolist())
                                 if c}
        if req["evictions"]:
            claim = host["claim_node"][b][:n]
            victims = np.flatnonzero(host["victims"][b])
            task_keys = meta.task_keys
            out["evictions"] = {
                "claim_nodes": [node_names[i] if 0 <= i < len(node_names) else None
                                for i in claim.tolist()],
                "victims": sorted(task_keys[t] for t in victims.tolist()
                                  if t < len(task_keys) and task_keys[t]),
                "covered": bool(host["evict_covered"][b]),
            }
        return out
