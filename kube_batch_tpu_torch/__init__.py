"""kube_batch_tpu_torch — the scheduler in PyTorch with CUDA kernels.

A port of ``kube_batch_tpu`` to PyTorch on an NVIDIA H100.  The JAX
package's single-device scheduling loop runs end to end: pods, nodes,
PodGroups, PodDisruptionBudgets and queues enter the cache through its
handlers (staged while a pipelined cycle runs); ``Scheduler.run_once``
opens an exclusive session with the configured plugins (or
``open_session(..., isolated=True)`` a deep-cloned one), runs the
configured actions — the shipped conf's enqueue (the admission gate on
the device), reclaim and preempt (the eviction solve on the device, the
claims replayed through the plugins), allocate (the snapshot built from
the cache's column store, or from the clones, its device-resident
tensors swapped in; the gang-constrained solve on the device, warm-started
and guarded; one readback; the host replay into binds, volume
reservations through the PV ledger) and backfill — and closes the session
with the PodGroup and queue statuses; ``Scheduler.run_forever`` is the
event-driven pipelined loop.  Beside the cycle, a query plane
(``serve.QueryPlane``) answers what-if requests ("would this gang fit,
where, and what would it evict?") against the lease each cycle publishes,
and a replication publisher streams each lease's state to followers that
answer the same from their own resident copy.  ``python -m
kube_batch_tpu_torch.cmd.main`` runs it all as the standalone server:
the JAX package's HTTP admin, ingest, what-if and replication surface,
file-lock leader election with a warm standby, a state file, and
``--follower`` read replicas; with ``--master`` it lists and watches a
Kubernetes apiserver, binds and evicts through it, writes status back and
holds a coordination.k8s.io Lease.  ``python -m kube_batch_tpu_torch.sim``
replays a workload over virtual time through the real scheduler, with
fault and corruption injection.  The layout mirrors the JAX package path
for path, so each module's counterpart is found at the same name:

  api/        — resources, the ingest objects and their JSON form, task /
                job / node / queue info, the column store, the snapshot tensors and the
                object snapshot, the resident device cache, numpy ↔
                tensor conversion
  cache/      — the cluster mirror, the dirty tracker, the resync queue,
                the standalone and k8s PV ledgers, the state file and the
                binder / evictor / status / volume seams
  framework/  — conf, session, statement, the action and plugin registries
  plugins/    — priority, gang, conformance, drf, predicates, proportion,
                nodeorder, binpack
  ops/        — feasibility, scoring (with custom rows), fairness,
                ordering, the assignment and eviction solves, the
                admission gate, the invariant sentinels, the what-if
                probe, and the three
                hand-written kernels (``ops/kernels.py``,
                ``ops/admission.py`` over ``csrc/*.cu``)
  actions/    — enqueue, reclaim, allocate, backfill, preempt
  guard/      — the guard plane and its bundles
  metrics/    — the volcano_* Prometheus-style series and their text
  obs/        — the cycle tracer, the flight recorder, the guard alerts
  serve/      — the query plane: the snapshot lease, the micro-batcher,
                the what-if plane
  replicate/  — the replication stream: the KBR1 codec, the leader's
                publisher, the follower that serves what-ifs from it
  k8s/        — Kubernetes JSON translation, the list+watch adapter, the
                apiserver binder / evictor / status writer, the classified
                retry transport and circuit breaker
  cmd/        — the process entry, its options, leader election (file
                lock and Lease) and the HTTP server (standalone, --master
                and follower)
  cli/        — the ``queue`` and ``whatif`` clients
  sim/        — the virtual-time simulator: workloads, the simulated
                kubelet, fault and corruption injection, the presets, the
                longitudinal report
  utils/      — invariant assertions, the priority queue, switches, the
                one-thread worker, the telemetry clock
  scheduler.py — the serial and pipelined loops
  version.py  — the version string
  testing/    — synthetic clusters and snapshots, the kernel bench, the
                cycle, server, k8s and simulator drives, the e2e driver
                with its stub apiserver, the what-if and replication smokes

The package imports torch, numpy and the standard library only.  Entry
points take ``device=`` (default CUDA; asking for CUDA without a card
raises — see :mod:`kube_batch_tpu_torch.device`); a CUDA tensor goes
through the kernels, a CPU tensor through their plain PyTorch versions.
"""

__version__ = "0.1.0"
