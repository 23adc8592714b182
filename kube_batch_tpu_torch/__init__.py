"""kube_batch_tpu_torch — the scheduler in PyTorch with CUDA kernels.

A port of ``kube_batch_tpu`` to PyTorch on an NVIDIA H100.  The serial
scheduling cycle runs end to end: pods, nodes, PodGroups and queues enter
the cache through its handlers; ``Scheduler.run_once`` opens an exclusive
session with the configured plugins, runs the allocate action (the
snapshot built from the cache's column store, uploaded once; the
gang-constrained solve on the device; one readback; the host replay into
binds), and closes the session with the PodGroup and queue statuses.  The
layout mirrors the JAX package path for path, so each module's
counterpart is found at the same name:

  api/        — resources, the ingest objects, task / job / node / queue
                info, the column store, the snapshot tensors,
                numpy ↔ tensor conversion
  cache/      — the cluster mirror and its binder / status seams
  framework/  — conf, session, statement, the action and plugin registries
  plugins/    — priority, gang, conformance, drf, predicates, proportion,
                nodeorder, binpack
  ops/        — feasibility, scoring, fairness, ordering, the assignment
                solve, and the two hand-written kernels (``ops/kernels.py``
                over ``csrc/*.cu``)
  actions/    — allocate (single device, cold)
  scheduler.py — the serial loop
  testing/    — synthetic clusters and snapshots, the kernel bench, the
                cycle drive

The package imports torch, numpy and the standard library only.  Entry
points take ``device=`` (default CUDA; asking for CUDA without a card
raises — see :mod:`kube_batch_tpu_torch.device`); a CUDA tensor goes
through the kernels, a CPU tensor through their plain PyTorch versions.
"""

__version__ = "0.1.0"
