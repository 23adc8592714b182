"""serve/ — the read-side query plane over the resident snapshot.

Mirrors ``kube_batch_tpu/serve``.  The write path (actions/, the
scheduling cycle) commits decisions; this package serves speculative
ones: "would this gang fit, where, and what would it evict?", without a
Statement.

- :mod:`serve.lease` — ``SnapshotLease`` / ``LeaseBroker``: a consistent
  read handle over the resident snapshot tensors, carrying the dirty
  tracker's version token;
- :mod:`serve.batcher` — ``MicroBatcher``: collects concurrent requests
  into one probe call per window (bounded queue, deadline flush,
  per-request futures);
- :mod:`serve.plane` — ``QueryPlane``: request parsing and encoding
  against the lease's meta, the :func:`ops.probe.probe_solve` call, and
  the decode.
"""

from kube_batch_tpu_torch.serve.lease import LeaseBroker, SnapshotLease  # noqa: F401
from kube_batch_tpu_torch.serve.plane import QueryPlane, WhatifError  # noqa: F401
