"""The port's multi-process sharded solve (``parallel/distributed.py``):
two processes join one gloo group on the CPU, each owning two positions of
a four-shard 1-D mesh, and solve the 4 096 × 1 024 synthetic snapshot
(``testing/dryrun.rehearse``).  Every rank's result must equal the
single-process solve of the same snapshot, field by field, and that
equals the JAX package's solve of it.  Slow: it starts two processes."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from kube_batch_tpu_torch.api.convert import snapshot_to_numpy
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


@pytest.mark.slow
def test_two_gloo_processes_solve_as_one_and_as_jax():
    from kube_batch_tpu.api.snapshot import DeviceSnapshot as JaxSnapshot
    from kube_batch_tpu.ops.assignment import AllocateConfig as JaxConfig
    from kube_batch_tpu.ops.assignment import allocate_solve as jax_solve
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig, allocate_solve
    from kube_batch_tpu_torch.testing import dryrun
    from kube_batch_tpu_torch.testing.synthetic import synthetic_device_snapshot

    report = dryrun.rehearse(2, "cpu", 2)
    assert [r["backend"] for r in report["ranks"]] == ["gloo", "gloo"]
    assert report["placed"] > 0
    snap, _ = synthetic_device_snapshot(dryrun.DIST_TASKS, dryrun.DIST_NODES, gang_size=4,
                                        n_queues=3, seed=0, device="cpu")
    one = allocate_solve(snap, AllocateConfig())
    host = snapshot_to_numpy(snap)
    want = jax.device_get(jax_solve(JaxSnapshot(**host._asdict()), JaxConfig()))
    for name in want._fields:
        np.testing.assert_array_equal(getattr(one, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
