"""The port's simulator against the JAX package's on the ``bind-storm``
chaos preset (hundreds of gang pods while the binder flaps), on the CPU;
``test_torch_sim_parity.py`` states what is compared and the differences
left out, and ``test_torch_sim_parity_guard.py`` holds the ``corruption``
preset.
"""

from __future__ import annotations

from test_torch_sim_parity import assert_same_run, fresh_jax_caches  # noqa: F401
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


def test_bind_storm_matches_jax(tmp_path):
    jrep, prep = assert_same_run(tmp_path, "bind-storm", 0)
    assert prep["bind_integrity"]["duplicate_binds"] == 0
    assert prep["jobs"]["completed"] == prep["jobs"]["submitted"] == 120
