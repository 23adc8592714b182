"""The port's simulator against the JAX package's on the warm carry's
preset, on the CPU (``test_torch_sim_parity.py`` states what is compared
and the differences left out): ``--warm-ab`` on ``warm-churn`` prints the
same JSON through both CLIs (the carried candidate table and the cold
build bind identically, and the carry engages), and the ``warm-churn``
report equals the JAX package's.
"""

from __future__ import annotations

import json

from test_torch_sim_parity import assert_same_run, environ, fresh_jax_caches  # noqa: F401
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


def test_warm_ab_prints_what_the_jax_cli_prints(tmp_path, capsys):
    from kube_batch_tpu.sim.__main__ import main as jax_main
    from kube_batch_tpu_torch.sim.__main__ import main

    argv = ["--preset", "warm-churn", "--seed", "0", "--warm-ab"]
    with environ(KB_SHARD="0", KB_GUARD_DIR=str(tmp_path / "jax")):
        assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    with environ(KB_GUARD_DIR=str(tmp_path / "port")):
        assert main(argv, device="cpu") == 0
    got = json.loads(capsys.readouterr().out)
    assert got["binds_match"] is True and got["warm_engaged"] is True
    assert got == want


def test_warm_churn_matches_jax(tmp_path):
    jrep, prep = assert_same_run(tmp_path, "warm-churn", 0)
    assert prep["warm"]["warm_cycles"] > prep["warm"]["cold_builds"]
    assert prep["topk"]["compacted_cycles"] > 0
