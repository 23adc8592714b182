"""The port's simulator against the JAX package's on the ``corruption``
chaos preset, on the CPU (``test_torch_sim_parity.py`` states what is
compared and the differences left out): three resident device words are
corrupted — the port writes them into its resident tensors in place — and
the trips, demotion, re-promotion, alerts and bundles must be the JAX
package's.  Then ``--replay-bundle`` of the port's first bundle reproduces
the trip through the port's CLI on the CPU, and its report equals the JAX
CLI's replay of the JAX package's bundle.
"""

from __future__ import annotations

import json

from test_torch_sim_parity import assert_same_run, environ, fresh_jax_caches  # noqa: F401
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


def test_corruption_matches_jax_and_its_bundle_replays(tmp_path, capsys):
    from kube_batch_tpu.sim.__main__ import main as jax_main
    from kube_batch_tpu_torch.sim.__main__ import main

    jrep, prep = assert_same_run(tmp_path, "corruption", 0)
    g = prep["guard"]
    assert g["chaos_ok"] is True and g["corruptions_injected"] == 3
    assert [t["detail"] for t in g["trip_log"]] == [
        t["detail"] for t in jrep["guard"]["trip_log"]]
    capsys.readouterr()
    with environ(KB_SHARD="0"):
        assert jax_main(["--replay-bundle", jrep["guard"]["bundles"][0]]) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(["--replay-bundle", g["bundles"][0]], device="cpu") == 0
    got = json.loads(capsys.readouterr().out)
    assert got["reproduced"] is True and got["device"] == "cpu"
    assert got["original_report"]["verdict"] >= 1
    for rep in (want, got):
        rep.pop("bundle")
        rep.pop("device", None)
    # the port's replay also counts the oracle's placements (ROADMAP Queue 3)
    assert "oracle_placed" not in want and got.pop("oracle_placed") > 0
    assert got == want
