"""The standalone server's drives (``kube_batch_tpu_torch/testing/server_drive.py``),
which ``chip_smoke.py`` runs on the card at 50k × 5k and 4 096 × 1 024, here
on the CPU at 2 048 × 256.

``drive_server``'s cycle 1 over HTTP must bind as the headline drive
(``cycle_drive.drive``) binds in process; ``drive_server_process`` must
keep every placement across a state-file restart, answer a what-if from a
``--follower`` process, and see every subprocess exit by its SIGINT.
``Proc.stop_clean`` must refuse any other exit."""

from __future__ import annotations

import subprocess
import sys
import time

import pytest

from kube_batch_tpu_torch.testing import server_drive
from kube_batch_tpu_torch.testing.cycle_drive import drive
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

TASKS, NODES, ARRIVALS = 2048, 256, 200


def test_drive_server_binds_as_the_cycle_drive():
    r = server_drive.drive_server(TASKS, NODES, ARRIVALS, device="cpu")
    want = drive(TASKS, NODES, ARRIVALS, device="cpu", keep_states=True)
    assert r["device"] == "cpu"
    assert r["bindings_digest"] == server_drive.bindings_digest(want["states"][0]["binds"])
    assert r["arrivals_bound"] > 0
    assert r["whatif"]["requests"] == server_drive.WHATIF_N
    assert r["follower"]["applied_seq"] == r["follower"]["head_seq"]
    assert r["follower"]["pull_errors"] == 0 and r["follower"]["gaps"] == 0
    assert r["failover"]["mode"] == "warm" and r["consistency"]["errors"] == []
    assert len(r["save_state_ms"]) == r["cycles"]


def test_drive_server_process_restarts_and_stops_cleanly():
    r = server_drive.drive_server_process(TASKS, NODES, device="cpu")
    assert r["restart"] == {"bound": TASKS, "statuses": ["BOUND"]}
    assert r["follower"]["answer_equal"]
    assert r["exits"] == {"leader": -2, "follower": -2, "restarted": -2}


def _proc(tmp_path, code: str) -> server_drive.Proc:
    """A ``Proc`` around ``python -c code`` instead of a server."""
    p = server_drive.Proc.__new__(server_drive.Proc)
    p.name, p.killed = "probe", False
    p.log_path = str(tmp_path / "probe.log")
    p.log = open(p.log_path, "wb")
    p.proc = subprocess.Popen([sys.executable, "-u", "-c", code],
                              stdout=p.log, stderr=subprocess.STDOUT)
    return p


def _wait_for_line(p: server_drive.Proc, text: str) -> None:
    deadline = time.monotonic() + 60
    while text not in p.tail():
        assert p.proc.poll() is None, p.tail()
        assert time.monotonic() < deadline, f"no {text!r} from the probe"
        time.sleep(0.05)


def test_stop_clean_accepts_an_exit_by_sigint(tmp_path):
    p = _proc(tmp_path, "import time; print('up'); time.sleep(60)")
    try:
        _wait_for_line(p, "up")
        assert p.stop_clean() == -2 and not p.killed
    finally:
        p.stop()


@pytest.mark.parametrize("code, exit_text", [
    ("raise SystemExit(1)", "exit 1"),
    # a crash while shutting down replaces the KeyboardInterrupt
    ("import time\nprint('up')\ntry:\n    time.sleep(60)\nfinally:\n    raise RuntimeError('close')",
     "exit 1"),
])
def test_stop_clean_refuses_any_other_exit(tmp_path, code, exit_text):
    p = _proc(tmp_path, code)
    try:
        if "up" in code:
            _wait_for_line(p, "up")
        else:
            p.proc.wait(60)
        with pytest.raises(AssertionError, match=exit_text):
            p.stop_clean()
    finally:
        p.stop()
