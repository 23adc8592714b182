"""The what-if smoke for kube_batch_tpu_torch, the port's copy of the JAX
package's ``scripts/whatif_smoke.py``: the query plane end to end over
real HTTP.

Starts an AdminServer + QueryPlane on a loopback port against a small
synthetic cluster, runs one scheduling cycle (which publishes the snapshot
lease), then drives a batch of mixed feasible/infeasible gangs through the
`kb-ctl whatif` CLI and asserts the verdicts and the Prometheus counters —
including the amortization invariant (device dispatches < requests served),
counted over the smoke's own requests.

Exit 0 = clean, 1 = a violated invariant.  A few seconds:

    python -m kube_batch_tpu_torch.testing.whatif_smoke [--device cpu]

``--device`` defaults to CUDA (the card), as every port entry point does.
"""

from __future__ import annotations

import argparse
import re
import sys
import urllib.request


def _fail(msg: str) -> None:
    print(f"whatif smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _metrics(server: str) -> str:
    with urllib.request.urlopen(f"{server}/metrics", timeout=30) as r:
        return r.read().decode()


def _counters(server: str):
    """(feasible requests, infeasible requests, device dispatches) as
    ``/metrics`` counts them."""
    text = _metrics(server)

    def counter(pat: str) -> float:
        m = re.search(pat + r"\S*\s+([0-9.e+]+)", text)
        return float(m.group(1)) if m else 0.0

    return (counter(r'volcano_whatif_requests_total{verdict="feasible"}'),
            counter(r'volcano_whatif_requests_total{verdict="infeasible"}'),
            counter(r"volcano_whatif_device_dispatches_total"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="whatif_smoke")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    device = ap.parse_args(argv).device

    import kube_batch_tpu_torch.actions  # noqa: F401 — registers actions
    import kube_batch_tpu_torch.plugins  # noqa: F401 — registers plugins
    from kube_batch_tpu_torch.cli import whatif as cli
    from kube_batch_tpu_torch.cmd.server import AdminServer
    from kube_batch_tpu_torch.framework.conf import load_scheduler_conf
    from kube_batch_tpu_torch.framework.interface import get_action
    from kube_batch_tpu_torch.framework.session import close_session, open_session
    from kube_batch_tpu_torch.serve.plane import QueryPlane
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    cache = synthetic_cluster(n_tasks=40, n_nodes=8, gang_size=4, n_queues=2)
    conf = load_scheduler_conf(None)
    qp = QueryPlane(cache, max_batch=8, window_s=0.002, dispatch_timeout=60,
                    start_thread=True)
    srv = AdminServer(cache, port=0, query_plane=qp)
    srv.start()
    try:
        ssn = open_session(cache, conf.tiers, device)
        try:
            for name in conf.actions:
                get_action(name).execute(ssn)
        finally:
            close_session(ssn)
        cache.flush_binds()
        server = f"http://127.0.0.1:{srv.port}"
        # the counters are the process's: judge this smoke's own requests
        # (an earlier plane in the same process has counted its own)
        before = _counters(server)

        # mixed verdicts via the CLI, concurrent probes riding few dispatches
        rc = cli.main(["--server", server, "--queue", "q0", "--count", "2",
                       "--cpu", "1000", "--repeat", "8",
                       "--expect", "feasible"])
        if rc != 0:
            _fail(f"feasible probe exited {rc}")
        rc = cli.main(["--server", server, "--queue", "q0", "--count", "2",
                       "--cpu", "900000", "--repeat", "4",
                       "--expect", "infeasible"])
        if rc != 0:
            _fail(f"infeasible probe exited {rc}")

        after, text = _counters(server), _metrics(server)
        feas, infeas, dispatches = (after[i] - before[i] for i in range(3))
        if feas < 8:
            _fail(f"feasible counter {feas} < 8")
        if infeas < 4:
            _fail(f"infeasible counter {infeas} < 4")
        if not 0 < dispatches < feas + infeas:
            _fail(f"no amortization: {dispatches} dispatches for "
                  f"{feas + infeas} requests")
        if "volcano_whatif_batch_size" not in text:
            _fail("batch-size histogram missing from /metrics")
        print(f"whatif smoke clean: {int(feas)} feasible + {int(infeas)} "
              f"infeasible over {int(dispatches)} dispatches")
    finally:
        srv.stop()
        qp.close()


if __name__ == "__main__":
    main()
