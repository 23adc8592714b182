"""The server drive's what-if latency, two trees of the repo against each
other on one card.

    python -m kube_batch_tpu_torch.testing.server_ab PARENT_DIR CHANGE_DIR

runs ``server_drive.drive_server`` (``chip_smoke.py``'s ``server`` phase:
50 000 tasks × 5 000 nodes, 5 000 arrivals, on the card) from each tree in
a subprocess of its own, in the order parent, change, change, parent, so a
drift of the card over the call falls on both sides alike.  Each run prints
one JSON line: the tree, the drive's wall, the leader's what-ifs over HTTP
and through ``QueryPlane.submit`` in process (p50, p99 ms; one in four asks
for evictions) and its HTTP follower's (p50, p99 ms).  The card's name and
power limit follow, as ``nvidia-smi`` reads them.  Exit 1 when a run
fails.  ``--tasks/--nodes/--arrivals`` and ``--device cpu`` rehearse it at
a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: the child: one drive from the tree it runs in, its what-if numbers out
_CHILD = """
import json, sys
from kube_batch_tpu_torch.testing.server_drive import drive_server
tasks, nodes, arrivals, device = json.loads(sys.argv[1])
r = drive_server(tasks, nodes, arrivals, device=device)
w, f = r["whatif"], r["follower"]
print(json.dumps(dict(
    whatif_requests=w["requests"],
    whatif_http_ms_p50=w["http_ms_p50"], whatif_http_ms_p99=w["http_ms_p99"],
    whatif_plane_ms_p50=w["plane_ms_p50"], whatif_plane_ms_p99=w["plane_ms_p99"],
    follower_http_ms_p50=f["http_ms_p50"], follower_http_ms_p99=f["http_ms_p99"])))
"""

#: the order of the runs: a drift over the call falls on both trees alike
ORDER = ("parent", "change", "change", "parent")


def run_tree(tree: str, tasks: int, nodes: int, arrivals: int, device) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _CHILD,
                          json.dumps([tasks, nodes, arrivals, device])],
                         cwd=tree, env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"server_ab: the drive in {tree} exited {out.returncode}")
    return dict(json.loads(out.stdout.strip().splitlines()[-1]), wall_s=wall)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="server_ab")
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--tasks", type=int, default=50_000)
    ap.add_argument("--nodes", type=int, default=5_000)
    ap.add_argument("--arrivals", type=int, default=5_000)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    a = ap.parse_args(argv)
    trees = {"parent": a.parent, "change": a.change}
    for which in ORDER:
        r = run_tree(trees[which], a.tasks, a.nodes, a.arrivals, a.device)
        print(json.dumps(dict(tree=which, **r)), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
