"""`kb-ctl whatif` — the query-plane client (POST /v1/whatif), mirroring
``kube_batch_tpu/cli/whatif.py``: the same flags, output and exit codes.

Asks the scheduler's serve/ plane "would this gang fit, where, and what
would it evict?" without submitting anything:

    python -m kube_batch_tpu_torch.cli.whatif --server http://127.0.0.1:8080 \
        --queue gold --count 4 --cpu 2000 --mem 2147483648

    # capacity sweep: 32 concurrent identical probes ride one (or few)
    # device dispatches server-side
    python -m kube_batch_tpu_torch.cli.whatif --count 4 --cpu 2000 --repeat 32

`--json` supplies the raw request body instead of flags; `--expect`
(feasible|infeasible) turns the verdict into the exit code for CI smokes.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor


def _post(server: str, body: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        f"{server}/v1/whatif",
        data=json.dumps(body).encode(),
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _body_from_args(args) -> dict:
    if args.json:
        return json.loads(args.json)
    body = {
        "queue": args.queue,
        "count": args.count,
        "requests": {"cpu": args.cpu, "memory": args.mem},
        "priority": args.priority,
        "evictions": args.evictions,
    }
    if args.min_available is not None:
        body["min_available"] = args.min_available
    if args.selector:
        body["node_selector"] = dict(
            kv.split("=", 1) for kv in args.selector
        )
    return body


def _render(resp: dict) -> str:
    verdict = "FEASIBLE" if resp.get("feasible") else "INFEASIBLE"
    parts = [
        f"{verdict} v{resp.get('snapshot_version')}",
        f"nodes={resp.get('nodes')}",
    ]
    if resp.get("fit_errors"):
        parts.append(f"fit_errors={resp['fit_errors']}")
    ev = resp.get("evictions")
    if ev:
        parts.append(
            f"evict claim={ev['claim_nodes']} victims={len(ev['victims'])} "
            f"covered={ev['covered']}"
        )
    out = "  ".join(parts)
    # verdict honesty: model gaps the server declares for THIS request
    # (unmodeled victim gates, backfill-only BestEffort gangs) print on
    # their own marked lines so scripts and humans can't miss them
    for gap in resp.get("unmodeled") or []:
        out += f"\n  ! unmodeled: {gap}"
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kb-ctl whatif")
    p.add_argument("--server", default="http://127.0.0.1:8080",
                   help="scheduler admin API address")
    p.add_argument("--queue", default="default")
    p.add_argument("--count", type=int, default=1, help="gang size")
    p.add_argument("--min-available", type=int, default=None)
    p.add_argument("--cpu", type=float, default=1000.0, help="milli-cores per member")
    p.add_argument("--mem", type=float, default=float(1 << 30), help="bytes per member")
    p.add_argument("--priority", type=int, default=0)
    p.add_argument("--selector", action="append", default=[],
                   metavar="K=V", help="required node label (repeatable)")
    p.add_argument("--evictions", action="store_true",
                   help="also compute the hypothetical preemption set")
    p.add_argument("--json", default=None,
                   help="raw JSON request body (overrides the flags)")
    p.add_argument("--repeat", type=int, default=1,
                   help="fire N concurrent identical probes (amortization demo)")
    p.add_argument("--timeout", type=float, default=15.0)
    p.add_argument("--expect", choices=("feasible", "infeasible"), default=None,
                   help="exit 1 unless every verdict matches (CI smokes)")
    args = p.parse_args(argv)

    body = _body_from_args(args)
    try:
        if args.repeat <= 1:
            responses = [_post(args.server, body, args.timeout)]
        else:
            with ThreadPoolExecutor(max_workers=min(args.repeat, 64)) as pool:
                responses = list(pool.map(
                    lambda _: _post(args.server, body, args.timeout),
                    range(args.repeat),
                ))
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")
        print(f"whatif failed: HTTP {e.code} {detail}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"whatif failed: {e}", file=sys.stderr)
        return 2

    for resp in responses:
        print(_render(resp))
    if args.expect is not None:
        want = args.expect == "feasible"
        if not all(bool(r.get("feasible")) == want for r in responses):
            print(f"verdict mismatch: expected {args.expect}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
