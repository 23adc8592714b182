"""`kb-ctl queue create|list` — the reference's cobra CLI
(cmd/cli/queue.go:26-52; pkg/cli/queue/create.go, list.go), mirroring
``kube_batch_tpu/cli/queue.py``: the same flags and the same output.

Two backends, matching the scheduler's own deployment modes:

  --master http://...   the Kubernetes API server: create/list Queue CRDs
                        (cluster-scoped, scheduling.incubator.k8s.io/v1alpha1)
                        — the reference CLI's clientset path
                        (create.go:47-68, list.go:51-87)
  --server http://...   the scheduler's HTTP admin API — standalone
                        deployments with no apiserver

    python -m kube_batch_tpu_torch.cli.queue create --master https://10.0.0.1:6443 \
        --name q1 --weight 2
    python -m kube_batch_tpu_torch.cli.queue list --server http://127.0.0.1:8080

Connection flags are accepted both before and after the subcommand.
"""

from __future__ import annotations

import argparse
import sys

_QUEUES_PATH = "/apis/scheduling.incubator.k8s.io/v1alpha1/queues"


def _transport(args, server: str):
    from kube_batch_tpu_torch.k8s.transport import ApiTransport

    return ApiTransport(
        server, token=args.token, token_file=args.token_file,
        ca_file=args.ca_file, insecure=args.insecure,
    )


def create(args) -> int:
    """(pkg/cli/queue/create.go:38-68) — in --master mode the authoritative
    queue store is the cluster: the CLI creates the Queue CRD and the
    scheduler picks it up through its watch, exactly like the reference."""
    if args.master:
        _transport(args, args.master).request(
            "POST",
            _QUEUES_PATH,
            {
                "apiVersion": "scheduling.incubator.k8s.io/v1alpha1",
                "kind": "Queue",
                "metadata": {"name": args.name},
                "spec": {"weight": args.weight},
            },
        )
    else:
        _transport(args, args.server).request(
            "POST", "/v1/queues", {"name": args.name, "weight": args.weight}
        )
    print(f"queue/{args.name} created")
    return 0


_LIST_FMT = "%-25s%-8s%-8s%-8s%-8s%-8s"


def list_(args) -> int:
    """(pkg/cli/queue/list.go:51-87): Name, Weight, then the Queue status
    podgroup-phase counts.

    In --master mode the phase counts come from the Queue CRD status. The
    reference never populates those fields (its filler controller arrived
    later, in Volcano), so its CLI prints zeros; THIS scheduler writes them
    back at session close (cache.update_queue_statuses), so the counts are
    live when it is the one scheduling the cluster.  The admin API
    (--server) computes the same counts directly from the scheduler cache."""
    if args.master:
        items = _transport(args, args.master).get_json(_QUEUES_PATH).get("items") or []
        rows = []
        for it in items:
            meta = it.get("metadata") or {}
            spec = it.get("spec") or {}
            status = it.get("status") or {}
            rows.append({
                "name": meta.get("name", ""),
                "weight": spec.get("weight", 1),
                "pending": status.get("pending", 0),
                "running": status.get("running", 0),
                "unknown": status.get("unknown", 0),
                "inqueue": status.get("inqueue", 0),
            })
    else:
        rows = _transport(args, args.server).get_json("/v1/queues")
    print(_LIST_FMT % ("Name", "Weight", "Pending", "Running", "Unknown",
                       "Inqueue"))
    for r in rows:
        print(_LIST_FMT % (r["name"], r["weight"], r["pending"], r["running"],
                           r["unknown"], r["inqueue"]))
    return 0


_CONN_DEFAULTS = {
    "server": "http://127.0.0.1:8080",
    "master": "",
    "token": None,
    "token_file": None,
    "ca_file": None,
    "insecure": False,
}


def main(argv=None) -> int:
    # connection flags live on a parent parser shared with the subcommands,
    # so `queue create --name q --master URL` and
    # `queue --master URL create --name q` both parse.  Defaults are
    # SUPPRESSed and applied after parsing: a subparser's default would
    # otherwise overwrite a value the top-level parser already consumed.
    conn = argparse.ArgumentParser(add_help=False, argument_default=argparse.SUPPRESS)
    conn.add_argument("--server",
                      help="scheduler admin API address (standalone mode)")
    conn.add_argument("--master",
                      help="Kubernetes API server URL — operate on Queue "
                           "CRDs instead of the scheduler admin API")
    conn.add_argument("--token", help="bearer token (--master)")
    conn.add_argument("--token-file")
    conn.add_argument("--ca-file")
    conn.add_argument("--insecure", action="store_true")
    parser = argparse.ArgumentParser(prog="kb-ctl queue", parents=[conn])
    sub = parser.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("create", help="create a queue", parents=[conn])
    pc.add_argument("--name", required=True)
    pc.add_argument("--weight", type=int, default=1)
    pc.set_defaults(fn=create)
    pl = sub.add_parser("list", help="list queues", parents=[conn])
    pl.set_defaults(fn=list_)
    args = parser.parse_args(argv)
    for k, v in _CONN_DEFAULTS.items():
        if not hasattr(args, k):
            setattr(args, k, v)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
