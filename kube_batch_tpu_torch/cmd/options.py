"""Server options, mirroring ``kube_batch_tpu/cmd/options.py`` flag for
flag and default for default — all 13 CLI flags of the reference
(cmd/kube-batch/app/options/options.go:37-95), adapted to the standalone
host: `master`/`kubeconfig` become the listen address of an upstream ingest
feed (optional), QPS/burst throttle the egress writer."""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class ServerOption:
    """(options.go:37-51; defaults options.go:63-81)"""

    master: str = ""
    kubeconfig: str = ""
    scheduler_name: str = "volcano"
    scheduler_conf: str = ""
    schedule_period: float = 1.0  # seconds (`--schedule-period`, 1s default)
    default_queue: str = "default"
    enable_leader_election: bool = False
    lock_object_namespace: str = ""
    # warm-standby failover (BEYOND the reference's crash-on-loss): on a
    # lost lease the process demotes to standby IN PLACE — keeping the
    # compiled solve executables and device-resident buffers — and
    # re-contends; on re-acquire the cache rebuilds from the pod store and
    # revalidates the resident snapshot instead of cold-starting
    leader_warm_standby: bool = False
    listen_address: str = ":8080"
    enable_priority_class: bool = True
    kube_api_qps: float = 50.0
    kube_api_burst: int = 100
    print_version: bool = False
    # standalone-only: durable-state file (the etcd analog, SURVEY.md §5.4);
    # empty = in-memory only
    state_file: str = ""
    # standalone-only: how long the first cycle waits for the initial-sync
    # barrier (POST /v1/sync or a restored state file) — the WaitForCacheSync
    # analog; 0 = don't wait (clients that never signal lose nothing)
    cache_sync_timeout: float = 0.0
    # replicated read plane (replicate/): a leader URL turns this process
    # into a what-if follower — no scheduler, no ingest; the pull loop
    # applies the leader's cycle deltas and the serving stack answers
    # against the local replica
    follower: str = ""

    def check_option_or_die(self) -> None:
        """(options.go:84-90): leader election requires a lock namespace;
        the listen address must carry a numeric port."""
        if self.enable_leader_election and not self.lock_object_namespace:
            raise ValueError(
                "lock-object-namespace must not be nil when LeaderElection is enabled"
            )
        self.listen_host_port  # noqa: B018 — raises ValueError when malformed

    @property
    def listen_host_port(self) -> tuple:
        host, sep, port = self.listen_address.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(
                f"listen-address {self.listen_address!r} must be host:port"
            )
        host = host.strip("[]")  # [::]:8080 → ::
        return host or "0.0.0.0", int(port)


# process-global options (options.go:54 `ServerOpts`)
server_opts: Optional[ServerOption] = None


def add_flags(parser: argparse.ArgumentParser) -> None:
    """(options.go:63-81)"""
    d = ServerOption()
    parser.add_argument("--master", default=d.master,
                        help="url of an upstream cluster feed (accepted for CLI "
                             "parity; standalone ingest is the HTTP admin API)")
    parser.add_argument("--kubeconfig", default=d.kubeconfig,
                        help="path to a cluster-connection config file (accepted "
                             "for CLI parity; unused standalone)")
    parser.add_argument("--scheduler-name", default=d.scheduler_name,
                        help="the scheduler name pods request in schedulerName")
    parser.add_argument("--scheduler-conf", default=d.scheduler_conf,
                        help="path to the YAML actions/tiers configuration")
    parser.add_argument("--schedule-period", default=d.schedule_period, type=float,
                        help="seconds between scheduling cycles")
    parser.add_argument("--default-queue", default=d.default_queue,
                        help="queue assigned to podgroups that name none")
    parser.add_argument("--leader-elect", action="store_true",
                        default=d.enable_leader_election,
                        help="enable active/passive HA via a lease lock")
    parser.add_argument("--lock-object-namespace", default=d.lock_object_namespace,
                        help="namespace (directory) holding the leader lease")
    parser.add_argument("--leader-warm-standby", action="store_true",
                        default=d.leader_warm_standby,
                        help="on lost leadership, demote to standby in-place "
                             "(keep compiled solves + device-resident "
                             "buffers) and re-contend instead of crashing")
    parser.add_argument("--listen-address", default=d.listen_address,
                        help="host:port for /metrics and the admin API")
    parser.add_argument("--priority-class", dest="priority_class", default=d.enable_priority_class,
                        action="store_true",
                        help="resolve pod/job priority from PriorityClasses")
    parser.add_argument("--no-priority-class", dest="priority_class", action="store_false")
    parser.add_argument("--kube-api-qps", default=d.kube_api_qps, type=float,
                        help="egress write QPS limit")
    parser.add_argument("--kube-api-burst", default=d.kube_api_burst, type=int,
                        help="egress write burst")
    parser.add_argument("--version", action="store_true", default=False,
                        help="print version and exit")
    parser.add_argument("--state-file", default=d.state_file,
                        help="durable cluster-state JSON (standalone etcd "
                             "analog); loaded at startup, saved each cycle")
    parser.add_argument("--cache-sync-timeout", default=d.cache_sync_timeout,
                        type=float,
                        help="seconds to wait for the initial-sync barrier "
                             "(POST /v1/sync) before the first cycle; 0 = "
                             "don't wait")
    parser.add_argument("--follower", default=d.follower, metavar="URL",
                        help="run as a what-if read replica of the leader at "
                             "URL (its /v1/replicate stream) instead of "
                             "scheduling")


def parse(argv: Optional[List[str]] = None) -> ServerOption:
    parser = argparse.ArgumentParser(prog="kube-batch-tpu")
    add_flags(parser)
    ns = parser.parse_args(argv)
    opt = ServerOption(
        master=ns.master,
        kubeconfig=ns.kubeconfig,
        scheduler_name=ns.scheduler_name,
        scheduler_conf=ns.scheduler_conf,
        schedule_period=ns.schedule_period,
        default_queue=ns.default_queue,
        enable_leader_election=ns.leader_elect,
        lock_object_namespace=ns.lock_object_namespace,
        leader_warm_standby=ns.leader_warm_standby,
        listen_address=ns.listen_address,
        enable_priority_class=ns.priority_class,
        kube_api_qps=ns.kube_api_qps,
        kube_api_burst=ns.kube_api_burst,
        print_version=ns.version,
        state_file=ns.state_file,
        cache_sync_timeout=ns.cache_sync_timeout,
        follower=ns.follower,
    )
    global server_opts
    server_opts = opt
    return opt
