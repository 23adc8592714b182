"""The replication smoke for kube_batch_tpu_torch, the port's copy of the
JAX package's ``scripts/replication_smoke.py``: the follower read plane
end to end over real loopback HTTP.

Starts a leader (AdminServer + QueryPlane + ReplicationPublisher) on a
loopback port against a small synthetic cluster, attaches TWO follower
processes-in-miniature (FollowerCache + QueryPlane + ReplicationFollower
pull loop + their own AdminServer each), then drives randomized churn
cycles on the leader while probing every live serving endpoint:

- verdict bit-match: once caught up, leader and both followers must
  answer /v1/whatif and /v1/whatif/sweep byte-identically;
- bounded staleness: the lag_cycles reported by live followers during
  churn must stay ≤ 1 at p99;
- serving continuity: one follower's pull loop is killed mid-churn and
  restarted — its HTTP plane must keep answering throughout, re-adopt
  its device residency WARM, and catch back up over the delta chain.

Exit 0 = clean, 1 = a violated invariant.  A few seconds:

    python -m kube_batch_tpu_torch.testing.replication_smoke [--device cpu]

``--device`` defaults to CUDA (the card), as every port entry point does;
the leader's cycles and both followers run on it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request


def _fail(msg: str) -> None:
    print(f"replication smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _post(server: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        server + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read().decode())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="replication_smoke")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    device = ap.parse_args(argv).device

    import numpy as np

    import kube_batch_tpu_torch.actions  # noqa: F401 — registers actions
    import kube_batch_tpu_torch.plugins  # noqa: F401 — registers plugins
    from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Pod, PodGroup
    from kube_batch_tpu_torch.api.types import PodPhase
    from kube_batch_tpu_torch.cmd.server import AdminServer
    from kube_batch_tpu_torch.framework.conf import load_scheduler_conf
    from kube_batch_tpu_torch.framework.interface import get_action
    from kube_batch_tpu_torch.framework.session import close_session, open_session
    from kube_batch_tpu_torch.replicate.follower import (
        FollowerCache,
        ReplicationFollower,
    )
    from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher
    from kube_batch_tpu_torch.serve.plane import QueryPlane
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    GiB = float(2 ** 30)
    rng = np.random.default_rng(7)
    conf = load_scheduler_conf(None)

    cache = synthetic_cluster(n_tasks=24, n_nodes=6, gang_size=2, n_queues=2)
    cache.replication = pub = ReplicationPublisher()
    qp = QueryPlane(cache, max_batch=8, window_s=0.002, dispatch_timeout=60)
    srv = AdminServer(cache, port=0, query_plane=qp)
    srv.start()
    leader_url = f"http://127.0.0.1:{srv.port}"

    def cycle() -> None:
        ssn = open_session(cache, conf.tiers, device)
        try:
            for name in conf.actions:
                get_action(name).execute(ssn)
        finally:
            close_session(ssn)
        cache.flush_binds()

    cycle()  # publish the first lease + replication record

    followers = []
    try:
        for i in range(2):
            fcache = FollowerCache()
            fqp = QueryPlane(fcache, max_batch=8, window_s=0.002,
                             dispatch_timeout=60)
            f = ReplicationFollower(leader_url, cache=fcache,
                                    query_plane=fqp, poll_s=0.005,
                                    device=device)
            fsrv = AdminServer(fcache, port=0, query_plane=fqp)
            fsrv.start()
            f.start()
            followers.append((f, fqp, fsrv,
                              f"http://127.0.0.1:{fsrv.port}"))

        probe_body = {"queue": "q0", "count": 2,
                      "requests": {"cpu": 1000, "memory": GiB}}

        # wait for both followers to adopt the initial snapshot
        deadline = time.monotonic() + 30
        while any(f.applier.applied_seq < 1 for f, *_ in followers):
            if time.monotonic() > deadline:
                _fail("followers never adopted the initial snapshot")
            time.sleep(0.01)

        killed = followers[1][0]
        resident_before_kill = killed.applier.resident
        lags: list = []
        churn_i = 0
        for c in range(12):
            # randomized churn: 1-3 new small gangs per cycle
            for _ in range(int(rng.integers(1, 4))):
                g = f"smoke-{churn_i}"
                churn_i += 1
                cache.add_pod_group(PodGroup(
                    name=g, namespace="smoke", min_member=1, queue="q0",
                    creation_index=1000 + churn_i))
                cache.add_pod(Pod(
                    name=f"{g}-0", namespace="smoke",
                    requests={"cpu": float(rng.integers(100, 500)),
                              "memory": GiB / 4},
                    annotations={GROUP_NAME_ANNOTATION: g},
                    phase=PodPhase.PENDING,
                    creation_index=10_000 + churn_i))
            cycle()
            if c == 4:
                killed.stop()       # pull loop dies; its HTTP plane stays up
            if c == 8:
                killed.start()      # restart → warm re-adopt + catch-up
            time.sleep(0.02)
            # every server must answer mid-churn (continuity), and live
            # followers must report bounded staleness
            for idx, (f, _fqp, _fsrv, url) in enumerate(followers):
                resp = _post(url, "/v1/whatif", probe_body)
                if "staleness" not in resp:
                    _fail(f"follower {idx} response missing staleness")
                if f._thread is not None:    # pull loop live
                    lags.append(resp["staleness"]["lag_cycles"])
            _post(leader_url, "/v1/whatif", probe_body)

        pub.barrier()
        head = pub.counters()["head_seq"]
        deadline = time.monotonic() + 30
        while any(f.applier.applied_seq < head for f, *_ in followers):
            if time.monotonic() > deadline:
                _fail(f"followers never caught up to head {head}: "
                      f"{[f.applier.applied_seq for f, *_ in followers]}")
            time.sleep(0.01)

        if killed.applier.resident is not resident_before_kill:
            _fail("restarted follower dropped its resident cache "
                  "(expected warm re-adoption)")

        p99 = float(np.percentile(lags, 99)) if lags else 0.0
        if p99 > 1.0:
            _fail(f"staleness p99 {p99} cycles > 1 (lags {sorted(lags)})")

        # frozen head: every serving plane must agree bit-for-bit
        bodies = [
            ("/v1/whatif", probe_body),
            ("/v1/whatif", {"queue": "q1", "count": 3,
                            "requests": {"cpu": 900000}}),
            ("/v1/whatif", {"queue": "q0", "count": 1,
                            "requests": {"cpu": 500, "memory": GiB},
                            "min_resources": {"cpu": 4000}}),
            ("/v1/whatif/sweep", {"queue": "q0", "max_count": 32,
                                  "requests": {"cpu": 2000,
                                               "memory": GiB}}),
        ]
        matched = 0
        for path, body in bodies:
            want = json.dumps(_post(leader_url, path, body), sort_keys=True)
            for idx, (_f, _fqp, _fsrv, url) in enumerate(followers):
                got = json.dumps(_post(url, path, body), sort_keys=True)
                if got != want:
                    _fail(f"follower {idx} diverged on {path} {body}:\n"
                          f"  leader   {want}\n  follower {got}")
                matched += 1

        counters = pub.counters()
        if counters["records_delta"] < 8:
            _fail(f"churn traveled as {counters['records_delta']} deltas "
                  f"(expected the steady state on the wire)")
        gaps = sum(f.applier.gaps for f, *_ in followers)
        print(f"replication smoke clean: {head} cycles "
              f"({counters['records_delta']} deltas, "
              f"{counters['records_full']} fulls, {gaps} gaps), "
              f"{matched} bit-matched verdicts across 2 followers, "
              f"staleness p99 {p99:.0f} cycle(s) over {len(lags)} samples")
    finally:
        for f, fqp, fsrv, _url in followers:
            f.stop()
            fsrv.stop()
            fqp.close()
        srv.stop()
        qp.close()
        pub.close()


if __name__ == "__main__":
    main()
