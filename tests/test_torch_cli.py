"""The port's process entry and command-line clients against the JAX
package's, on the CPU: ``ServerOption`` defaults and the parse of every
flag, ``check_option_or_die``, ``cmd.main`` (``--version`` → 0, a bad
option → 2, CUDA by default, ``--master`` against a loopback stub
apiserver), ``cli/queue.py`` against each package's server and
against a stub apiserver (``--master``), ``cli/whatif.py`` against each
package's server, ``run_follower`` pulling a leader over loopback HTTP,
and the two port smokes at their small CPU sizes."""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from kube_batch_tpu import actions as _jax_actions  # noqa: F401 — registers
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401 — registers
from kube_batch_tpu.api import serialize as jax_serialize
from kube_batch_tpu.api.types import PodPhase
from kube_batch_tpu.cli import queue as jax_queue_cli
from kube_batch_tpu.cli import whatif as jax_whatif_cli
from kube_batch_tpu.cmd import options as jax_options
from kube_batch_tpu_torch.cli import queue as port_queue_cli
from kube_batch_tpu_torch.cli import whatif as port_whatif_cli
from kube_batch_tpu_torch.cmd import main as port_main
from kube_batch_tpu_torch.cmd import options as port_options
from fixtures import GiB, build_node, build_pod
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

ARGVS = [
    [],
    ["--scheduler-name", "kb", "--schedule-period", "0.5",
     "--listen-address", "127.0.0.1:9999"],
    ["--master", "http://10.0.0.1:6443", "--kubeconfig", "/k", "--scheduler-conf", "/c.yaml",
     "--default-queue", "gold", "--leader-elect", "--lock-object-namespace", "/locks",
     "--leader-warm-standby", "--no-priority-class", "--kube-api-qps", "7.5",
     "--kube-api-burst", "9", "--version", "--state-file", "/s.json",
     "--cache-sync-timeout", "2.5", "--follower", "http://leader:8080"],
    ["--priority-class"],
    ["--listen-address", "[::]:8080"],
]


# --------------------------------------------------------------------------
# options and the process entry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40] or "defaults")
def test_options_parse_like_jax(argv):
    got = dataclasses.asdict(port_options.parse(argv))
    want = dataclasses.asdict(jax_options.parse(argv))
    assert got == want
    assert port_options.server_opts is not None


def test_option_fields_and_defaults_match_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(port_options.ServerOption)]
    want = [(f.name, f.default) for f in dataclasses.fields(jax_options.ServerOption)]
    assert got == want


@pytest.mark.parametrize("argv,ok", [
    ([], True), (["--leader-elect"], False),
    (["--leader-elect", "--lock-object-namespace", "/l"], True),
    (["--listen-address", "localhost"], False), (["--listen-address", ":x"], False),
    (["--listen-address", "0.0.0.0:80"], True),
])
def test_check_option_or_die_like_jax(argv, ok):
    outcomes = []
    for mod in (jax_options, port_options):
        opt = mod.parse(argv)
        try:
            opt.check_option_or_die()
            outcomes.append(("ok", opt.listen_host_port))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1][0] == "ok") is ok


def test_main_version_prints_and_returns_0(capsys):
    from kube_batch_tpu.cmd import main as jax_main

    assert port_main.main(["--version"]) == 0
    port_out = capsys.readouterr().out
    assert jax_main.main(["--version"]) == 0
    assert port_out == capsys.readouterr().out == "kube-batch-tpu 0.1.0 (dev)\n"


@pytest.mark.parametrize("argv", [["--leader-elect"], ["--listen-address", "nohost"]])
def test_main_bad_option_returns_2(argv, capsys):
    assert port_main.main(argv) == 2
    assert capsys.readouterr().err.startswith("error: ")


def test_main_unknown_flag_exits_2():
    with pytest.raises(SystemExit) as e:
        port_main.main(["--no-such-flag"])
    assert e.value.code == 2


def test_main_defaults_to_cuda(monkeypatch):
    """No ``device=``: the process schedules on the card and raises without
    one — there is no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--listen-address", "127.0.0.1:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--listen-address", "127.0.0.1:0", "--follower", "http://x:1"])


def test_master_is_refused_until_the_front_end_is_ported(monkeypatch):
    """The front end is ported: ``main(["--master", url], device="cpu")``
    no longer refuses.  Against the port's stub apiserver on loopback it
    seeds from the watch, its first cycle binds the listed pod by a
    Binding POST, and it returns 0 once the loop stops."""
    from kube_batch_tpu_torch.cmd import server as srv_mod
    from kube_batch_tpu_torch.testing.e2e import SCHED, Cluster, StubApiServer

    stub = StubApiServer()
    url = stub.start()
    node = Cluster.node_obj(None, "n1")
    stub.load("nodes", [node])
    stub.load("queues", [{"metadata": {"name": "default"}, "spec": {"weight": 1}}])
    stub.load("pods", [{"metadata": {"name": "p", "namespace": "default", "uid": "p-uid"},
                        "spec": {"schedulerName": SCHED, "containers": [
                            {"resources": {"requests": {"cpu": "100m"}}}]},
                        "status": {"phase": "Pending"}}])
    seen = {}
    real_serve = srv_mod.StandaloneServer.serve

    def serve(self):
        seen["server"] = self
        self.sched.on_cycle_end = self.sched.stop
        real_serve(self)

    monkeypatch.setattr(srv_mod.StandaloneServer, "serve", serve)
    try:
        assert port_main.main(["--listen-address", "127.0.0.1:0", "--master", url,
                               "--schedule-period", "0.01"], device="cpu") == 0
        assert seen["server"].k8s_mode
        assert stub.stats()["pods_on_nodes"] == 1
    finally:
        stub.stop()
    assert seen["server"].watcher.join(10)


def test_main_runs_the_server_on_the_cpu(monkeypatch):
    """``main(..., device="cpu")`` builds the standalone server and runs its
    loop; the scheduler stops after its first cycle here."""
    from kube_batch_tpu_torch.cmd import server as srv_mod

    seen = {}
    real_serve = srv_mod.StandaloneServer.serve

    def serve(self):
        seen["server"] = self
        self.sched.on_cycle_end = self.sched.stop
        real_serve(self)

    monkeypatch.setattr(srv_mod.StandaloneServer, "serve", serve)
    assert port_main.main(["--listen-address", "127.0.0.1:0",
                           "--schedule-period", "0.01"], device="cpu") == 0
    server = seen["server"]
    assert server.device.type == "cpu" and server.sched.device.type == "cpu"


# --------------------------------------------------------------------------
# servers for the CLIs
# --------------------------------------------------------------------------


class Servers:
    """A JAX and a port AdminServer, each over a cache with a query plane,
    fed the same small cluster and one cycle."""

    def __init__(self):
        from kube_batch_tpu.cache.cache import SchedulerCache as JaxCache
        from kube_batch_tpu.cmd.server import AdminServer as JaxAdmin
        from kube_batch_tpu.framework.conf import load_scheduler_conf as jconf
        from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
        from kube_batch_tpu.serve.plane import QueryPlane as JaxPlane
        from kube_batch_tpu_torch.cache.cache import SchedulerCache
        from kube_batch_tpu_torch.cmd.server import AdminServer
        from kube_batch_tpu_torch.framework.conf import load_scheduler_conf
        from kube_batch_tpu_torch.scheduler import Scheduler
        from kube_batch_tpu_torch.serve.plane import QueryPlane
        from test_torch_cycle import mirror

        self.caches = {"jax": JaxCache(), "port": SchedulerCache()}
        # a long lease wait: the JAX package's first eviction probe
        # compiles inside it (seconds on a loaded machine)
        self.planes = {"jax": JaxPlane(self.caches["jax"], window_s=0.001,
                                       dispatch_timeout=120),
                       "port": QueryPlane(self.caches["port"], window_s=0.001,
                                          dispatch_timeout=120)}
        objs = [("add_queue", jax_serialize.queue_from_dict({"name": "default"}))]
        objs += [("add_node", build_node(f"n{i}", cpu=4000, mem=8 * GiB, pods=16))
                 for i in range(3)]
        objs += [("add_pod", build_pod("c1", f"p{i}", None, PodPhase.PENDING,
                                       {"cpu": 1000, "memory": GiB})) for i in range(4)]
        for pkg, cache in self.caches.items():
            for kind, obj in objs:
                getattr(cache, kind)(obj if pkg == "jax" else mirror(obj))
        JaxScheduler(self.caches["jax"], conf=jconf(None)).run_once()
        psched = Scheduler(self.caches["port"], conf=load_scheduler_conf(None), device="cpu")
        psched.run_once()
        psched.close()
        self.admins = {"jax": JaxAdmin(self.caches["jax"], port=0,
                                       query_plane=self.planes["jax"]),
                       "port": AdminServer(self.caches["port"], port=0,
                                           query_plane=self.planes["port"])}
        for a in self.admins.values():
            a.start()

    def url(self, pkg):
        return f"http://127.0.0.1:{self.admins[pkg].port}"

    def close(self):
        for pkg in self.admins:
            self.admins[pkg].stop()
            self.planes[pkg].close()
            self.caches[pkg].stop()


@pytest.fixture(scope="module")
def servers():
    s = Servers()
    yield s
    s.close()


def _both(capsys, servers, run):
    """(rc, stdout, stderr) of ``run(cli module, server url)`` per package."""
    out = {}
    for pkg, mods in (("jax", (jax_queue_cli, jax_whatif_cli)),
                      ("port", (port_queue_cli, port_whatif_cli))):
        rc = run(mods, servers.url(pkg))
        cap = capsys.readouterr()
        out[pkg] = (rc, cap.out, cap.err.replace(str(servers.admins[pkg].port), "<port>"))
    return out


def test_queue_cli_create_and_list_print_like_jax(servers, capsys):
    def run(mods, url):
        q = mods[0]
        rc = q.main(["--server", url, "create", "--name", "gold", "--weight", "5"])
        return (rc, q.main(["list", "--server", url]))

    out = _both(capsys, servers, run)
    assert out["port"] == out["jax"]
    assert out["port"][0] == (0, 0)
    assert "queue/gold created" in out["port"][1] and "Weight" in out["port"][1]
    assert servers.caches["port"].queues["gold"].weight == 5


class StubApiServer:
    """An in-memory Queue-CRD apiserver for ``--master``."""

    def __init__(self):
        store = self.store = {}

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                obj = json.loads(self.rfile.read(n))
                obj.setdefault("status", {"pending": 1, "running": 2})
                store[obj["metadata"]["name"]] = obj
                self._send(201, obj)

            def do_GET(self):
                self._send(200, {"items": [store[k] for k in sorted(store)]})

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(5)


def test_queue_cli_master_mode_against_a_stub_apiserver(capsys):
    out, stores = {}, {}
    for pkg, q in (("jax", jax_queue_cli), ("port", port_queue_cli)):
        stub = StubApiServer()
        try:
            rc1 = q.main(["create", "--master", stub.url, "--name", "gold", "--weight", "5"])
            rc2 = q.main(["--master", stub.url, "list"])
            out[pkg] = (rc1, rc2, capsys.readouterr().out)
            stores[pkg] = stub.store
        finally:
            stub.close()
    assert out["port"] == out["jax"]
    assert stores["port"] == stores["jax"]
    gold = stores["port"]["gold"]
    assert gold["kind"] == "Queue" and gold["spec"]["weight"] == 5
    row = [ln for ln in out["port"][2].splitlines() if ln.startswith("gold")]
    assert row and row[0].split()[:4] == ["gold", "5", "1", "2"]


@pytest.mark.parametrize("argv,rc", [
    (["--count", "2", "--cpu", "1000", "--expect", "feasible"], 0),
    (["--count", "2", "--cpu", "900000", "--expect", "infeasible"], 0),
    (["--count", "2", "--cpu", "900000", "--expect", "feasible"], 1),
    (["--count", "1", "--cpu", "500", "--repeat", "4", "--evictions",
      "--selector", "kubernetes.io/os=linux", "--min-available", "1", "--priority", "3"], 0),
    (["--json", json.dumps({"queue": "default", "count": 3, "requests": {"cpu": 100}})], 0),
    (["--json", json.dumps({"queue": "default", "count": 0})], 2),
])
def test_whatif_cli_prints_like_jax(servers, capsys, argv, rc):
    out = _both(capsys, servers, lambda mods, url: mods[1].main(
        ["--server", url, "--timeout", "300"] + argv))
    assert out["port"] == out["jax"]
    assert out["port"][0] == rc


def test_whatif_cli_unreachable_server_returns_2(capsys):
    assert port_whatif_cli.main(["--server", "http://127.0.0.1:1", "--timeout", "2"]) == 2
    assert "whatif failed" in capsys.readouterr().err


# --------------------------------------------------------------------------
# run_follower over loopback HTTP
# --------------------------------------------------------------------------


def test_run_follower_pulls_and_answers_as_the_leader(monkeypatch):
    """A leader (the standalone server on the CPU) and ``run_follower``
    pulling its ``/v1/replicate`` over loopback HTTP: once caught up, the
    follower answers a what-if and a sweep byte for byte as the leader."""
    from kube_batch_tpu_torch.cmd import options, server as srv_mod
    from kube_batch_tpu_torch.replicate import follower as follower_mod
    from test_torch_server import http

    leader = srv_mod.StandaloneServer(options.parse(["--listen-address", "127.0.0.1:0"]),
                                      device="cpu")
    started = []
    real_start = follower_mod.ReplicationFollower.start

    def start(self):
        started.append(self)
        real_start(self)

    monkeypatch.setattr(follower_mod.ReplicationFollower, "start", start)
    fopt = options.parse(["--listen-address", "127.0.0.1:0", "--follower",
                          f"http://127.0.0.1:{leader.admin.port}"])
    admins = []
    real_admin = srv_mod.AdminServer

    def admin(*a, **kw):
        admins.append(real_admin(*a, **kw))
        return admins[-1]

    monkeypatch.setattr(srv_mod, "AdminServer", admin)
    t = threading.Thread(target=srv_mod.run_follower, args=(fopt,), kwargs={"device": "cpu"},
                         daemon=True)
    try:
        port = leader.admin.port
        http(port, "POST", "/v1/queues", {"name": "default", "weight": 1})
        http(port, "POST", "/v1/nodes", [jax_serialize.node_to_dict(
            build_node(f"n{i}", cpu=4000, mem=8 * GiB, pods=16)) for i in range(3)])
        http(port, "POST", "/v1/pods", [jax_serialize.pod_to_dict(build_pod(
            "c1", f"p{i}", None, PodPhase.PENDING, {"cpu": 1000, "memory": GiB}))
            for i in range(4)])
        leader.sched.run_once()
        leader.sched.drain_pipeline()
        t.start()
        deadline = time.monotonic() + 30
        head = leader.cache.replication.counters()["head_seq"]
        while time.monotonic() < deadline and not (
                started and started[0].applier.applied_seq >= head):
            time.sleep(0.01)
        assert started and started[0].applier.applied_seq == head > 0
        fport = admins[0].port
        for path, body in (("/v1/whatif", {"count": 2, "requests": {"cpu": 1000}}),
                           ("/v1/whatif/sweep", {"max_count": 8, "requests": {"cpu": 500}})):
            want = json.loads(http(port, "POST", path, body)[2])
            got = json.loads(http(fport, "POST", path, body)[2])
            assert got.pop("staleness")["seq"] == head
            want.pop("staleness", None)
            assert got == want
        assert http(fport, "POST", "/v1/pods", {"name": "x"})[0] == 400  # read-only
    finally:
        if started:
            started[0].stop()  # run_follower's join returns; its finally closes
        t.join(30)
        leader.close()
    assert not t.is_alive()


# --------------------------------------------------------------------------
# the port's smokes
# --------------------------------------------------------------------------


def test_whatif_smoke_is_clean(capsys):
    from kube_batch_tpu_torch.testing import whatif_smoke

    whatif_smoke.main(["--device", "cpu"])  # exits 1 on a violated invariant
    assert "whatif smoke clean" in capsys.readouterr().out


def test_replication_smoke_is_clean(capsys):
    from kube_batch_tpu_torch.testing import replication_smoke

    replication_smoke.main(["--device", "cpu"])
    assert "replication smoke clean" in capsys.readouterr().out
