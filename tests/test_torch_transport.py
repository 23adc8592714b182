"""The port's classified retry transport (``kube_batch_tpu_torch/k8s/
transport.py``) against the JAX package's: every case runs the same
inputs through both modules and compares the outcomes (and pins them as
``tests/test_transport.py`` does): the error classification, backoff and
policy, the call retry loop, the circuit breaker and ``GuardedBackend``.
Then ``get_bytes`` against a loopback ``http.server`` serving a port
leader's replication stream, pulled by a ``ReplicationFollower`` built
with its default transport.  The ``K8sBackend`` and watch cases wait for
the rest of ``k8s/`` (ROADMAP item 8)."""

from __future__ import annotations

import http.client
import http.server
import io
import json
import random
import socket
import ssl
import threading
import urllib.error

import pytest

import kube_batch_tpu.k8s.transport as jax_transport
import kube_batch_tpu_torch.k8s.transport as port_transport

MODS = (jax_transport, port_transport)


def http_error(code: int, headers=None) -> urllib.error.HTTPError:
    return urllib.error.HTTPError("http://api", code, "x", headers or {}, io.BytesIO())


def both(fn):
    """``fn(module)`` for both packages; the outcomes must be equal."""
    got = [fn(m) for m in MODS]
    assert got[0] == got[1], got
    return got[1]


def _truncated_json():
    try:
        json.loads("{trunc")
    except json.JSONDecodeError as e:
        return e


CLASSIFY = [
    (http_error(429), "throttle"), (http_error(503), "throttle"),
    (http_error(408), "transient"), (http_error(500), "transient"),
    (http_error(502), "transient"), (http_error(504), "transient"),
    (http_error(501), "fatal"), (http_error(400), "fatal"), (http_error(404), "fatal"),
    (http_error(409), "fatal"), (http_error(403), "fatal"),
    (ConnectionRefusedError(), "transient"), (ConnectionResetError(), "transient"),
    (socket.timeout(), "transient"), (TimeoutError(), "transient"),
    (OSError("unreachable"), "transient"),
    (urllib.error.URLError(ConnectionRefusedError()), "transient"),
    (urllib.error.URLError("bad"), "transient"), (ssl.SSLError(), "transient"),
    (ValueError("bug"), "fatal"),
    (http.client.IncompleteRead(b"x"), "transient"),
    (http.client.BadStatusLine(""), "transient"),
    (_truncated_json(), "transient"),
    (ssl.SSLCertVerificationError("bad cert"), "fatal"),
    (urllib.error.URLError(ssl.SSLCertVerificationError("bad cert")), "fatal"),
    (port_transport.CircuitOpenError("open"), "transient"),
]


class TestClassification:
    @pytest.mark.parametrize("exc,kind", CLASSIFY)
    def test_table(self, exc, kind):
        assert both(lambda m: m.classify_error(exc)) == (kind, None)

    @pytest.mark.parametrize("headers,want", [
        ({"Retry-After": "7"}, ("throttle", 7.0)),
        ({"Retry-After": "-3"}, ("throttle", 0.0)),
        ({"Retry-After": "Wed, 21 Oct 2026 07:28:00 GMT"}, ("throttle", None)),
        ({}, ("throttle", None)),
    ])
    def test_retry_after(self, headers, want):
        assert both(lambda m: m.classify_error(http_error(429, headers))) == want


class TestBackoffAndPolicy:
    def test_decorrelated_jitter_draws(self):
        def draws(m):
            bo = m.Backoff(base=0.5, cap=30.0, rng=random.Random(7))
            return [bo.next() for _ in range(200)]

        seq = both(draws)
        prev = 0.5
        for d in seq:
            assert 0.5 <= d <= min(30.0, prev * 3.0) + 1e-9
            prev = max(0.5, d)

    def test_cap_and_reset(self):
        def run(m):
            bo = m.Backoff(base=1.0, cap=4.0, rng=random.Random(1))
            capped = [bo.next() for _ in range(50)]
            bo.reset()
            return capped, bo.next()

        capped, after_reset = both(run)
        assert max(capped) <= 4.0 and after_reset <= 3.0

    def test_budgets_per_endpoint_class(self):
        def budgets(m):
            p = m.RetryPolicy(budgets={"write": 2})
            return [p.budget(k) for k in ("write", "read", "watch", "unknown")]

        assert both(budgets) == [2, 5, 1, 5]

    def test_throttle_delay_honors_retry_after_capped(self):
        def delays(m):
            p = m.RetryPolicy(base=0.1, cap=5.0, rng=random.Random(0))
            bo = p.backoff_state()
            return [p.delay("throttle", 3.0, bo), p.delay("throttle", 500.0, bo),
                    p.delay("throttle", None, bo), p.delay("transient", 9.0, bo)]

        got = both(delays)
        assert got[:2] == [3.0, 5.0] and all(0.1 <= d <= 5.0 for d in got[2:])

    def test_policy_from_env(self, monkeypatch):
        monkeypatch.setenv("KB_RETRY_BASE", "0.5")
        monkeypatch.setenv("KB_RETRY_CAP", "9")
        monkeypatch.setenv("KB_RETRY_BUDGET_WRITE", "7")
        monkeypatch.setenv("KB_RETRY_BUDGET_WATCH", "0")
        monkeypatch.setenv("KB_BREAKER_THRESHOLD", "3")
        monkeypatch.setenv("KB_BREAKER_COOLDOWN", "2.5")

        def read(m):
            p = m.RetryPolicy.from_env()
            b = m.CircuitBreaker.from_env(name="x")
            return p.base, p.cap, p.budget("write"), p.budget("watch"), b.threshold, b.cooldown

        assert both(read) == (0.5, 9.0, 7, 1, 3, 2.5)


def make_transport(m, retry_policy=None, breaker=None):
    t = m.ApiTransport(
        "http://api",
        retry_policy=retry_policy or m.RetryPolicy(base=0.01, cap=0.05, rng=random.Random(0)),
        breaker=breaker or m.CircuitBreaker(threshold=3, cooldown=10.0, clock=lambda: 0.0))
    t.slept = []
    t._sleep = t.slept.append
    return t


def _outcome(fn):
    """A call's result, or the name of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__)


class TestCallRetryLoop:
    def _script(self, errors, result="ok"):
        """A callable raising ``errors`` in order, then returning."""
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= len(errors):
                raise errors[len(calls) - 1]
            return result

        return fn, calls

    @pytest.mark.parametrize("name,klass,errors,kw", [
        ("transient_then_ok", "read", [ConnectionRefusedError()] * 2, {}),
        ("budget_exhausted", "write", [ConnectionResetError("down")] * 9,
         {"threshold": 10}),
        ("fatal_at_once", "read", [http_error(404)], {}),
        ("retry_after_sleep", "read", [http_error(429, {"Retry-After": "2"})],
         {"cap": 30.0}),
        ("no_retry", "read", [ConnectionRefusedError()], {"retry": False}),
        ("throttle_no_header", "read", [http_error(503)] * 2, {}),
    ])
    def test_loop(self, name, klass, errors, kw):
        def run(m):
            policy = m.RetryPolicy(base=0.01, cap=kw.get("cap", 0.05), rng=random.Random(0))
            breaker = m.CircuitBreaker(threshold=kw.get("threshold", 3), cooldown=10.0,
                                       clock=lambda: 0.0)
            t = make_transport(m, policy, breaker)
            fn, calls = self._script(errors)
            out = _outcome(lambda: t._call(klass, fn, retry=kw.get("retry", True)))
            return out, len(calls), t.slept, t.breaker.state

        out, n_calls, slept, state = both(run)
        expect = {
            "transient_then_ok": (("ok", "ok"), 3, 2, "closed"),
            "budget_exhausted": (("raised", "ConnectionResetError"), 4, 3, "closed"),
            "fatal_at_once": (("raised", "HTTPError"), 1, 0, "closed"),
            "retry_after_sleep": (("ok", "ok"), 2, 1, "closed"),
            "no_retry": (("raised", "ConnectionRefusedError"), 1, 0, "closed"),
            "throttle_no_header": (("ok", "ok"), 3, 2, "closed"),
        }[name]
        assert (out, n_calls, len(slept), state) == expect
        if name == "retry_after_sleep":
            assert slept == [2.0]

    def test_open_breaker_fails_fast(self):
        def run(m):
            clock = [0.0]
            t = make_transport(m, breaker=m.CircuitBreaker(
                threshold=1, cooldown=10.0, clock=lambda: clock[0]))

            def down():
                raise ConnectionRefusedError()

            first = _outcome(lambda: t._call("read", down, retry=False))
            state = t.breaker.state
            second = _outcome(lambda: t._call("read", lambda: "never runs"))
            clock[0] = 11.0
            third = _outcome(lambda: t._call("read", lambda: "probe"))
            return first, state, second, third, t.breaker.state, t.degraded()

        assert both(run) == (("raised", "ConnectionRefusedError"), "open",
                             ("raised", "CircuitOpenError"), ("ok", "probe"),
                             "closed", False)

    def test_headers_and_roles(self, tmp_path):
        token = tmp_path / "token"
        token.write_text("abc\n")

        def run(m):
            t1 = m.ApiTransport("http://api/", role="writeback")
            t2 = m.ApiTransport("http://api", role="watch")
            t3 = m.ApiTransport("http://api", token_file=str(token))
            return (t1.api_server, t1.breaker.name, t2.breaker.name,
                    t3.headers("application/json"), m.ApiTransport("http://api").headers())

        got = both(run)
        assert got[1] == "http://api/writeback" and got[1] != got[2]
        assert got[3] == {"Content-Type": "application/json", "Authorization": "Bearer abc"}
        assert got[4] == {}

    def test_in_cluster_auth(self, monkeypatch, tmp_path):
        token = tmp_path / "t"
        token.write_text("x")
        monkeypatch.setenv("KB_KUBE_TOKEN_FILE", str(token))
        monkeypatch.setenv("KB_KUBE_CA_FILE", str(tmp_path / "missing.crt"))
        monkeypatch.setenv("KB_KUBE_INSECURE", "true")
        got = both(lambda m: m.in_cluster_auth())
        assert got == {"token_file": str(token), "ca_file": None, "insecure": True}


class TestCircuitBreaker:
    @pytest.mark.parametrize("script", [
        # (events, clock values): f = failure, s = success, a = allow
        ("ff", "closed"), ("fff", "open"), ("fsf", "closed"),
    ])
    def test_transitions(self, script):
        events, _want = script

        def run(m):
            b = m.CircuitBreaker(threshold=3 if events != "fsf" else 2, cooldown=5.0,
                                 clock=lambda: 0.0, name="t")
            for e in events:
                b.record_failure() if e == "f" else b.record_success()
            return b.state, b.is_open

        state, _open = both(run)
        assert state == _want

    def test_half_open_probe_and_counters(self):
        def run(m):
            clock = [0.0]
            b = m.CircuitBreaker(threshold=1, cooldown=5.0, clock=lambda: clock[0], name="t2")
            trace = []
            b.record_failure()
            trace.append(b.allow())          # open, cooldown running
            clock[0] = 6.0
            trace.append(b.allow())          # half-open: the one probe
            trace.append(b.allow())          # a second caller is refused
            b.record_failure()               # the probe failed: open again
            clock[0] = 10.0
            trace.append(b.allow())          # 4 s into the new cooldown
            clock[0] = 11.5
            trace.append(b.allow())          # the next probe window
            b.record_success()
            trace.append((b.state, b.allow()))
            return trace, dict(b.transitions)

        trace, transitions = both(run)
        assert trace == [False, True, False, False, True, ("closed", True)]
        assert transitions == {"open": 2, "half-open": 2, "closed": 1}


class _RecordingBackend:
    def __init__(self, fail=0):
        self.fail = fail
        self.binds = []
        self.evicts = []

    def bind(self, pod, hostname):
        if self.fail > 0:
            self.fail -= 1
            raise RuntimeError("down")
        self.binds.append((pod, hostname))

    def bind_many(self, pairs):
        if self.fail > 0:
            self.fail -= 1
            raise RuntimeError("down")
        self.binds.extend(pairs)

    def evict(self, pod):
        self.evicts.append(pod)


class TestGuardedBackend:
    def test_failures_open_then_calls_fail_fast(self):
        def run(m):
            clock = [0.0]
            backend = _RecordingBackend(fail=2)
            g = m.GuardedBackend(backend, m.CircuitBreaker(
                threshold=2, cooldown=5.0, clock=lambda: clock[0], name="g"))
            trace = [_outcome(lambda: g.bind("p", "n")) for _ in range(2)]
            trace.append(g.degraded())
            trace.append(_outcome(lambda: g.bind("p", "n")))
            trace.append(list(backend.binds))
            clock[0] = 6.0
            trace.append(_outcome(lambda: g.bind("p", "n")))
            trace.append(_outcome(lambda: g.bind_many([("q", "n")])))
            trace.append(_outcome(lambda: g.evict("v")))
            return trace, list(backend.binds), backend.evicts, g.degraded()

        trace, binds, evicts, degraded = both(run)
        assert trace[:5] == [("raised", "RuntimeError")] * 2 + [
            True, ("raised", "CircuitOpenError"), []]
        assert binds == [("p", "n"), ("q", "n")] and evicts == ["v"] and not degraded

    def test_bind_many_capability_mirrors_the_backend(self):
        class NoBatch:
            def bind(self, pod, hostname):
                pass

            def evict(self, pod):
                pass

        def run(m):
            g = m.GuardedBackend(NoBatch(), m.CircuitBreaker(clock=lambda: 0.0))
            g2 = m.GuardedBackend(_RecordingBackend(), m.CircuitBreaker(clock=lambda: 0.0))
            return g.bind_many is None, g2.bind_many is not None

        assert both(run) == (True, True)


# ==========================================================================
# get_bytes over a loopback HTTP server: a follower with its default
# transport, end to end
# ==========================================================================


class _ReplicateHandler(http.server.BaseHTTPRequestHandler):
    pub = None
    fail_first = 0
    paths: list = []

    def do_GET(self):  # noqa: N802 — http.server's name
        cls = type(self)
        cls.paths.append(self.path)
        if cls.fail_first > 0:
            cls.fail_first -= 1
            self.send_response(503)
            self.send_header("Retry-After", "0")
            self.end_headers()
            return
        since = int(self.path.rsplit("since=", 1)[1])
        body = cls.pub.record_for(since)
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *_a):
        pass


def test_follower_pulls_over_http_with_its_default_transport():
    """A port leader's stream behind a loopback ``http.server``: a
    ``ReplicationFollower`` built with its default transport (the port's
    ``ApiTransport``, role ``replicate``) pulls the full record through one
    throttled answer (503 with Retry-After, retried), then the delta, then
    a heartbeat, and answers like the leader."""
    from kube_batch_tpu_torch.replicate.follower import FollowerCache, ReplicationFollower
    from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher
    from kube_batch_tpu_torch.serve.plane import QueryPlane
    from test_torch_replicate import BODY, _canon, _churn, _leader_objects
    from test_torch_whatif import _port_run, _probe, port_cache

    cache = port_cache(**_leader_objects())
    qp = QueryPlane(cache, start_thread=False)
    cache.replication = pub = ReplicationPublisher()
    handler = type("Handler", (_ReplicateHandler,), {"pub": pub, "fail_first": 1, "paths": []})
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    fcache = FollowerCache()
    fqp = QueryPlane(fcache, start_thread=False)
    try:
        _port_run(cache)
        pub.barrier()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        f = ReplicationFollower(url, cache=fcache, query_plane=fqp, device="cpu", timeout=10)
        assert isinstance(f.transport, port_transport.ApiTransport)
        assert f.transport.breaker.name == f"{url}/replicate"
        f.transport._sleep = lambda s: None
        assert f.run_once() == "applied"
        _churn(cache, 0)
        _port_run(cache)
        pub.barrier()
        assert f.run_once() == "applied"
        assert f.run_once() == "heartbeat"
        assert handler.paths == ["/v1/replicate?since=0"] * 2 + [
            "/v1/replicate?since=1", "/v1/replicate?since=2"]
        assert f.applier.applied_seq == 2 and f.pull_errors == 0
        assert _canon(_probe(qp, BODY)) == _canon(_probe(fqp, BODY))
        server.shutdown()
        server.server_close()
        assert f.run_once() == "error" and f.pull_errors == 1
    finally:
        server.server_close()
        fqp.close()
        pub.close()
        qp.close()
        cache.stop()
