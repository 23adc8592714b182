"""The classified retry transport, mirroring
``kube_batch_tpu/k8s/transport.py``: bearer-token auth, a TLS context and
request helpers over urllib, every call under one retry policy and one
circuit breaker (client-go's rate-limited workqueues and informer relist
resilience, standalone).

- :func:`classify_error` sorts a failure into ``transient`` (connection
  refused or reset, timeouts, 5xx), ``throttle`` (429 / 503: the server
  asks for a pause; ``Retry-After`` is honoured) or ``fatal`` (other 4xx:
  the server answered, a retry cannot change it).
- :class:`RetryPolicy` owns capped decorrelated-jitter backoff (``sleep =
  min(cap, U(base, prev * 3))``) and attempt budgets per endpoint class
  (``read``, ``write``, ``watch``: the watch loop is its own outer retry,
  so its budget is 1).
- :class:`CircuitBreaker` guards each transport: N consecutive failures
  open it, calls then fail fast with :class:`CircuitOpenError` (an
  ``OSError``, so "unreachable" handlers classify it right) until a
  cooldown passes and one half-open probe decides.
- :class:`GuardedBackend` puts a binder or evictor that is not a
  transport behind a breaker.

The replication follower pulls its frames through
:meth:`ApiTransport.get_bytes`.  Standard library only.  The JAX
package's metrics are not ported (ROADMAP item 9); the breaker's
transition counts stay on the object (``CircuitBreaker.transitions``).
"""

from __future__ import annotations

import json
import logging
import os
import random
import socket
import ssl
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger("kube_batch_tpu_torch")

SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# ---------------------------------------------------------------------------
# error classification
# ---------------------------------------------------------------------------

TRANSIENT = "transient"  # retry with backoff
THROTTLE = "throttle"    # retry after the server-directed delay
FATAL = "fatal"          # the server answered; retrying cannot help


def _retry_after_seconds(err: urllib.error.HTTPError) -> Optional[float]:
    """Parse a Retry-After header (delta-seconds form; HTTP-date is rare
    from an apiserver and falls back to policy backoff)."""
    try:
        raw = err.headers.get("Retry-After") if err.headers else None
    except AttributeError:
        return None
    if not raw:
        return None
    try:
        return max(0.0, float(raw))
    except ValueError:
        return None  # HTTP-date form: let the policy backoff decide


def classify_error(exc: BaseException) -> Tuple[str, Optional[float]]:
    """(kind, retry_after_seconds) for one transport failure.

    The table:
    429/503 → throttle (Retry-After honored); 408 and other 5xx →
    transient; remaining 4xx (and 501) → fatal; connection refused/reset,
    timeouts, unreachable sockets, mid-response drops (IncompleteRead /
    BadStatusLine and truncated JSON bodies) → transient; TLS certificate
    verification failures → fatal (retrying a bad cert is noise);
    everything unrecognized → fatal, because retrying an unknown
    programming error just hides it."""
    import http.client

    if isinstance(exc, urllib.error.HTTPError):
        code = exc.code
        if code in (429, 503):
            return THROTTLE, _retry_after_seconds(exc)
        if code == 408 or (500 <= code < 600 and code != 501):
            return TRANSIENT, None
        return FATAL, None
    if isinstance(exc, ssl.SSLCertVerificationError):
        return FATAL, None
    if isinstance(exc, urllib.error.URLError):
        # the wrapped reason carries the socket-level truth
        reason = exc.reason
        if isinstance(reason, BaseException):
            return classify_error(reason)
        return TRANSIENT, None
    if isinstance(exc, (ConnectionError, socket.timeout, TimeoutError,
                        ssl.SSLError, OSError)):
        return TRANSIENT, None
    if isinstance(exc, (http.client.HTTPException, json.JSONDecodeError)):
        # a connection dropped mid-response: IncompleteRead/BadStatusLine
        # (not OSError subclasses) or a truncated JSON body — network
        # symptoms, not server verdicts
        return TRANSIENT, None
    return FATAL, None


# ---------------------------------------------------------------------------
# retry policy: budgets + decorrelated-jitter backoff
# ---------------------------------------------------------------------------

#: attempt budgets per endpoint class; the watch's budget is 1 because its
#: caller (the per-resource reconnect loop) IS the outer retry
DEFAULT_BUDGETS: Dict[str, int] = {"read": 5, "write": 4, "watch": 1}


class Backoff:
    """Decorrelated-jitter backoff state: each delay is drawn uniformly
    from [base, prev*3], capped — retries desynchronize across callers
    instead of marching in lockstep against a recovering apiserver."""

    def __init__(self, base: float, cap: float, rng: random.Random):
        self.base = base
        self.cap = cap
        self._rng = rng
        self._prev = base

    def next(self) -> float:
        delay = min(self.cap, self._rng.uniform(self.base, self._prev * 3.0))
        self._prev = max(self.base, delay)
        return delay

    def reset(self) -> None:
        self._prev = self.base


class RetryPolicy:
    """Classification-aware retry budgets + backoff for one transport.

    ``rng`` is injectable so tests pin the jitter; ``budgets`` maps
    endpoint classes to max attempts (missing classes default to the
    ``read`` budget)."""

    def __init__(
        self,
        base: float = 0.25,
        cap: float = 30.0,
        budgets: Optional[Dict[str, int]] = None,
        rng: Optional[random.Random] = None,
    ):
        self.base = base
        self.cap = cap
        self.budgets = dict(DEFAULT_BUDGETS)
        if budgets:
            self.budgets.update(budgets)
        self._rng = rng if rng is not None else random.Random()

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """Env knobs: KB_RETRY_BASE / KB_RETRY_CAP (seconds) and
        KB_RETRY_BUDGET_{READ,WRITE,WATCH} (attempts)."""
        budgets = {}
        for klass in DEFAULT_BUDGETS:
            raw = os.environ.get(f"KB_RETRY_BUDGET_{klass.upper()}")
            if raw:
                budgets[klass] = max(1, int(raw))
        return cls(
            base=float(os.environ.get("KB_RETRY_BASE", "0.25")),
            cap=float(os.environ.get("KB_RETRY_CAP", "30")),
            budgets=budgets or None,
        )

    def budget(self, endpoint_class: str) -> int:
        return self.budgets.get(endpoint_class, self.budgets["read"])

    def backoff_state(self) -> Backoff:
        return Backoff(self.base, self.cap, self._rng)

    def delay(self, kind: str, retry_after: Optional[float],
              backoff: Backoff) -> float:
        """Next sleep for a retryable failure: the server-directed
        Retry-After when the throttle carries one (capped — a hostile or
        confused header must not park the caller for minutes), the jittered
        backoff otherwise."""
        if kind == THROTTLE and retry_after is not None:
            return min(retry_after, self.cap)
        return backoff.next()


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitOpenError(OSError):
    """Raised instead of dialing when the breaker is open. An OSError so
    existing classify-as-unreachable handlers (the lease elector, the
    resync repair path) treat it as the transient outage it represents."""


class CircuitBreaker:
    """closed → open after ``threshold`` consecutive failures; open fails
    fast until ``cooldown`` elapses; then half-open admits ONE probe whose
    outcome closes or re-opens. The clock is injectable (the simulator
    passes its virtual clock). State flips happen under a lock; nothing
    blocks under it."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(
        self,
        threshold: int = 5,
        cooldown: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "apiserver",
    ):
        self.threshold = max(1, threshold)
        self.cooldown = cooldown
        self._clock = clock
        self.name = name
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        # transitions into each state
        self.transitions: Dict[str, int] = {}

    @classmethod
    def from_env(cls, clock: Callable[[], float] = time.monotonic,
                 name: str = "apiserver") -> "CircuitBreaker":
        """Env knobs: KB_BREAKER_THRESHOLD / KB_BREAKER_COOLDOWN."""
        return cls(
            threshold=int(os.environ.get("KB_BREAKER_THRESHOLD", "5")),
            cooldown=float(os.environ.get("KB_BREAKER_COOLDOWN", "10")),
            clock=clock, name=name,
        )

    # -- state ----------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def is_open(self) -> bool:
        """True while calls would fail fast (open, cooldown not elapsed)."""
        with self._lock:
            return (self._state == self.OPEN
                    and self._clock() - self._opened_at < self.cooldown)

    def _transition(self, state: str) -> None:
        # lock held by caller
        if state == self._state:
            return
        self._state = state
        self.transitions[state] = self.transitions.get(state, 0) + 1
        logger.warning("circuit breaker %s → %s", self.name, state)

    def allow(self) -> bool:
        """May a call go out now? Open breakers admit exactly one probe
        once the cooldown elapsed (half-open)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.cooldown:
                    self._transition(self.HALF_OPEN)
                    self._probe_inflight = True
                    return True
                return False
            # half-open: one probe at a time
            if not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == self.HALF_OPEN:
                self._opened_at = self._clock()
                self._transition(self.OPEN)
                return
            self._failures += 1
            if self._failures >= self.threshold:
                self._opened_at = self._clock()
                self._transition(self.OPEN)


class GuardedBackend:
    """Binder/Evictor seam wrapper that routes calls through a
    :class:`CircuitBreaker` — used where the backend is NOT an
    ApiTransport-backed K8sBackend (whose transport already carries its
    own breaker), e.g. the simulator's kubelet, so chaos runs exercise the
    exact breaker the production transport uses."""

    def __init__(self, backend, breaker: CircuitBreaker):
        self._backend = backend
        self.breaker = breaker
        # mirror the backend's batch capability: cache._dispatch_async
        # probes for bind_many and must not find one we can't honor
        if getattr(backend, "bind_many", None) is None:
            self.bind_many = None  # type: ignore[assignment]

    def _guard(self, fn, *args):
        if not self.breaker.allow():
            raise CircuitOpenError(
                f"circuit breaker {self.breaker.name} is open")
        try:
            out = fn(*args)
        except Exception:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return out

    def bind(self, pod, hostname):
        return self._guard(self._backend.bind, pod, hostname)

    def bind_many(self, pairs):
        return self._guard(self._backend.bind_many, pairs)

    def evict(self, pod):
        return self._guard(self._backend.evict, pod)

    def degraded(self) -> bool:
        return self.breaker.is_open


# ---------------------------------------------------------------------------
# auth + transport
# ---------------------------------------------------------------------------


def in_cluster_auth() -> Dict[str, Optional[str]]:
    """token_file/ca_file/insecure kwargs for the cluster transport: the
    mounted serviceaccount when present, overridable out-of-cluster via
    KB_KUBE_TOKEN_FILE / KB_KUBE_CA_FILE / KB_KUBE_INSECURE (how a
    scheduler run outside the cluster gets its credentials)."""
    token = os.environ.get("KB_KUBE_TOKEN_FILE") or f"{SERVICEACCOUNT_DIR}/token"
    ca = os.environ.get("KB_KUBE_CA_FILE") or f"{SERVICEACCOUNT_DIR}/ca.crt"
    auth: Dict[str, Optional[str]] = {
        "token_file": token if os.path.exists(token) else None,
        "ca_file": ca if os.path.exists(ca) else None,
    }
    if os.environ.get("KB_KUBE_INSECURE", "").lower() in ("1", "true", "yes"):
        auth["insecure"] = True  # type: ignore[assignment]
    return auth


class ApiTransport:
    def __init__(
        self,
        api_server: str,
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure: bool = False,
        retry_policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        role: str = "",
    ):
        self.api_server = api_server.rstrip("/")
        # `role` disambiguates the breaker metric label when several
        # transports target the same host (writeback / watch / lease each
        # have their own breaker; a shared label would be last-writer-wins)
        self.role = role
        self._token = token
        self._token_file = token_file
        self._ctx: Optional[ssl.SSLContext] = None
        if api_server.startswith("https"):
            self._ctx = ssl.create_default_context(cafile=ca_file)
            if insecure:
                self._ctx.check_hostname = False
                self._ctx.verify_mode = ssl.CERT_NONE
        # one transport ↔ one host: the breaker is effectively per-host
        # (per host+role when several transports share the host)
        self.retry = retry_policy if retry_policy is not None \
            else RetryPolicy.from_env()
        name = f"{self.api_server}/{role}" if role else self.api_server
        self.breaker = breaker if breaker is not None \
            else CircuitBreaker.from_env(name=name)
        self._sleep = time.sleep  # injectable for tests

    def degraded(self) -> bool:
        """Is the writeback path failing fast right now? (The cache's
        status-shed / degraded-cycle checks read this.)"""
        return self.breaker.is_open

    def headers(self, content_type: Optional[str] = None) -> Dict[str, str]:
        tok = self._token
        if tok is None and self._token_file:
            # re-read per request: kubelet rotates projected tokens
            with open(self._token_file) as f:
                tok = f.read().strip()
        h: Dict[str, str] = {}
        if content_type:
            h["Content-Type"] = content_type
        if tok:
            h["Authorization"] = f"Bearer {tok}"
        return h

    # -- the one retry loop every apiserver call rides ------------------
    def _call(self, endpoint_class: str, fn: Callable, retry: bool = True):
        """Run ``fn`` under the classified retry policy + breaker.

        ``retry=False`` keeps the breaker accounting but makes one attempt
        only — for callers whose outer loop IS the retry policy (lease
        renewal, the watch reconnect loop)."""
        attempts = self.retry.budget(endpoint_class) if retry else 1
        backoff = self.retry.backoff_state()
        last: Optional[BaseException] = None
        for attempt in range(1, attempts + 1):
            if not self.breaker.allow():
                raise CircuitOpenError(
                    f"{self.api_server}: circuit breaker open "
                    f"({endpoint_class})")
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — classified right below
                kind, retry_after = classify_error(e)
                if kind == FATAL:
                    # the server answered; it is healthy — a 4xx must not
                    # trip the breaker or burn retry budget
                    self.breaker.record_success()
                    raise
                self.breaker.record_failure()
                last = e
                if attempt >= attempts:
                    raise
                delay = self.retry.delay(kind, retry_after, backoff)
                logger.warning(
                    "%s %s failed (%s, %s); retry %d/%d in %.2fs",
                    endpoint_class, self.api_server, kind, e, attempt,
                    attempts - 1, delay,
                )
                self._sleep(delay)
            else:
                self.breaker.record_success()
                return out
        raise last if last is not None else RuntimeError("unreachable")

    def get_json(self, path: str, timeout: float = 60, retry: bool = True):
        def attempt():
            req = urllib.request.Request(
                self.api_server + path, headers=self.headers()
            )
            with urllib.request.urlopen(
                req, context=self._ctx, timeout=timeout
            ) as r:
                return json.load(r)

        return self._call("read", attempt, retry=retry)

    def get_bytes(self, path: str, timeout: float = 60,
                  retry: bool = True) -> bytes:
        """Raw-bytes GET under the same ``read`` retry class — the
        replication follower's frame pull (``replicate/follower.py``);
        JSON endpoints use :meth:`get_json`."""
        def attempt():
            req = urllib.request.Request(
                self.api_server + path, headers=self.headers()
            )
            with urllib.request.urlopen(
                req, context=self._ctx, timeout=timeout
            ) as r:
                return r.read()

        return self._call("read", attempt, retry=retry)

    def stream_lines(self, path: str, timeout: float = 330):
        """Yield decoded JSON objects from a chunked watch stream. The
        CONNECT rides the policy/breaker (class ``watch``, budget 1 — the
        watch loop is the outer retry); mid-stream errors propagate to
        that loop."""
        def connect():
            req = urllib.request.Request(
                self.api_server + path, headers=self.headers()
            )
            return urllib.request.urlopen(
                req, context=self._ctx, timeout=timeout
            )

        with self._call("watch", connect) as r:
            for line in r:
                if line.strip():
                    yield json.loads(line)

    def request(self, method: str, path: str, body: Optional[dict] = None,
                timeout: float = 30,
                content_type: Optional[str] = None,
                retry: bool = True) -> None:
        if content_type is None and body is not None:
            content_type = "application/json"
        data = json.dumps(body).encode() if body is not None else None

        def attempt():
            req = urllib.request.Request(
                self.api_server + path,
                data=data,
                headers=self.headers(content_type),
                method=method,
            )
            with urllib.request.urlopen(
                req, context=self._ctx, timeout=timeout
            ) as r:
                r.read()

        self._call("write", attempt, retry=retry)
