"""Active/passive HA via a file-based lease lock, mirroring
``kube_batch_tpu/cmd/leader_election.py``'s ``LeaderElector``.  The
Kubernetes Lease elector (``K8sLeaseElector``) comes with the Kubernetes
front end; the RFC 3339 stamp helpers it uses are here already.

The reference does leader election with a ConfigMap resource lock — 15s
lease, 10s renew deadline, 5s retry, and `glog.Fatalf` (crash → standby takes
over) on lost leadership (cmd/kube-batch/app/server.go:48-52,106-151). The
standalone analog uses an atomically-renamed lease file in the
lock-object-namespace directory with the same timing constants and the same
crash-on-loss contract.

Clock discipline: the lease RECORD carries wall-clock stamps (time.time())
because other processes compare against them — that half keeps the
reference's caveat (an NTP step larger than lease_duration can open a brief
dual-leader window; deploy with slewing, not stepping). The local
renew-DEADLINE bookkeeping, though, is process-private and now runs on
time.monotonic(): a wall-clock step can no longer fake a missed renewal and
spuriously crash a healthy leader."""

from __future__ import annotations

import json
import logging
import os
import socket
import tempfile
import threading
import time
import uuid
from typing import Callable, Optional

logger = logging.getLogger("kube_batch_tpu_torch")

LEASE_DURATION = 15.0  # server.go:49
RENEW_DEADLINE = 10.0  # server.go:50
RETRY_PERIOD = 5.0     # server.go:51


class LostLeadership(RuntimeError):
    """Raised on the leader thread when renewal fails — the analog of
    `glog.Fatalf("leaderelection lost")` (server.go:145)."""


class LeaderElector:
    def __init__(
        self,
        lock_dir: str,
        identity: Optional[str] = None,
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
    ):
        self.lock_path = os.path.join(lock_dir, "kube-batch-tpu-lock")
        self._init_common(identity, lease_duration, renew_deadline, retry_period)

    def _init_common(self, identity, lease_duration, renew_deadline,
                     retry_period) -> None:
        """Identity/timing/stop state shared by every lock flavor."""
        self.identity = identity or f"{socket.gethostname()}-{uuid.uuid4().hex[:8]}"
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._stop = threading.Event()
        self._renew_thread: Optional[threading.Thread] = None

    def reset(self) -> None:
        """Re-arm a released elector so the warm-standby loop can contend
        again in the SAME process (release() set _stop to reap the renew
        thread; a fresh run() needs a clear event and no stale thread)."""
        self._stop = threading.Event()
        self._renew_thread = None

    # -- lease record ---------------------------------------------------
    def _read(self) -> Optional[dict]:
        try:
            with open(self.lock_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write(self) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.lock_path))
        with os.fdopen(fd, "w") as f:
            json.dump({"holder": self.identity, "renew_time": time.time()}, f)
        os.replace(tmp, self.lock_path)  # atomic on POSIX

    def _try_acquire_or_renew(self) -> bool:
        """The read-check-write is serialized through a short-lived O_EXCL
        claim file so two standbys can't both grab an expired lease (the
        resourcelock's apiserver-side compare-and-swap analog).

        A claim collision is retried with a short backoff before reporting
        failure: a standby briefly holding the claim file is contention, not
        a lost lease — without the retry, two coincidental collisions one
        retry_period apart could kill a healthy leader."""
        claim = self.lock_path + ".claim"
        fd = None
        for attempt in range(4):
            try:
                fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                try:  # break a claim orphaned by a crashed contender
                    if time.time() - os.path.getmtime(claim) > self.lease_duration:
                        os.unlink(claim)
                        continue
                except OSError:
                    pass
                # file-lock claim contention on local
                # disk, not an apiserver call — no transport policy applies
                time.sleep(0.05 * (attempt + 1))
        if fd is None:
            return False
        try:
            rec = self._read()
            now = time.time()
            if rec is not None and rec["holder"] != self.identity:
                if now - rec["renew_time"] < self.lease_duration:
                    return False  # current leader's lease still valid
            self._write()
            return True
        finally:
            os.close(fd)
            try:
                os.unlink(claim)
            except OSError:
                pass

    # -- run loop (leaderelection.RunOrDie analog) ----------------------
    def run(
        self,
        on_started_leading: Callable[[], None],
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        """Block until leadership is acquired, run the callback, and renew in
        the background. If renewal misses the deadline, `on_stopped_leading`
        is invoked (it must make the leading callback return — e.g.
        Scheduler.stop) and LostLeadership is raised, mirroring the
        reference's crash-on-loss (server.go:145)."""
        while not self._stop.is_set():
            if self._try_acquire_or_renew():
                break
            self._stop.wait(self.retry_period)
        if self._stop.is_set():
            return

        failure = []

        def renew_loop():
            # deadline bookkeeping is process-private → monotonic (module
            # docstring); only the lease record itself stays wall-clock
            last_renew = time.monotonic()
            while not self._stop.is_set():
                self._stop.wait(self.retry_period)
                if self._stop.is_set():
                    return
                if self._try_acquire_or_renew():
                    last_renew = time.monotonic()
                elif time.monotonic() - last_renew > self.renew_deadline:
                    failure.append(True)
                    if on_stopped_leading is not None:
                        on_stopped_leading()
                    return

        t = threading.Thread(target=renew_loop, daemon=True, name="lease-renew")
        self._renew_thread = t
        t.start()
        try:
            on_started_leading()
        finally:
            self.release()
        if failure:
            raise LostLeadership(f"{self.identity} lost the lease")

    # one K8s renew attempt is a GET + a PUT, EACH with a 10s HTTP timeout;
    # the join must outlast the pair or an in-flight renew PUT can land AFTER
    # release() vacates the lease and re-take it, delaying standby takeover
    # by a full lease_duration
    _RENEW_JOIN_TIMEOUT = 22.0

    def _join_renew(self) -> bool:
        """Stop and reap the renew thread BEFORE vacating the lock: a renew
        attempt in flight after the vacate would re-take the lease and delay
        standby takeover by a full lease_duration. Returns False when the
        thread could not be reaped within the transport timeout — callers
        must then re-check/re-vacate after it dies, or accept the risk."""
        self._stop.set()
        t = self._renew_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self._RENEW_JOIN_TIMEOUT)
            if t.is_alive():
                logger.warning(
                    "renew thread still alive after %.0fs join; a late renew "
                    "may re-take the lease", self._RENEW_JOIN_TIMEOUT)
                return False
        return True

    def is_leader(self) -> bool:
        rec = self._read()
        return (
            rec is not None
            and rec["holder"] == self.identity
            and time.time() - rec["renew_time"] < self.lease_duration
        )

    def release(self) -> None:
        joined = self._join_renew()
        self._vacate()
        if not joined and self._renew_thread is not None:
            # a straggling renew may land after the vacate and re-take the
            # lease; wait for the thread to die and vacate once more
            self._renew_thread.join(timeout=self._RENEW_JOIN_TIMEOUT)
            self._vacate()

    def _vacate(self) -> None:
        rec = self._read()
        if rec is not None and rec["holder"] == self.identity:
            try:
                os.unlink(self.lock_path)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Lease-record stamps (the Kubernetes Lease elector's wire format)
# ---------------------------------------------------------------------------


def _rfc3339_micro(ts: float) -> str:
    import datetime

    return (
        datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%f")
        + "Z"
    )


def _parse_rfc3339(s: Optional[str]) -> float:
    import datetime

    if not s:
        return 0.0
    try:
        return datetime.datetime.fromisoformat(s.replace("Z", "+00:00")).timestamp()
    except ValueError:
        return 0.0
