"""Active/passive HA, mirroring ``kube_batch_tpu/cmd/leader_election.py``:
the file-based lease lock (``LeaderElector``) and, with ``--master``, a
coordination.k8s.io Lease on the apiserver (``K8sLeaseElector``).

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
                # kbt: allow[KBT011] file-lock claim contention on local
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
# Kubernetes-native election (--master mode)
# ---------------------------------------------------------------------------

_LEASE_GROUP = "/apis/coordination.k8s.io/v1"


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


class K8sLeaseElector(LeaderElector):
    """Leader election through a coordination.k8s.io/v1 Lease — the
    cross-host resource lock the reference takes through the cluster API
    (server.go:106-151 uses the older ConfigMap resourcelock; the Lease
    object is its successor with first-class holder/renew fields). Same
    15s/10s/5s timings and crash-on-loss contract as the file elector; the
    apiserver's resourceVersion conflict (409) is the compare-and-swap the
    file elector approximates with its O_EXCL claim file.

    Like client-go, lease validity compares the apiserver-stored renewTime
    against the local clock — the file elector's NTP caveat (module
    docstring) applies unchanged."""

    def __init__(
        self,
        transport,
        namespace: str,
        name: str = "kube-batch-tpu",
        identity: Optional[str] = None,
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
    ):
        # the Lease wire format carries whole seconds (leaseDurationSeconds);
        # a sub-second duration would serialize as 0 and every contender
        # would then judge validity by its own local config — dual leader
        if lease_duration < 1.0:
            raise ValueError("k8s lease_duration must be >= 1 second")
        self.transport = transport
        self.namespace = namespace
        self.name = name
        self._init_common(identity, lease_duration, renew_deadline, retry_period)

    @property
    def _path(self) -> str:
        return f"{_LEASE_GROUP}/namespaces/{self.namespace}/leases/{self.name}"

    def _get(self) -> Optional[dict]:
        import urllib.error

        try:
            # retry=False: the elector's retry_period loop IS the retry
            # policy — in-call retries would stretch a renew attempt past
            # the renew deadline (and the _RENEW_JOIN_TIMEOUT math)
            return self.transport.get_json(self._path, timeout=10,
                                           retry=False)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def _try_acquire_or_renew(self) -> bool:
        """One acquire/renew attempt (leaderelection.go tryAcquireOrRenew):
        create if absent, take over if expired, renew if held — every write
        CAS-guarded by resourceVersion (a 409 means another contender won
        the race; report failure and retry next period). Transport errors
        also report failure: an unreachable apiserver must run the renew
        deadline down, not crash the standby loop."""
        import urllib.error

        now = time.time()
        spec_new = {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(round(self.lease_duration)),
            "renewTime": _rfc3339_micro(now),
        }
        try:
            obj = self._get()
            if obj is None:
                spec_new["acquireTime"] = spec_new["renewTime"]
                spec_new["leaseTransitions"] = 0
                self.transport.request(
                    "POST",
                    f"{_LEASE_GROUP}/namespaces/{self.namespace}/leases",
                    {
                        "apiVersion": "coordination.k8s.io/v1",
                        "kind": "Lease",
                        "metadata": {"name": self.name,
                                     "namespace": self.namespace},
                        "spec": spec_new,
                    },
                    timeout=10, retry=False,
                )
                return True
            spec = obj.get("spec") or {}
            holder = spec.get("holderIdentity")
            duration = float(spec.get("leaseDurationSeconds")
                             or self.lease_duration)
            if (
                holder
                and holder != self.identity
                and now - _parse_rfc3339(spec.get("renewTime")) < duration
            ):
                return False  # current leader's lease still valid
            if holder == self.identity:  # renewal
                spec_new["acquireTime"] = (
                    spec.get("acquireTime") or spec_new["renewTime"]
                )
                spec_new["leaseTransitions"] = int(
                    spec.get("leaseTransitions") or 0
                )
            else:  # takeover of an expired or vacated lease
                spec_new["acquireTime"] = spec_new["renewTime"]
                spec_new["leaseTransitions"] = int(
                    spec.get("leaseTransitions") or 0
                ) + 1
            obj["spec"] = spec_new
            self.transport.request("PUT", self._path, obj, timeout=10,
                                   retry=False)
            return True
        except urllib.error.HTTPError as e:
            if e.code == 409:
                return False  # lost the CAS race
            logger.warning("lease %s write failed: %s", self.name, e)
            return False
        except OSError as e:
            logger.warning("lease %s unreachable: %s", self.name, e)
            return False

    def is_leader(self) -> bool:
        try:
            obj = self._get()
        except OSError:
            return False
        if obj is None:
            return False
        spec = obj.get("spec") or {}
        duration = float(spec.get("leaseDurationSeconds") or self.lease_duration)
        return (
            spec.get("holderIdentity") == self.identity
            and time.time() - _parse_rfc3339(spec.get("renewTime")) < duration
        )

    def _vacate(self) -> None:
        """Vacate the lease on clean shutdown (client-go ReleaseOnCancel
        clears holderIdentity) so a standby can take over immediately.
        The renew thread is reaped FIRST (base-class release) — an in-flight
        renew landing after the vacate would re-take the lease; its CAS bump
        also explains the one 409 retry here."""
        import urllib.error

        for _ in range(2):
            try:
                obj = self._get()
                if obj is None:
                    return
                spec = obj.get("spec") or {}
                if spec.get("holderIdentity") != self.identity:
                    return
                spec["holderIdentity"] = ""
                obj["spec"] = spec
                self.transport.request("PUT", self._path, obj, timeout=10,
                                       retry=False)
                return
            except urllib.error.HTTPError as e:
                if e.code == 409:
                    continue  # lost a CAS race — re-GET and retry once
                return  # best-effort; the lease simply expires
            except OSError:
                return
