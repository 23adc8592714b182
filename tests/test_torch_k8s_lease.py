"""The port's Kubernetes Lease elector (``kube_batch_tpu_torch/cmd/
leader_election.py`` ``K8sLeaseElector``) against the JAX package's, on
``tests/test_server.py``'s ``_LeaseStub`` (a coordination.k8s.io Lease
apiserver with resourceVersion compare-and-swap): one leader at a time and
the standby's takeover on release, takeover after expiry, a stale write
losing the CAS, ``LostLeadership`` when the lease is usurped, whole-second
durations, an unreachable apiserver reported as a failed attempt — and the
Lease each package writes at every step equal to the other's, holder
stamps aside.  Then the ``--master --leader-elect`` server (plain and
warm standby) holding its Lease on the port's stub apiserver while it
schedules, and vacating it on stop."""

from __future__ import annotations

import threading
import time

import pytest

import kube_batch_tpu.cmd.leader_election as jax_le
import kube_batch_tpu.k8s.transport as jax_transport
import kube_batch_tpu_torch.cmd.leader_election as port_le
import kube_batch_tpu_torch.k8s.transport as port_transport

from test_server import _LeaseStub
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

PKGS = {"jax": (jax_le, jax_transport), "port": (port_le, port_transport)}
STAMPS = ("renewTime", "acquireTime")


def _elector(pkg: str, url: str, ident: str, **kw):
    le, tr = PKGS[pkg]
    # whole seconds: the Lease wire format is leaseDurationSeconds
    kw.setdefault("lease_duration", 1.0)
    kw.setdefault("renew_deadline", 0.75)
    kw.setdefault("retry_period", 0.1)
    return le.K8sLeaseElector(tr.ApiTransport(url), namespace="kube-system",
                              identity=ident, **kw)


def _lease(stub):
    obj = stub.store.get("kube-batch-tpu")
    if obj is None:
        return None
    spec = {k: v for k, v in obj["spec"].items() if k not in STAMPS}
    return dict(obj, spec=spec)


def test_lease_bodies_equal_step_by_step():
    """The same acquire / renew / takeover / vacate steps on two stubs, one
    per package: the same answers and the same stored Lease after each
    step (the stamps left out; they are the clock's)."""
    stubs = {pkg: _LeaseStub() for pkg in PKGS}
    try:
        el = {pkg: {who: _elector(pkg, stubs[pkg].url, f"host-{who}") for who in "ab"}
              for pkg in PKGS}
        trail = {pkg: [] for pkg in PKGS}

        def step(fn):
            for pkg in PKGS:
                trail[pkg].append((fn(el[pkg]), _lease(stubs[pkg])))

        step(lambda e: e["a"]._try_acquire_or_renew())   # a creates the Lease
        step(lambda e: e["b"]._try_acquire_or_renew())   # valid → b fails
        step(lambda e: e["a"]._try_acquire_or_renew())   # a renews
        step(lambda e: (e["a"].is_leader(), e["b"].is_leader()))
        time.sleep(1.1)                                  # a dies; the lease expires
        step(lambda e: e["b"]._try_acquire_or_renew())   # b takes over
        step(lambda e: e["a"]._try_acquire_or_renew())   # a lost it
        step(lambda e: e["b"]._vacate())                 # b vacates
        step(lambda e: e["a"]._try_acquire_or_renew())   # a takes the vacated lease
        assert trail["port"] == trail["jax"]
        answers = [t[0] for t in trail["port"]]
        assert answers == [True, False, True, (True, False), True, False, None, True]
        final = trail["port"][-1][1]["spec"]
        assert final["holderIdentity"] == "host-a" and final["leaseTransitions"] == 2
        assert final["leaseDurationSeconds"] == 1
        assert trail["port"][0][1]["metadata"] == {"name": "kube-batch-tpu",
                                                   "namespace": "kube-system",
                                                   "resourceVersion": "1"}
    finally:
        for s in stubs.values():
            s.shutdown()


def test_single_leader_and_failover():
    """Two electors on different hosts (no shared filesystem, only the
    apiserver): one leads, the standby blocks while the lease is valid, the
    release hands over (server.go:106-151 semantics)."""
    stub = _LeaseStub()
    try:
        a = _elector("port", stub.url, "host-a")
        b = _elector("port", stub.url, "host-b")
        order = []

        def lead(elector, name, hold):
            def body():
                order.append(name)
                time.sleep(hold)
            elector.run(body)

        ta = threading.Thread(target=lead, args=(a, "host-a", 0.6), daemon=True)
        ta.start()
        time.sleep(0.25)
        assert a.is_leader() and not b.is_leader()
        tb = threading.Thread(target=lead, args=(b, "host-b", 0.2), daemon=True)
        tb.start()
        time.sleep(0.2)
        assert order == ["host-a"]
        ta.join(4)
        tb.join(4)
        assert not ta.is_alive() and not tb.is_alive()
        assert order == ["host-a", "host-b"]
        spec = stub.store["kube-batch-tpu"]["spec"]
        assert spec["holderIdentity"] == "" and spec["leaseTransitions"] >= 1
    finally:
        stub.shutdown()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_stale_write_loses_the_cas(pkg):
    """A PUT carrying a stale resourceVersion is a 409: the attempt reports
    failure, never a split brain."""
    stub = _LeaseStub()
    try:
        a = _elector(pkg, stub.url, "host-a")
        assert a._try_acquire_or_renew()
        real_get = a._get

        def stale_get():
            obj = real_get()
            obj["metadata"]["resourceVersion"] = "0"
            return obj

        a._get = stale_get
        writes = stub.writes
        assert a._try_acquire_or_renew() is False
        assert stub.writes == writes
        assert stub.store["kube-batch-tpu"]["spec"]["holderIdentity"] == "host-a"
    finally:
        stub.shutdown()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_usurped_lease_raises_lost_leadership(pkg):
    """Another holder takes the Lease: renewals fail past the renew
    deadline, ``on_stopped_leading`` runs and ``run`` raises
    ``LostLeadership`` (the crash-on-loss contract, server.go:145)."""
    le, _tr = PKGS[pkg]
    stub = _LeaseStub()
    try:
        a = _elector(pkg, stub.url, "host-a")
        stop = threading.Event()
        stopped = []
        raised = []

        def body():
            obj = stub.store["kube-batch-tpu"]
            obj["spec"] = dict(obj["spec"], holderIdentity="usurper",
                               renewTime=le._rfc3339_micro(time.time() + 30))
            obj["metadata"]["resourceVersion"] = str(
                int(obj["metadata"]["resourceVersion"]) + 1)
            stop.wait(5)

        def run():
            try:
                a.run(body, on_stopped_leading=lambda: (stopped.append(1), stop.set()))
            except le.LostLeadership as e:
                raised.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(8)
        assert not t.is_alive() and stopped == [1] and len(raised) == 1
        # the release vacates nothing it does not hold
        assert stub.store["kube-batch-tpu"]["spec"]["holderIdentity"] == "usurper"
    finally:
        stub.shutdown()


def test_sub_second_duration_rejected_and_unreachable_fails():
    for pkg in PKGS:
        with pytest.raises(ValueError):
            _elector(pkg, "http://x", "a", lease_duration=0.4)
        e = _elector(pkg, "http://127.0.0.1:1", "host-x")  # nothing listens
        assert e._try_acquire_or_renew() is False and e.is_leader() is False


# ---------------------------------------------------------------------------
# the --master server behind its Lease
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warm", [False, True], ids=["crash_on_loss", "warm_standby"])
def test_master_server_holds_its_lease_while_it_schedules(warm):
    from kube_batch_tpu_torch.testing.e2e import (
        Cluster, StubApiServer, namespace_of, scenario_gang, scheduler_thread)

    stub = StubApiServer()
    master = stub.start()
    args = ["--leader-elect", "--lock-object-namespace", "kube-system"]
    if warm:
        args.append("--leader-warm-standby")
    try:
        with scheduler_thread(master, extra_args=args, device="cpu") as server:
            c = Cluster(master)
            ns = namespace_of("gang")
            c.ensure_namespace(ns)
            scenario_gang(c, ns)
            lease = stub._store["leases"]["kube-system/kube-batch-tpu"]
            assert lease["spec"]["holderIdentity"]
            assert lease["spec"]["leaseDurationSeconds"] == 15
        # the loop stopped: the elector vacated its Lease on the way out
        assert stub._store["leases"]["kube-system/kube-batch-tpu"]["spec"][
            "holderIdentity"] == ""
    finally:
        stub.stop()
    assert server.watcher.join(10)
