"""The port's Kubernetes JSON translation (``kube_batch_tpu_torch/k8s/
translate.py``) against the JAX package's: every recorded object of
``tests/fixtures_k8s/objects.json`` and every inline object of
``tests/test_k8s_shim.py`` through both packages' translate functions,
compared field by field (enums by value); ``parse_quantity`` over a table
of suffixes and, with hypothesis, over mantissas; ``creation_index_of``
over timestamp forms; the node-selector matcher and the PV node-affinity
pin, which fail closed; the volume ingest seam (a binder without a method
drops loudly and once, the fakes are complete and silent).  Then the chip
drive's Kubernetes JSON writers: ``translate(to_k8s(x)) == x`` for the
synthetic cluster's objects and the headline arrivals, and the CRDs the
port's e2e applies equal to ``deployment/crds/``."""

from __future__ import annotations

import dataclasses
import enum
import glob
import json
import logging
import os
import re

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

import kube_batch_tpu.k8s.translate as jax_translate
import kube_batch_tpu_torch.k8s.translate as port_translate
from kube_batch_tpu.api import pod as jax_pod
from kube_batch_tpu_torch.api import pod as port_pod
from kube_batch_tpu_torch.testing import k8s_drive

import test_k8s_shim as shim
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

MODS = (jax_translate, port_translate)
FIXTURES = shim.FIXTURES
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fixture key → the translate function that reads it
READER = {
    "pod_full": "pod_from_k8s", "pod_bound": "pod_from_k8s", "node": "node_from_k8s",
    "podgroup": "pod_group_from_k8s", "queue": "queue_from_k8s",
    "priorityclass": "priority_class_from_k8s", "pdb": "pdb_from_k8s",
    "pv_local": "pv_from_k8s", "pvc_unbound": "pvc_from_k8s", "pvc_dynamic": "pvc_from_k8s",
}


AUTO_UID = re.compile(r"(pod|pg|queue)-.+-\d+")


def canon(x):
    """A package-neutral value: dataclasses as (class name, fields), enums
    by value, containers element by element (their types kept), and a uid
    the constructor generated masked (each package counts its own)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: "<auto>" if f.name == "uid" and isinstance(getattr(x, f.name), str)
                 and AUTO_UID.fullmatch(getattr(x, f.name)) else canon(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(canon(v) for v in x)
    return x


def both(fn_name: str, *args):
    """``fn_name(*args)`` through both packages; the results must be equal."""
    got = [canon(getattr(m, fn_name)(*args)) for m in MODS]
    assert got[0] == got[1], (fn_name, got)
    return got[1]


# ---------------------------------------------------------------------------
# every object the JAX tests translate
# ---------------------------------------------------------------------------


def _inline_objects():
    """(name, translate function, object) of tests/test_k8s_shim.py's
    inline objects and derived pods."""
    out = [("gang_pod_%d" % i, "pod_from_k8s", shim._gang_pod(i)) for i in range(4)]
    out += [("pvc_pod", "pod_from_k8s", shim._pvc_pod("stateful-1", "train-data")),
            ("pdb_pct", "pdb_from_k8s", {"metadata": {"name": "pct"},
                                         "spec": {"minAvailable": "50%"}}),
            ("default_queue", "queue_from_k8s", shim.TestVolumeK8sMode.DEFAULT_QUEUE),
            ("bare_queue", "queue_from_k8s", {"metadata": {"name": "default"},
                                              "spec": {"weight": 1}})]
    done = json.loads(json.dumps(FIXTURES["pod_bound"]))
    done["status"]["phase"] = "Succeeded"
    cordoned = json.loads(json.dumps(FIXTURES["node"]))
    cordoned["spec"]["unschedulable"] = True
    out += [("pod_succeeded", "pod_from_k8s", done), ("node_cordoned", "node_from_k8s", cordoned)]
    pv = shim.TestPvNodeAffinityFailClosed._pv
    affinities = {
        "none": None,
        "hostname": {"required": {"nodeSelectorTerms": [{"matchExpressions": [
            {"key": "kubernetes.io/hostname", "operator": "In", "values": ["node-b"]}]}]}},
        "metadata_name": {"required": {"nodeSelectorTerms": [{"matchExpressions": [
            {"key": "metadata.name", "operator": "In", "values": ["node-c"]}]}]}},
        "match_fields": {"required": {"nodeSelectorTerms": [{"matchFields": [
            {"key": "metadata.name", "operator": "In", "values": ["node-d"]}]}]}},
        "zonal": shim.TestPvTopologyAffinity.ZONAL_AFF,
        "two_hosts": {"required": {"nodeSelectorTerms": [{"matchExpressions": [
            {"key": "kubernetes.io/hostname", "operator": "In",
             "values": ["node-a", "node-b"]}]}]}},
        "pin_and_zone": {"required": {"nodeSelectorTerms": [{"matchExpressions": [
            {"key": "kubernetes.io/hostname", "operator": "In", "values": ["n1"]},
            {"key": "topology.kubernetes.io/zone", "operator": "In", "values": ["z1"]}]}]}},
        "empty_terms": {"required": {"nodeSelectorTerms": [{}]}},
    }
    out += [(f"pv_{k}", "pv_from_k8s", pv(v)) for k, v in affinities.items()]
    out += [(f"pvc_{n}", "pvc_from_k8s", {"metadata": {"name": n, "namespace": "ml"},
                                          "spec": {"storageClassName": "local-ssd"},
                                          "status": {"phase": "Pending"}})
            for n in ("zonal-data", "dual", "c")]
    return out


@pytest.mark.parametrize("key", sorted(READER))
def test_fixture_objects(key):
    both(READER[key], FIXTURES[key])


@pytest.mark.parametrize("name,fn,obj", _inline_objects(), ids=lambda v: v if isinstance(v, str) else "")
def test_inline_objects(name, fn, obj):
    both(fn, obj)


def test_fixture_expectations_hold_on_the_port():
    """The JAX tests' field readings (tests/test_k8s_shim.py TestTranslation)."""
    t = port_translate
    pod = t.pod_from_k8s(FIXTURES["pod_full"])
    assert pod.requests["cpu"] == 750.0 and pod.init_requests["cpu"] == 2000.0
    assert pod.owner == "job-uid-123" and pod.volume_claims == ("train-data",)
    assert pod.affinity.node_terms == [[("zone", "In", ("us-central1-a",))]]
    node = t.node_from_k8s(FIXTURES["node"])
    assert node.allocatable["cpu"] == 31900.0 and node.conditions == {
        "MemoryPressure": False, "DiskPressure": False}
    assert t.pdb_from_k8s({"metadata": {"name": "pct"}, "spec": {"minAvailable": "50%"}}) is None
    pv = t.pv_from_k8s(shim.TestPvNodeAffinityFailClosed._pv(
        shim.TestPvTopologyAffinity.ZONAL_AFF))
    assert pv.node == t.PV_NODE_RESTRICTED_UNKNOWN == jax_translate.PV_NODE_RESTRICTED_UNKNOWN


def test_affinity_terms():
    """Required, preferred and weighted pod (anti-)affinity terms, and a
    stanza that parses to no term (None, as the reference's open selector)."""
    aff = {
        "nodeAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": {"nodeSelectorTerms": [
                {"matchExpressions": [{"key": "zone", "operator": "NotIn", "values": ["b"]}],
                 "matchFields": [{"key": "metadata.name", "operator": "In", "values": ["n1"]}]},
                {"matchExpressions": [{"key": "gpu", "operator": "Exists"}]}]},
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 7, "preference": {"matchExpressions": [
                    {"key": "disk", "operator": "In", "values": ["ssd"]}]}}]},
        "podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "db"}}, "topologyKey": "zone"}],
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 3, "podAffinityTerm": {"labelSelector": {
                    "matchLabels": {"app": "cache"}}}}]},
        "podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "web"}}}],
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 2, "podAffinityTerm": {"labelSelector": {
                    "matchLabels": {"tier": "front"}}, "topologyKey": "rack"}}]},
    }
    pod = {"metadata": {"name": "a"}, "spec": {"affinity": aff}}
    got = both("pod_from_k8s", pod)
    assert got[1]["affinity"] is not None
    for empty in ({}, {"nodeAffinity": {}}, {"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": []}}):
        got = both("pod_from_k8s", {"metadata": {"name": "a"}, "spec": {"affinity": empty}})
        assert got[1]["affinity"] is None


# ---------------------------------------------------------------------------
# quantities and timestamps
# ---------------------------------------------------------------------------

QUANTITIES = ["100m", "500u", "50n", "2", "1Gi", "500Mi", "2G", "1e3", "1.5Gi", "0.1",
              "0.5", "1k", "3M", "4T", "1P", "2E", "7Ki", "9Ti", "1Pi", "1Ei", "1.25",
              "  250m ", "", "1E3", "12e-3", "0", "-1", ".5", "5.", 4, 2.5, 0]


@pytest.mark.parametrize("q", QUANTITIES)
def test_parse_quantity_table(q):
    want = jax_translate.parse_quantity(q)
    got = port_translate.parse_quantity(q)
    assert got == want and type(got) is type(want) is float


@pytest.mark.parametrize("bad", ["not-a-quantity", "1.2.3m", "Gi", "m"])
def test_parse_quantity_rejects_what_the_jax_package_rejects(bad):
    for m in MODS:
        with pytest.raises(ValueError):
            m.parse_quantity(bad)


@settings(max_examples=300, deadline=None)
@given(mantissa=st.one_of(
    st.integers(min_value=0, max_value=10**15).map(str),
    st.decimals(min_value=0, max_value=10**9, places=6, allow_nan=False,
                allow_infinity=False).map(str),
    st.floats(min_value=0, max_value=1e12, allow_nan=False).map(repr)),
    suffix=st.sampled_from(["", "n", "u", "m", "k", "M", "G", "T", "P", "E",
                            "Ki", "Mi", "Gi", "Ti", "Pi", "Ei"]))
def test_parse_quantity_mantissas(mantissa, suffix):
    q = mantissa + suffix
    outs = []
    for m in MODS:
        try:
            outs.append(("ok", m.parse_quantity(q)))
        except ValueError:
            outs.append(("error", None))
    assert outs[0] == outs[1], q


@pytest.mark.parametrize("ts", [
    None, "", "2026-07-29T10:15:30Z", "2026-07-29T10:15:30.999999Z",
    "2026-07-29T10:15:30+02:00", "1970-01-01T00:00:00Z", "1969-12-31T23:59:59.5Z",
    "2026-07-29", "2026-07-29T10:15:30", "yesterday", "2026-13-01T00:00:00Z"])
def test_creation_index_of(ts):
    meta = {} if ts is None else {"creationTimestamp": ts}
    assert port_translate.creation_index_of(meta) == jax_translate.creation_index_of(meta)


@pytest.mark.parametrize("meta", [
    {}, {"ownerReferences": []},
    {"ownerReferences": [{"name": "rs", "uid": "u1", "controller": True}]},
    {"ownerReferences": [{"name": "rs", "controller": True}]},
    {"ownerReferences": [{"name": "a", "uid": "u0"}, {"name": "b", "uid": "u2",
                                                      "controller": True}]}])
def test_controller_uid(meta):
    assert port_translate._controller_uid(meta) == jax_translate._controller_uid(meta)


# ---------------------------------------------------------------------------
# fail-closed matchers
# ---------------------------------------------------------------------------

TERMS = [
    ((("zone", "In", ("a",)), ("disk", "In", ("ssd",))), (("region", "In", ("r1",)),)),
    ((("gpu", "Exists", ()),),), ((("gpu", "DoesNotExist", ()),),),
    ((("slots", "Gt", ("4",)),),), ((("slots", "Lt", ("4",)),),),
    ((("slots", "Gt", ("x",)),),), ((("zone", "Near", ("a",)),),),
    ((("zone", "NotIn", ("z1",)),),), (),
]
LABELS = [{}, {"zone": "a", "disk": "ssd"}, {"region": "r1"}, {"zone": "a", "disk": "hdd"},
          {"gpu": "1"}, {"slots": "8"}, {"slots": "2"}, {"slots": "four"}, {"zone": "z1"}]


@pytest.mark.parametrize("terms", TERMS)
def test_node_selector_terms_match(terms):
    for labels in LABELS:
        assert (port_pod.node_selector_terms_match(terms, labels)
                == jax_pod.node_selector_terms_match(terms, labels)), (terms, labels)


@pytest.mark.parametrize("spec", [
    {}, {"nodeAffinity": {}}, {"nodeAffinity": {"required": {}}},
    {"nodeAffinity": {"required": {"nodeSelectorTerms": [{}]}}},
    {"nodeAffinity": {"required": {"nodeSelectorTerms": [{"matchExpressions": [
        {"key": "kubernetes.io/hostname", "operator": "NotIn", "values": ["a"]}]}]}}},
    {"nodeAffinity": {"required": {"nodeSelectorTerms": [{"matchExpressions": [
        {"key": "kubernetes.io/hostname", "operator": "In", "values": []}]}]}}},
    {"nodeAffinity": {"required": {"nodeSelectorTerms": [
        {"matchExpressions": [{"key": "zone", "operator": "In", "values": ["z"]}]},
        {"matchFields": [{"key": "metadata.name", "operator": "In", "values": ["n9"]}]}]}}},
])
def test_pv_node_affinity(spec):
    assert (canon(port_translate._pv_node_affinity(spec))
            == canon(jax_translate._pv_node_affinity(spec)))


# ---------------------------------------------------------------------------
# the volume ingest seam
# ---------------------------------------------------------------------------


def test_missing_method_warns_once_and_does_not_raise(caplog):
    from kube_batch_tpu_torch.cache.cache import SchedulerCache
    from kube_batch_tpu_torch.cache.volume import StandalonePVBinder

    cache = SchedulerCache(volume_binder=StandalonePVBinder())
    try:
        assert not hasattr(cache.volume_binder, "add_pvc")
        port_translate._MISSING_INGEST_WARNED.clear()
        with caplog.at_level(logging.WARNING, logger="kube_batch_tpu_torch"):
            port_translate.apply_event(cache, "persistentvolumeclaims", "ADDED",
                                       FIXTURES["pvc_unbound"])
            port_translate.apply_event(cache, "persistentvolumeclaims", "ADDED",
                                       FIXTURES["pvc_dynamic"])
        drops = [r for r in caplog.records if "has no add_pvc" in r.message]
        assert len(drops) == 1 and "dropping" in drops[0].message
    finally:
        cache.stop()


@pytest.mark.parametrize("ledger", ["k8s", "fake"])
def test_complete_binders_take_the_dispatch_silently(ledger, caplog):
    from kube_batch_tpu_torch.cache.cache import SchedulerCache
    from kube_batch_tpu_torch.cache.volume import K8sPVLedger

    cache = SchedulerCache(volume_binder=K8sPVLedger() if ledger == "k8s" else None)
    try:
        with caplog.at_level(logging.WARNING, logger="kube_batch_tpu_torch"):
            for kind, key in (("persistentvolumeclaims", "pvc_unbound"),
                              ("storageclasses", "storageclass_local"),
                              ("persistentvolumes", "pv_local")):
                port_translate.apply_event(cache, kind, "ADDED", FIXTURES[key])
            if ledger == "fake":
                for kind, key in (("persistentvolumeclaims", "pvc_unbound"),
                                  ("storageclasses", "storageclass_local"),
                                  ("persistentvolumes", "pv_local")):
                    port_translate.apply_event(cache, kind, "DELETED", FIXTURES[key])
        assert not [r for r in caplog.records if "has no " in r.message]
        vb = cache.volume_binder
        stored = (vb.pvs, vb.claims, vb.storage_classes)
        assert all(stored) if ledger == "k8s" else stored == ({}, {}, {})
    finally:
        cache.stop()


def test_unknown_kind_is_ignored(caplog):
    from kube_batch_tpu_torch.cache.cache import SchedulerCache

    cache = SchedulerCache()
    try:
        with caplog.at_level(logging.WARNING, logger="kube_batch_tpu_torch"):
            port_translate.apply_event(cache, "deployments", "ADDED", {"metadata": {}})
        assert [r for r in caplog.records if "unknown watch kind" in r.message]
    finally:
        cache.stop()


# ---------------------------------------------------------------------------
# the chip drive's writers, and the CRDs
# ---------------------------------------------------------------------------


def test_to_k8s_round_trips_the_synthetic_cluster():
    """``translate(to_k8s(x)) == x`` for every object of
    ``synthetic_cluster`` (the k8s drive's preload) and of the headline
    arrivals, in both packages' translate."""
    from kube_batch_tpu_torch.testing.cycle_drive import GANG, N_QUEUES
    from kube_batch_tpu_torch.testing.synthetic import synthetic_cluster

    src = synthetic_cluster(512, 64, gang_size=GANG, n_queues=N_QUEUES, seed=0,
                            host_ports_frac=0.1)
    try:
        pairs = ([(q.queue, k8s_drive.queue_to_k8s, "queue_from_k8s")
                  for q in src.queues.values()]
                 + [(n.node, k8s_drive.node_to_k8s, "node_from_k8s")
                    for n in src.nodes.values()]
                 + [(j.pod_group, k8s_drive.pod_group_to_k8s, "pod_group_from_k8s")
                    for j in src.jobs.values()]
                 + [(p, k8s_drive.pod_to_k8s, "pod_from_k8s") for p in src.pods.values()])
        queues = sorted(src.queues)
    finally:
        src.stop()
    arrivals = k8s_drive.arrival_objects(queues, 64)
    assert len(pairs) == 3 + 64 + 128 + 512
    for obj, write, read in pairs:
        assert canon(getattr(port_translate, read)(write(obj))) == canon(obj)
        both(read, write(obj))
    for kind, read in (("podgroups", "pod_group_from_k8s"), ("pods", "pod_from_k8s")):
        for obj in arrivals[kind]:
            got = both(read, obj)
            assert got[1]["creation_index"] >= 10**6
    assert arrivals["podgroups"][0]["spec"]["minResources"]


@pytest.mark.parametrize("value,name,text", [
    (250.0, "cpu", "250m"), (5750.0, "cpu", "5750m"), (1.5, "cpu", "0.0015"),
    (2.0**30, "memory", "1073741824"), (110.0, "pods", "110"), (2000.0, "nvidia.com/gpu", "2000m"),
])
def test_quantity_writer(value, name, text):
    assert k8s_drive._quantity(name, value) == text
    scale = 1.0 if name in ("memory", "pods") else 1000.0
    assert port_translate.parse_quantity(text) * scale == value


def test_crds_json_is_the_deployment_yaml():
    from kube_batch_tpu_torch.testing.e2e import CRDS_PATH

    with open(CRDS_PATH) as f:
        rendered = json.load(f)
    want = [yaml.safe_load(open(p))
            for p in sorted(glob.glob(os.path.join(REPO, "deployment", "crds", "*.yaml")))]
    assert rendered == want and len(want) == 2
