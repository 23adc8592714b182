"""The port's device-program audits held to the JAX package's tiers B and
C: the same rule ids, an entry for every JAX entry (single-device and
sharded, through ``NAME_MAP`` where the port's function has another
name), the same shape ladder field for field, the same steady flags, and
the same KBT202 verdict for every single-device entry at the port's audit
point, whose extents are distinct.  Only numpy crosses between the
packages; the JAX side is traced abstractly (``hbm_audit.audit_entry_at``),
never run, and ``jaxpr_audit.run_audit`` is not called: it needs
``jax.experimental.enable_x64``, which this jax lacks."""

from __future__ import annotations

import dataclasses
import gc

import jax
import pytest

from kube_batch_tpu.analysis import hbm_audit as jax_hbm
from kube_batch_tpu.analysis import jaxpr_audit as jax_b
from kube_batch_tpu_torch.analysis import memory_audit, program_audit
from kube_batch_tpu_torch.parallel.mesh import make_mesh
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

#: JAX entry name → the port's, where the port's function is named otherwise
NAME_MAP = {
    "ops.pallas_kernels.masked_best_node": "ops.kernels.masked_best_node_raw",
    "ops.pallas_kernels.masked_topk_blocks": "ops.kernels.masked_topk_blocks",
    "ops.invariants.enqueue_gate_sentinel": "ops.invariants.enqueue_gate_sentinel_solve",
    "parallel.mesh.sharded_enqueue_gate": "parallel.mesh.dispatch_enqueue_gate",
}

#: single-device entries whose KBT202 verdict differs from the JAX one, with
#: the reason (ROADMAP.md Queue 3 lists each)
KBT202_DIFFERS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """Clear the JAX package's compiled executables before and after the
    module, as the other JAX-heavy port modules do."""
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()


def _port_name(jax_name: str) -> str:
    return NAME_MAP.get(jax_name, jax_name)


def _pairs(jax_entries, port_entries):
    by = {e.name: e for e in port_entries}
    return [(j, by.get(_port_name(j.name))) for j in jax_entries]


def test_rule_ids_are_the_jax_packages():
    assert set(program_audit.AUDIT_RULES) == set(jax_b.AUDIT_RULES)
    assert set(memory_audit.HBM_RULES) == set(jax_hbm.HBM_RULES)


def test_every_jax_entry_has_its_port_entry_with_the_same_steady_flag():
    single = _pairs(jax_b.REGISTRY, program_audit.REGISTRY)
    sharded = _pairs(jax_b.sharded_registry(),
                     program_audit.sharded_registry(make_mesh(["cpu"] * 8)))
    missing = [j.name for j, p in single + sharded if p is None]
    assert missing == []
    flags = [(j.name, j.steady, p.steady) for j, p in single + sharded if j.steady != p.steady]
    assert flags == []
    # and nothing the JAX package lacks
    assert len(program_audit.REGISTRY) == len(jax_b.REGISTRY)


def test_the_shape_ladder_is_the_jax_packages():
    """Every JAX field equal; the port's one extra field, the noise floor,
    is the JAX tier's fixed 256 on the ladder."""
    jax_fields = [f.name for f in dataclasses.fields(jax_b.ShapePoint)]
    port, ref = memory_audit.shape_points(), jax_hbm.shape_points()
    assert [p.name for p in port] == [r.name for r in ref]
    for p, r in zip(port, ref):
        assert {f: getattr(p, f) for f in jax_fields} == dataclasses.asdict(r)
        assert p.floor == 256


def _jax_point(sp):
    jax_fields = {f.name for f in dataclasses.fields(jax_b.ShapePoint)}
    return jax_b.ShapePoint(**{k: v for k, v in dataclasses.asdict(sp).items()
                               if k in jax_fields})


def test_kbt202_verdicts_equal_at_the_audit_point():
    """Per single-device entry: the port's program makes a task × node
    plane at the audit point exactly where the JAX program's trace does
    (steady entries only, as the JAX tier judges)."""
    sp = program_audit.AUDIT_POINT
    assert sp.floor < 256  # the port reads the shards' widths as node axes too
    jsp = _jax_point(sp)
    runs: dict = {}
    verdicts = {}
    for j, p in _pairs(jax_b.REGISTRY, program_audit.REGISTRY):
        want = "KBT202" in [r for r, _m in jax_hbm.audit_entry_at(j, jsp).findings]
        rep = memory_audit.audit_entry_at(p, sp, "cpu", runs=runs)
        assert rep.traced, (p.name, rep.findings)
        got = "KBT202" in [r for r, _m in rep.findings]
        verdicts[p.name] = (want, got)
    differ = {k: v for k, v in verdicts.items() if v[0] != v[1]}
    assert differ.keys() == KBT202_DIFFERS.keys(), differ
    # the verdicts are not vacuous: the compacted, warm and eviction
    # programs make planes in both packages, the gate and the scatter none
    assert verdicts["ops.assignment.allocate_topk_solve"] == (True, True)
    assert verdicts["ops.eviction.evict_solve[reclaim]"] == (True, True)
    assert verdicts["ops.admission.enqueue_gate"] == (False, False)
