"""The port's analyzer: the four tiers of the JAX package's
``kube_batch_tpu/analysis``, each in the port's own copy, and its runtime
lock checker.

Tier A (``engine``, ``dataflow``, ``rules``, ``flowrules``): AST and flow
rules over the package's source — KBT001 wall clock outside the clock
seam, KBT002 blocking call under a lock, KBT003 module-level mutable state
in actions/framework, KBT004 fail-open translate default, KBT005
host-device sync in ops/ (the torch idiom: ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``np.asarray``, ``int()``/``float()``, torch
dispatch in a Python loop — a bidding-round loop that reads back through
``utils.seams.round_end`` is governed by tier B's per-round budget
instead), KBT008 fail-open seam probe, KBT009 telemetry clock in control
flow, KBT010 host-device sync on a device-resident value in the action
layer (the port's solves and torch's syncs, ``.to("cpu")`` included),
KBT011 raw urllib or an ad-hoc retry loop, KBT013 solve dispatch without a
sentinel consumer, KBT014 span discipline.  KBT006 (use after donation)
and KBT007 (jit retrace hazard) name JAX idioms — ``donate_argnums`` and
``jax.jit`` wrappers — that the port does not have, and stay dropped.
Suppression: ``# kbt: allow[KBTxxx] reason`` on the line or the line
above; an allow without a reason is itself a KBT000.

Tier D (``races``): thread-root graph and per-class lock-domain inference
— KBT301 access off the domain lock, KBT302 live container handed to
another thread (KBT012 is its alias), KBT303 check-then-act, KBT304 racy
lazy init; ``domains_report`` is the map, ``runtime_domain_specs`` feeds
the corroborator.

The lock checker (``lockdep``) instruments the locks of the port's
concurrent modules at run time: order inversions (transitive), blocking
under a lock, undeclared same-site nesting, the per-site wait and hold
profile, and the guarded-access corroborator over tier D's domains;
``pytest_plugin.port_lockdep`` runs every port test module under it.
``utils/blocking.py`` holds the runtime annotations (``allow_blocking``,
``allow_nesting``, ``allow_unguarded``).

Tiers B and C are the device-program audits, for programs that run on a
card rather than programs that are traced for one.

Every registered device program (``program_audit.REGISTRY``, and
``sharded_registry(mesh)`` for the multi-device solves) runs once on real
tensors at a shape point under ``recorder.Recorder``, a torch dispatch
mode that sees every aten op; the kernel wrappers are one call each.

Tier B (``program_audit``, ``--programs``), at the audit point:

- **KBT101** float64 values in a device program;
- **KBT102** a transfer beyond the uploads the program declares;
- **KBT103** host syncs beyond the program's budget, ``(per call, per
  round)``: a scalar read, a data-dependent shape, a blocking copy;
- **KBT104** a declared in-place resident update moved its tensor.

Tier C (``memory_audit``, ``--memory``), at each point of the ladder the
device reaches (the audit point on the CPU; bench-20k and headline-50k on
a card):

- **KBT201** the peak device bytes exceed the budget (the card's
  ``total_memory``, or ``KB_HBM_BUDGET``);
- **KBT202** a steady program made a task × node plane;
- **KBT203** a declared in-place update allocated a buffer of the
  resident's size;
- **KBT204** a move between mesh positions inside the round loop carries
  the node axis.

A KBT000 is a program that failed to build or run, an allow without its
reason, or a stale allowlist entry.  Suppressions: an entry's ``allow``
(tier B) and ``memory_audit.HBM_ALLOWLIST`` (tier C), each with a
mandatory reason.

Run ``python -m kube_batch_tpu_torch.analysis --races`` (tiers A and D
over the package; ``--races-only``, ``--domains``, ``--static``, paths)
and ``python -m kube_batch_tpu_torch.analysis --programs --memory
--device cpu`` (``--select`` across all four tiers, ``--jsonl``,
``--seed``; exit 0 clean, 1 findings, 2 usage).  On a card ``chip_smoke.py``'s ``audit`` phase runs
both tiers and holds each program's recorded syncs against CUDA's
sync-debug count of the same call.
"""

from kube_batch_tpu_torch.analysis.engine import check_source, run_paths  # noqa: F401
from kube_batch_tpu_torch.analysis.findings import Finding  # noqa: F401
