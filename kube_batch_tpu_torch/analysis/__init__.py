"""The device-program audits of the port: tiers B and C of the JAX
package's analyzer (``kube_batch_tpu/analysis``), for programs that run
on a card rather than programs that are traced for one.

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
mandatory reason.  The JAX package's tiers A (AST rules) and D (lock
domains) have no counterpart here yet.

Run ``python -m kube_batch_tpu_torch.analysis --programs --memory
--device cpu`` (``--select``, ``--jsonl``, ``--seed``; exit 0 clean, 1
findings, 2 usage).  On a card ``chip_smoke.py``'s ``audit`` phase runs
both tiers and holds each program's recorded syncs against CUDA's
sync-debug count of the same call.
"""

from kube_batch_tpu_torch.analysis.findings import Finding  # noqa: F401
