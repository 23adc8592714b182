"""Result-integrity guard plane — runtime verification of the fast paths.

Mirrors ``kube_batch_tpu/guard``.  Three tiers, wired through every device
program of the cycle:

1. **Cycle invariant sentinel** (``ops/invariants.py``): a check after each
   solve, read back with the result; a nonzero verdict makes the action
   fail closed — no binds or evictions from a condemned solve.
2. **Sampled shadow-oracle audit**: every ``KB_AUDIT_EVERY``-th engaged
   allocate dispatch re-runs the solve through its oracle (the full
   program) on the same snapshot and compares after the host replay; the
   enqueue gate is audited against the reference walk.
3. **Self-healing demotion** (:class:`GuardPlane`): a trip demotes the
   engaged fast paths to their oracles, drops the resident device state
   (a corrupted column heals on the next full upload) and dumps a
   diagnostics bundle (``guard/bundle.py``); after ``KB_GUARD_COOLDOWN``
   clean cycles a half-open probe re-promotes.

The port demotes ``topk``, ``warm`` and ``shard_map`` (the sharded
solves' shard bodies, whose oracle is ``"pjit"``: the single-device
program over the gathered snapshot); ``pallas`` is never engaged, the
kernels not being opt-in (a CUDA tensor never falls back to a kernel's
plain version).

Knobs: ``KB_GUARD=0`` (no sentinel, no audits, no demotion),
``KB_AUDIT_EVERY`` (default 64; 0 = no audits), ``KB_GUARD_COOLDOWN``
(default 8), ``KB_GUARD_DIR`` (bundle directory, default
``guard-bundles``).
"""

from kube_batch_tpu_torch.guard.plane import (
    FAST_PATHS,
    GuardPlane,
    consume_assignment_sentinel,
    consume_sentinel,
    guard_of,
    make_heal,
    sentinel_bundle_thunk,
)

__all__ = [
    "FAST_PATHS", "GuardPlane", "consume_assignment_sentinel",
    "consume_sentinel", "guard_of", "make_heal", "sentinel_bundle_thunk",
]
