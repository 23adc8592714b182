"""`allow_blocking` / `allow_nesting` / `allow_unguarded` — the runtime
analogs of `# kbt: allow[...]` for the lock checker (analysis/lockdep.py):
the first fences a sound blocking region, the second declares a deliberate
same-site lock nesting (two instances of one lock class held at once —
per-object locks acquired in a stable aggregate order), and the third
declares a deliberate lock-free access to an attribute whose tier-D domain
lock (analysis/races.py) would otherwise be enforced by the guarded-access
corroborator.

Lives in utils/ (stdlib-only, no analysis-package imports) because the
runtime core annotates with it — cache/volume.py fences its pv-writes
submit — and pulling the AST lint engine into every scheduler process just
to mark a sound blocking region would be backwards.  The lock checker
reads the same thread-locals, so suppression works whether or not the
checker is installed.  These switches are the port's own: the JAX
package's checker reads ``kube_batch_tpu.utils.blocking`` and never these,
so a region fenced here says nothing to it (it tracks no port lock).
"""

from __future__ import annotations

import contextlib
import threading

# per-thread depth counters: separate switches, one per declaration kind —
# a region sanctioned for same-site nesting is not thereby sanctioned to
# block, and vice versa
_blocking_ok = threading.local()
_nesting_ok = threading.local()
_unguarded_ok = threading.local()


@contextlib.contextmanager
def _declared_region(local: threading.local, kind: str, reason: str):
    """Shared depth-counted region: mandatory reason, reentrant, exception
    safe.  `reason` is what a code review greps for, exactly like the static
    `# kbt: allow[...]` annotations."""
    if not reason or not reason.strip():
        raise ValueError(f"{kind} requires a non-empty reason")
    depth = getattr(local, "depth", 0)
    local.depth = depth + 1
    try:
        yield
    finally:
        local.depth = depth


def allow_blocking(reason: str):
    """Suppress lockdep blocking-under-lock reports for the enclosed region.
    The reason should say why the block is sound (bounded, ordering-fenced,
    one-time spawn...)."""
    return _declared_region(_blocking_ok, "allow_blocking", reason)


def blocking_allowed() -> bool:
    return getattr(_blocking_ok, "depth", 0) > 0


def allow_nesting(reason: str):
    """Declare that same-site lock nesting inside this region is deliberate
    — e.g. two per-object locks of one class acquired in a stable aggregate
    order.  Without the declaration the lockdep detector reports same-site
    nesting as an order violation (two instances of one class have no
    defined order, so the nesting IS an undeclared ordering claim).  The
    reason should name the order invariant that makes the nesting sound."""
    return _declared_region(_nesting_ok, "allow_nesting", reason)


def nesting_allowed() -> bool:
    return getattr(_nesting_ok, "depth", 0) > 0


def allow_unguarded(reason: str):
    """Declare that lock-free access to domain-guarded attributes inside
    this region is deliberate — the runtime counterpart of a static
    `# kbt: allow[KBT301]` annotation, consumed by the guarded-access
    corroborator (analysis/lockdep.install_guarded_access).  The reason
    should say why the unlocked access cannot tear (GIL-atomic single op,
    documented stale-tolerant hint, cycle-confined structure...)."""
    return _declared_region(_unguarded_ok, "allow_unguarded", reason)


def unguarded_allowed() -> bool:
    return getattr(_unguarded_ok, "depth", 0) > 0
