"""Runtime lock-order checker of the port — the Linux lockdep idea, as the
JAX package's ``analysis/lockdep.py`` sizes it, with the port's own
instrumentation.

While the checker is installed, the locks that the port's concurrent
modules create are instrumented, and every acquisition records the
thread's held-lock set into one acquisition-order graph:

- **Order inversion**: thread 1 acquires A then B, thread 2 acquires B then
  A — a deadlock waiting for the right interleaving.  Locks are grouped by
  CREATION SITE (module:line), the analog of lockdep's lock classes, so an
  inversion between any two instances of the same site pair is caught even
  when no test ever deadlocks.  Detection is TRANSITIVE: a new edge A→B is
  a violation whenever a path B→…→A already exists, so the 3-lock cycle
  A→B→C→A reports the moment its closing edge lands, with the full chain
  and each edge's first-observed stack.
- **Blocking under lock**: ``time.sleep`` / ``Future.result`` /
  ``Event.wait`` reached while the thread holds a tracked lock, unless the
  region is fenced by ``utils.blocking.allow_blocking``.
- **Undeclared same-site nesting**: two instances of one lock class held
  at once without ``utils.blocking.allow_nesting``.
- **Wait and hold profile**: each acquire's wait and each release's hold,
  per site, accumulated per thread (``profile_report``).

How it instruments — two checkers in one process.  The JAX package's
checker (installed for a whole test session) patches the global
``threading.Lock``/``RLock`` with factories that find the creating module
two frames up.  The port's checker never touches those globals: wrapping
them would add a frame and make the JAX checker take every lock it sees
created for the port's own, and a port module would capture whatever
factory was global.  Instead each tracked port module gets its own view of
``threading`` through its module namespace (``Lock``, ``RLock`` and
``Condition`` from this checker, everything else the real module), and the
locks those modules already created at import (module-level locks, the
metric objects' locks) are swapped for tracked ones while installed.  The
real primitives come from ``_thread``.  The blocking primitives are
chained: the checker wraps whatever ``time.sleep``, ``Future.result`` and
``Event.wait`` were before it (the JAX checker's, when that one is
installed) and restores exactly those at uninstall.

The tracked modules (``DEFAULT_MODULE_PREFIXES``) are the port's
counterparts of the JAX list — cache, cmd.server, k8s.watch, metrics,
scheduler, obs, guard — plus serve, replicate and k8s.transport, whose
locks (the lease broker's and batcher's conditions, the publisher's and
follower's locks, the transport's breaker lock) the JAX list never
reached.

Also hosts the tier-D guarded-access corroborator
(``install_guarded_access``): hot shared structures get a data descriptor
that asserts, at access time, that the statically inferred domain lock
(``races.runtime_domain_specs``) is held.
"""

from __future__ import annotations

import _thread
import ast
import concurrent.futures
import dataclasses
import functools
import importlib
import pkgutil
import sys
import threading
import time
import traceback
import types
from typing import Dict, List, Optional, Tuple

from kube_batch_tpu_torch.utils import blocking as _blocking

PACKAGE = "kube_batch_tpu_torch"

#: modules whose locks are instrumented by default: the JAX package's list
#: in the port, then serve, replicate and k8s.transport
DEFAULT_MODULE_PREFIXES = tuple(f"{PACKAGE}.{m}" for m in (
    "cache", "cmd.server", "k8s.watch", "metrics", "scheduler", "obs", "guard",
    "serve", "replicate", "k8s.transport",
))

#: the hot shared structures the guarded-access corroborator instruments:
#: (module, class, attr).  Their domain locks are resolved from tier D
#: (``races.runtime_domain_specs``), so this table cannot disagree with
#: the static map it corroborates.
HOT_STRUCTURES = (
    (f"{PACKAGE}.cache.cache", "SchedulerCache", "_ingest_staged"),
    (f"{PACKAGE}.serve.lease", "LeaseBroker", "_lease"),
    (f"{PACKAGE}.replicate.publisher", "ReplicationPublisher", "_ring"),
    (f"{PACKAGE}.replicate.publisher", "ReplicationPublisher", "_mirror"),
)

_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock
_LOCK_TYPES = (type(_REAL_LOCK()), type(_REAL_RLOCK()))
#: the profile's clock, captured at import so no patching reaches it
_REAL_PERF = time.perf_counter
_REAL_GET_IDENT = _thread.get_ident
#: the real `threading` module, which the tracked modules' views delegate to
_THREADING = threading


@dataclasses.dataclass
class Violation:
    kind: str  # "order-inversion" | "blocking-under-lock" |
    #            "same-site-nesting" | "unguarded-access"
    description: str
    stack: str

    def render(self) -> str:
        return f"[{self.kind}] {self.description}\n{self.stack}"


def _stack(skip: int = 2, limit: int = 14) -> str:
    frames = traceback.format_stack()[:-skip]
    return "".join(frames[-limit:])


class LockdepState:
    """The acquisition-order graph, the per-thread held sets, the profile
    and the violations."""

    def __init__(self) -> None:
        # bookkeeping lock: a real lock, never visible to the graph
        self._mu = _REAL_LOCK()
        # (site_a, site_b) -> stack where a->b was first observed
        self.edges: Dict[Tuple[str, str], str] = {}
        self._adj: Dict[str, set] = {}
        self.violations: List[Violation] = []
        self._nested_sites: set = set()
        self._local = threading.local()
        # per-thread accumulators: site -> [n, wait_s, wait_max, hold_s, hold_max]
        self._profs: List[Dict[str, list]] = []

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A site path src → … → dst over the recorded edges, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._adj.get(node, ()):
                if nxt == dst:
                    return path + [dst]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- held-set helpers --------------------------------------------------
    def _held(self) -> List[list]:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = []
        return held  # entries: [site, lock_id, depth, t_acquired]

    def _prof(self) -> Dict[str, list]:
        prof = getattr(self._local, "prof", None)
        if prof is None:
            prof = self._local.prof = {}
            with self._mu:
                self._profs.append(prof)
        return prof

    def held_sites(self) -> List[str]:
        return [e[0] for e in self._held()]

    def holds(self, lock_id: int) -> bool:
        return any(e[1] == lock_id for e in self._held())

    # -- events ------------------------------------------------------------
    def on_acquired(self, site: str, lock_id: int, wait: float = 0.0,
                    depth: int = 1) -> None:
        prof = self._prof()
        rec = prof.get(site)
        if rec is None:
            rec = prof[site] = [0, 0.0, 0.0, 0.0, 0.0]
        rec[0] += 1
        rec[1] += wait
        if wait > rec[2]:
            rec[2] = wait
        held = self._held()
        for entry in held:
            if entry[1] == lock_id:
                entry[2] += depth  # reentrant RLock acquire
                return
        if (any(e[0] == site for e in held) and not _blocking.nesting_allowed()
                and site not in self._nested_sites):
            stack = _stack(skip=3)
            with self._mu:
                if site not in self._nested_sites:
                    self._nested_sites.add(site)
                    self.violations.append(Violation(
                        "same-site-nesting",
                        f"two instances of lock class {site} held by one "
                        "thread without an allow_nesting declaration — "
                        "per-object locks of one class have no defined "
                        "order; wrap the region in utils.blocking."
                        "allow_nesting(\"<order invariant>\") or impose a "
                        "global order",
                        stack,
                    ))
        # an unlocked membership probe first: in steady state every edge is
        # already recorded and this is a few dict lookups; the locked
        # re-check below closes the race
        candidates = [(hsite, site) for hsite, _i, _d, _t in held
                      if hsite != site and (hsite, site) not in self.edges]
        if candidates:
            stack = _stack(skip=3)
            inversions = []
            with self._mu:
                for edge in candidates:
                    a, b = edge
                    if edge in self.edges:
                        continue
                    # a NEW a->b edge closes a cycle iff b ->* a exists
                    cycle = self._path(b, a)
                    self.edges[edge] = stack
                    self._adj.setdefault(a, set()).add(b)
                    if cycle is not None:
                        inversions.append((edge, cycle))
                for (a, b), cycle in inversions:
                    if len(cycle) == 2:
                        desc = (f"lock order inverted: this thread acquired {a} "
                                f"then {b}, but {b} -> {a} was previously observed")
                        detail = (f"--- {a} -> {b} acquired at:\n{stack}"
                                  f"--- {b} -> {a} first observed at:\n"
                                  f"{self.edges[(b, a)]}")
                    else:
                        chain = " -> ".join(cycle)
                        desc = (f"lock order inverted (transitive): this thread "
                                f"acquired {a} then {b}, closing the cycle {a} -> "
                                f"{b} against the previously observed chain {chain}")
                        parts = [f"--- {a} -> {b} acquired at:\n{stack}"]
                        parts.extend(f"--- {x} -> {y} first observed at:\n"
                                     f"{self.edges[(x, y)]}"
                                     for x, y in zip(cycle, cycle[1:]))
                        detail = "".join(parts)
                    self.violations.append(Violation("order-inversion", desc, detail))
        held.append([site, lock_id, depth, _REAL_PERF()])

    def on_released(self, lock_id: int, all_levels: bool = False) -> int:
        """Drop one level (or all) of ``lock_id``; returns the levels
        dropped."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] == lock_id:
                n = held[i][2] if all_levels else 1
                held[i][2] -= n
                if held[i][2] == 0:
                    hold = _REAL_PERF() - held[i][3]
                    rec = self._prof().get(held[i][0])
                    if rec is not None:
                        rec[3] += hold
                        if hold > rec[4]:
                            rec[4] = hold
                    del held[i]
                return n
        return 0

    def on_blocking_call(self, what: str) -> None:
        held = self.held_sites()
        if not held or _blocking.blocking_allowed():
            return
        with self._mu:
            self.violations.append(Violation(
                "blocking-under-lock", f"{what} while holding {', '.join(held)}",
                _stack(skip=3)))

    def report(self) -> str:
        lines = [f"lockdep: {len(self.edges)} lock-order edges, "
                 f"{len(self.violations)} violation(s)"]
        lines.extend(v.render() for v in self.violations)
        return "\n".join(lines)

    def profile_report(self) -> Dict[str, Dict[str, float]]:
        """Merged per-site profile: site → {acquires, wait_ms_total,
        wait_ms_max, hold_ms_total, hold_ms_max}, most wait first."""
        with self._mu:
            profs = list(self._profs)
        merged: Dict[str, list] = {}
        for prof in profs:
            for site, rec in list(prof.items()):
                m = merged.setdefault(site, [0, 0.0, 0.0, 0.0, 0.0])
                m[0] += rec[0]
                m[1] += rec[1]
                m[2] = max(m[2], rec[2])
                m[3] += rec[3]
                m[4] = max(m[4], rec[4])
        return {
            site: {"acquires": m[0], "wait_ms_total": m[1] * 1e3,
                   "wait_ms_max": m[2] * 1e3, "hold_ms_total": m[3] * 1e3,
                   "hold_ms_max": m[4] * 1e3}
            for site, m in sorted(merged.items(), key=lambda kv: -kv[1][1])
        }


class TrackedLock:
    """A Lock/RLock feeding the checker's state; ``site`` (module:line) is
    its lock class.  Carries the ownership protocol ``threading.Condition``
    uses (``_is_owned``, ``_release_save``, ``_acquire_restore``), so a
    condition over a tracked lock waits and notifies correctly and its
    re-acquisitions are recorded.  ``inner`` is the lock to wrap (a
    module-level lock that already exists); by default a new real one."""

    def __init__(self, state: LockdepState, site: str, reentrant: bool = False,
                 inner=None):
        self._state = state
        self.site = site
        self._reentrant = reentrant
        if inner is None:
            inner = _REAL_RLOCK() if reentrant else _REAL_LOCK()
        self._lock = inner

    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = _REAL_PERF()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._state.on_acquired(self.site, id(self), wait=_REAL_PERF() - t0)
        return ok

    def release(self) -> None:
        self._state.on_released(id(self))
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        return self._state.holds(id(self))

    def _release_save(self):
        depth = self._state.on_released(id(self), all_levels=True)
        if self._reentrant:
            return depth, self._lock._release_save()
        self._lock.release()
        return depth, None

    def _acquire_restore(self, saved) -> None:
        depth, inner = saved
        t0 = _REAL_PERF()
        if self._reentrant:
            self._lock._acquire_restore(inner)
        else:
            self._lock.acquire()
        self._state.on_acquired(self.site, id(self), wait=_REAL_PERF() - t0,
                                depth=max(depth, 1))

    def __repr__(self) -> str:
        return f"<TrackedLock {self.site}>"


# --------------------------------------------------------------------------
# installation
# --------------------------------------------------------------------------


def _site_lines(module) -> Dict[Tuple[Optional[str], str], int]:
    """(class or None, name) → line of the lock-creating assignment in
    ``module``'s source: ``X = threading.Lock()`` at module level,
    ``self.X = threading.Lock()`` in a class."""
    path = getattr(module, "__file__", None)
    return _source_site_lines(path) if path else {}


@functools.lru_cache(maxsize=None)
def _source_site_lines(path: str) -> Dict[Tuple[Optional[str], str], int]:
    out: Dict[Tuple[Optional[str], str], int] = {}
    try:
        tree = ast.parse(open(path).read())
    except (OSError, SyntaxError):
        return out

    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Assign) and isinstance(child.value, ast.Call):
                for t in child.targets:
                    if isinstance(t, ast.Name):
                        out.setdefault((None, t.id), child.lineno)
                    elif (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        out.setdefault((cls, t.attr), child.lineno)
            visit(child, cls)

    visit(tree, None)
    return out


def _attr_site(cls: type, attr: str) -> str:
    """The site of the ``self.<attr> = ...`` that created an instance's
    lock: the first class along the MRO whose source assigns it (a subclass
    that inherits ``__init__`` shares its base's lock class)."""
    for klass in cls.__mro__:
        mod = sys.modules.get(klass.__module__)
        line = _site_lines(mod).get((klass.__name__, attr)) if mod is not None else None
        if line is not None:
            return f"{klass.__module__}:{line}"
    return f"{cls.__module__}:0"


class _ThreadingView(types.ModuleType):
    """The ``threading`` a tracked module sees while the checker is
    installed: the checker's Lock, RLock and Condition, the real module's
    everything else."""

    def __init__(self, inst: "_Installation"):
        super().__init__("threading")
        self.Lock = inst.make_lock
        self.RLock = inst.make_rlock
        self.Condition = inst.make_condition

    def __getattr__(self, name):
        return getattr(_THREADING, name)


class _Installation:
    def __init__(self, state: LockdepState):
        self.state = state
        self.view = _ThreadingView(self)
        # (holder, name, original, holder is an object rather than a dict)
        self._undo: List[Tuple[object, str, object, bool]] = []

    @staticmethod
    def _site() -> str:
        """module:line of the code that called the factory (two frames up)."""
        frame = sys._getframe(2)
        return f"{frame.f_globals.get('__name__', '?')}:{frame.f_lineno}"

    # the tracked modules' factories; each is called straight from the
    # module's code, so the creating frame is the caller's
    def make_lock(self):
        return TrackedLock(self.state, self._site(), reentrant=False)

    def make_rlock(self):
        return TrackedLock(self.state, self._site(), reentrant=True)

    def make_condition(self, lock=None):
        if lock is None:
            lock = TrackedLock(self.state, self._site(), reentrant=True)
        return _THREADING.Condition(lock)

    def tracked(self, name: str) -> bool:
        return any(name == p or name.startswith(p + ".")
                   for p in DEFAULT_MODULE_PREFIXES)

    def _set(self, holder, name: str, value, is_attr: bool) -> None:
        original = getattr(holder, name) if is_attr else holder[name]
        self._undo.append((holder, name, original, is_attr))
        if is_attr:
            setattr(holder, name, value)
        else:
            holder[name] = value

    def patch_module(self, mod) -> None:
        ns = mod.__dict__
        for name, value in list(ns.items()):
            if value is _THREADING:
                self._set(ns, name, self.view, False)
            elif isinstance(value, _LOCK_TYPES):
                site = f"{mod.__name__}:{_site_lines(mod).get((None, name), 0)}"
                self._set(ns, name, self._tracked_like(value, site), False)
            elif (self.tracked(type(value).__module__)
                    and isinstance(getattr(value, "__dict__", None), dict)):
                # a module-level object of a tracked module's class (a metric)
                for attr, inner in list(vars(value).items()):
                    if isinstance(inner, _LOCK_TYPES):
                        site = _attr_site(type(value), attr)
                        self._set(value, attr, self._tracked_like(inner, site), True)

    def _tracked_like(self, lock, site: str) -> TrackedLock:
        """A tracked wrapper around ``lock`` itself: a thread that holds the
        original across install or uninstall still excludes the wrapper's
        users, so the swap changes bookkeeping and never exclusion."""
        return TrackedLock(self.state, site,
                           reentrant=isinstance(lock, _LOCK_TYPES[1]), inner=lock)

    def undo(self) -> None:
        for holder, name, original, is_attr in reversed(self._undo):
            if is_attr:
                setattr(holder, name, original)
            else:
                holder[name] = original
        self._undo = []


_installed: Optional[_Installation] = None
_chained: List[Tuple[object, str, object]] = []


def _import_tracked() -> None:
    """Import every module under the tracked prefixes, so that each is
    patched before it creates a lock."""
    for prefix in DEFAULT_MODULE_PREFIXES:
        mod = importlib.import_module(prefix)
        for info in pkgutil.walk_packages(getattr(mod, "__path__", []) or [],
                                          prefix + "."):
            importlib.import_module(info.name)


def install(state: Optional[LockdepState] = None) -> LockdepState:
    """Instrument the tracked modules' locks and chain the blocking
    primitives.  ``state`` carries an acquisition graph over from an
    earlier installation (the test fixture keeps one per process).
    Idempotent: a second install returns the active state."""
    global _installed
    if _installed is not None:
        return _installed.state
    state = state if state is not None else LockdepState()
    _import_tracked()
    inst = _Installation(state)
    for name, mod in list(sys.modules.items()):
        if mod is not None and inst.tracked(name):
            inst.patch_module(mod)

    prev_sleep = time.sleep
    prev_result = concurrent.futures.Future.result
    prev_wait = threading.Event.wait

    def checked_sleep(seconds):
        state.on_blocking_call(f"time.sleep({seconds!r})")
        return prev_sleep(seconds)

    def checked_result(self, timeout=None):
        if not self.done():  # a done future cannot block
            state.on_blocking_call("Future.result()")
        return prev_result(self, timeout)

    def checked_wait(self, timeout=None):
        if not self.is_set():
            state.on_blocking_call("Event.wait()")
        return prev_wait(self, timeout)

    _chained[:] = [(time, "sleep", prev_sleep),
                   (concurrent.futures.Future, "result", prev_result),
                   (threading.Event, "wait", prev_wait)]
    time.sleep = checked_sleep
    concurrent.futures.Future.result = checked_result
    threading.Event.wait = checked_wait
    _installed = inst
    return state


def uninstall() -> Optional[LockdepState]:
    """Give the tracked modules back their ``threading`` and their
    original locks, and restore the blocking primitives as they were
    before :func:`install`; returns the state."""
    global _installed
    if _installed is None:
        return None
    inst, _installed = _installed, None
    inst.undo()
    for owner, name, prev in _chained:
        setattr(owner, name, prev)
    _chained.clear()
    return inst.state


def current_state() -> Optional[LockdepState]:
    return _installed.state if _installed is not None else None


def lock_name(site: str) -> Tuple[str, Optional[str], str]:
    """A site ``module:line`` as (module below its package, class, the
    attribute or name the lock is assigned to), read from the module's
    source; the line itself when no assignment is found.  Works for the
    JAX package's sites too (the module must already be imported)."""
    mod_name, _, line = site.rpartition(":")
    short = mod_name.split(".", 1)[1] if "." in mod_name else mod_name
    mod = sys.modules.get(mod_name)
    if mod is not None and line.isdigit():
        for (cls, name), ln in _site_lines(mod).items():
            if ln == int(line):
                return short, cls, name
    return short, None, line


# --------------------------------------------------------------------------
# guarded-access corroborator (tier D, analysis/races.py)
#
# - An instance is CONFINED until a second distinct thread touches it, so
#   single-thread fixtures never enforce.
# - Ownership must be attributable: a TrackedLock or a Condition answers
#   `_is_owned`; a plain untracked Lock cannot, and access under one is
#   skipped rather than misreported.
# - `utils.blocking.allow_unguarded("reason")` regions are exempt.
# - Violations dedupe per (class, attr) and land in LockdepState.violations.
# --------------------------------------------------------------------------


def _owned_by_current(lock) -> Optional[bool]:
    """Does the calling thread own ``lock``?  None when it cannot be told."""
    if lock is None:
        return None
    owned = getattr(lock, "_is_owned", None)
    if owned is not None:
        try:
            return bool(owned())
        except Exception:  # noqa: BLE001 — a foreign _is_owned never reports
            return None
    return None


class GuardedAttr:
    """Class-level data descriptor standing in for one plain instance
    attribute; values keep living in the instance ``__dict__`` under the
    same name, so uninstalling restores direct access with the value
    intact."""

    def __init__(self, install: "GuardedAccessInstallation", cls: type,
                 attr: str, lock_attr: str):
        self._install = install
        self._cls = cls
        self.attr = attr
        self.lock_attr = lock_attr

    def __get__(self, inst, objtype=None):
        if inst is None:
            return self
        self._check(inst, "read")
        try:
            return inst.__dict__[self.attr]
        except KeyError:
            raise AttributeError(
                f"{type(inst).__name__!r} object has no attribute {self.attr!r}"
            ) from None

    def __set__(self, inst, value) -> None:
        self._check(inst, "write")
        inst.__dict__[self.attr] = value

    def __delete__(self, inst) -> None:
        self._check(inst, "delete")
        inst.__dict__.pop(self.attr, None)

    def _check(self, inst, op: str) -> None:
        d = inst.__dict__
        idents = d.get("_kbt_guard_idents")
        if idents is None:
            idents = d.setdefault("_kbt_guard_idents", set())
        idents.add(_REAL_GET_IDENT())
        if len(idents) < 2:
            return
        if _blocking.unguarded_allowed():
            return
        if _owned_by_current(d.get(self.lock_attr)) is False:
            self._install._report(self, op)


class GuardedAccessInstallation:
    """One batch of instrumented (class, attr, domain lock) triples."""

    def __init__(self, state: LockdepState):
        self.state = state
        self._patched: List[Tuple[type, str]] = []
        self._reported: set = set()
        self._mu = _REAL_LOCK()

    def _report(self, desc: GuardedAttr, op: str) -> None:
        key = (desc._cls.__name__, desc.attr)
        if key in self._reported:
            return
        stack = _stack(skip=4)
        with self._mu:
            if key in self._reported:
                return
            self._reported.add(key)
        with self.state._mu:
            self.state.violations.append(Violation(
                "unguarded-access",
                f"{op} of {desc._cls.__name__}.{desc.attr} without holding its "
                f"inferred domain lock self.{desc.lock_attr} (tier D, "
                "analysis/races.py) on an instance already shared across "
                "threads — hold the lock or wrap the region in "
                "utils.blocking.allow_unguarded(\"<reason>\")",
                stack))

    def uninstall(self) -> None:
        for cls, attr in self._patched:
            if isinstance(cls.__dict__.get(attr), GuardedAttr):
                delattr(cls, attr)
        self._patched = []


def install_guarded_access(specs, state: Optional[LockdepState] = None
                           ) -> GuardedAccessInstallation:
    """Instrument ``(module, class, attr, lock_attr)`` tuples (what
    ``races.runtime_domain_specs`` returns).  ``state`` defaults to the
    active checker's; violations land there."""
    if state is None:
        state = current_state() or LockdepState()
    inst = GuardedAccessInstallation(state)
    for module, cls_name, attr, lock_attr in specs:
        cls = getattr(importlib.import_module(module), cls_name)
        if isinstance(cls.__dict__.get(attr), GuardedAttr):
            continue
        setattr(cls, attr, GuardedAttr(inst, cls, attr, lock_attr))
        inst._patched.append((cls, attr))
    return inst
