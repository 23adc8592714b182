"""Tier D: static thread/lock-domain race analysis (KBT301-304; the JAX
package's ``analysis/races.py``, kept as the port's own copy).

The port is a deliberately threaded system — the pipelined cycle overlaps
a writeback worker with the next cycle's ingest drain and solve, watch
threads feed the cache, the what-if batcher and the replication
publisher/follower run their own workers, and every AdminServer request
gets its own thread.  The Go scheduler guarded all of this with one big
mutex; the rebuild splits that into a lock hierarchy (cache big lock, leaf
ingest/dispatch locks, the broker and batcher condition variables), and
the load-bearing invariant underneath is simple to state and easy to
silently break: *every shared mutable attribute is consistently guarded by
the same lock on every thread root that touches it*.  The runtime lock
checker (lockdep.py) catches lock-ORDER mistakes but says nothing about a
field some path forgot to lock at all — the bug class ``go test -race``
exists for.  Tier D is the static equivalent, built on the tier-A engine
and dataflow walker:

1. **Thread-root graph** — enumerate the code paths that run on distinct
   threads: functions handed to ``threading.Thread``/``Timer``, pool
   ``submit``/``map`` targets, HTTP handler methods (``do_*`` — the
   ThreadingHTTPServer gives every request its own thread, so handlers are
   additionally concurrent with THEMSELVES), and public methods of
   lock-owning classes (a class that created a lock has declared itself
   multi-threaded; its public surface can be entered from any thread —
   this is how cross-module roots like the watch callbacks and admin
   handlers reach a class without whole-program analysis).  Membership
   propagates through same-module calls; everything else is the "main"
   (cycle) root.  ``testing/`` is excluded — its threads are pytest-only
   harness roots.

2. **Lock-domain inference** — per class, a with-block region walk over
   every method records each ``self.<attr>`` access together with the set
   of lock attributes (``threading.Lock``/``RLock``/``Condition``
   instances assigned to ``self``) lexically held around it.  Private
   helpers whose every in-module call site holds lock L are credited with
   L (the ``_locked``-helper idiom — without this, every ``*_locked``
   body would be a false positive).  The lock that dominates an
   attribute's guarded accesses is its *domain*; the full per-class map is
   a reviewable report (``--domains``).

3. **Rules** (each grounded in a bug class the JAX package has actually
   carried):

   - KBT301: an attribute guarded by its domain lock on one thread root
     but accessed lock-free (or under a different lock) on another.
   - KBT302: live mutable containers (dict/list/set/deque attributes)
     handed to another thread (pool submit/map args, Thread args) without
     a value-snapshot (``dict(x)``/``list(x)``/``.copy()``) — the
     generalized StatusFlush double-buffer contract.  Subsumes KBT012
     (the writeback-stage instance), whose id stays as a ``--select``
     alias.
   - KBT303: check-then-act on a shared attribute outside its domain lock
     (test and act both lock-free — the lost-update window).
   - KBT304: the lazy-init special case of 303 (``if self.x is None:
     self.x = ...`` without the lock).  The sanctioned double-checked
     idiom — lock-free peek, then re-check and assign UNDER the lock —
     does not fire: only a lock-free *assignment* reports.

Suppression is the established ``# kbt: allow[KBT30x] reason`` contract.
The runtime corroborator (analysis/lockdep.py ``install_guarded_access``)
consumes this module's inferred domains to assert, at access time in the
test suite, that the domain lock is actually held on hot shared
structures — the static map and the runtime behavior cross-validate.  The
runtime-side escape hatch is
``kube_batch_tpu_torch.utils.blocking.allow_unguarded`` so product code
never imports this engine.

Known approximation directions (deliberate, like the tier-A walker):
- UNDER: cross-module calls (a bound method stored as a callback and
  invoked from another module's thread) are invisible unless the callee's
  class owns a lock; ``lock.acquire()``/``release()`` outside a ``with``
  is not credited; attributes never accessed under ANY lock have no
  domain and are skipped (KBT003 owns module globals; wholly unguarded
  classes are a design smell this tier cannot rank).
- OVER: "public method of a lock-owning class" assumes any-thread entry,
  and construction-time calls into helpers count as main-root calls —
  both can flag code that is dynamically single-threaded; that is what
  the annotation contract (with a mandatory reason) is for.
"""

from __future__ import annotations

import ast
import dataclasses
from collections import Counter
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from kube_batch_tpu_torch.analysis.dataflow import (
    FlowEvent, FlowVisitor, ModuleContext, call_keyword, walk_function,
)
from kube_batch_tpu_torch.analysis.engine import Rule

#: tier-D path exclusions: testing/ spawns threads only under pytest (the
#: benchmark/e2e harness) — those are pytest-only roots per the tier spec
EXCLUDED_PREFIXES = ("testing/",)

#: select alias: the old writeback-handoff rule is a KBT302 instance now.
#: Defined in engine.py (so allow-comment resolution sees it too) and
#: re-exported here for the CLI and tests.
from kube_batch_tpu_torch.analysis.engine import RULE_ALIASES  # noqa: F401,E402

MAIN_ROOT = "main"
#: the any-thread root: HTTP handlers and the public surface of
#: lock-owning classes; concurrent with every root INCLUDING itself
EXT_ROOT = "ext"

LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "kube_batch_tpu_torch.analysis.lockdep.TrackedLock",
}
#: attributes bound to these are internally synchronized (or per-thread)
#: by construction — excluded from the domain map and the rules
SAFE_FACTORIES = {
    "threading.local", "threading.Event", "threading.Semaphore",
    "threading.BoundedSemaphore", "threading.Barrier",
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue",
    "concurrent.futures.ThreadPoolExecutor",
    "concurrent.futures.ProcessPoolExecutor",
    "logging.getLogger",
}
CONTAINER_FACTORIES = {
    "collections.deque", "collections.defaultdict",
    "collections.OrderedDict", "collections.Counter",
}
CONTAINER_BUILTINS = {"dict", "list", "set"}
#: sanctioned snapshot constructors for a cross-thread handoff (KBT302)
SNAPSHOT_CALLS = {"dict", "list", "set", "tuple", "frozenset", "sorted"}
SNAPSHOT_METHODS = {"copy"}
#: method calls that mutate a container in place (count as writes)
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "add", "update",
    "insert", "remove", "discard", "pop", "popitem", "popleft", "clear",
    "setdefault", "sort", "reverse",
}
HTTP_HANDLER_METHODS = {
    "do_GET", "do_POST", "do_PUT", "do_DELETE", "do_PATCH", "do_HEAD",
}
INIT_METHODS = {"__init__", "__new__", "__post_init__"}
#: submit-shaped pool entry points: first arg runs on a worker thread
POOL_SPAWN_ATTRS = {"submit", "map"}


# --------------------------------------------------------------------------
# module scan: function index, spawn seeds, class lock/access regions
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _FuncInfo:
    qual: str
    node: ast.AST
    cls: Optional[str]          # immediate enclosing class name
    name: str                   # bare name


@dataclasses.dataclass
class Access:
    attr: str
    line: int
    col: int
    write: bool
    held: FrozenSet[str]        # lexically held lock attrs
    qual: str                   # function the access executes in
    extra_key: Optional[str]    # method name for caller-held credit
    in_init: bool


@dataclasses.dataclass
class CheckAct:
    attr: str
    test_line: int
    test_col: int
    test_held: FrozenSet[str]
    write_line: int
    write_held: FrozenSet[str]
    lazy: bool                  # `is None` test → KBT304, else KBT303
    qual: str
    extra_key: Optional[str]


@dataclasses.dataclass
class Handoff:                  # KBT302: live container crossing threads
    attr: str
    line: int
    col: int
    qual: str
    via: str                    # "submit" | "thread"


@dataclasses.dataclass
class _CallSite:
    callee: str                 # bare method name (same class)
    held: FrozenSet[str]
    caller_key: Optional[str]   # caller method name (None inside closures)
    from_init: bool


class ClassScan:
    def __init__(self, name: str):
        self.name = name
        self.lock_attrs: Dict[str, int] = {}      # attr -> def line
        self.safe_attrs: Set[str] = set()
        self.container_attrs: Set[str] = set()
        self.accesses: List[Access] = []
        self.check_acts: List[CheckAct] = []
        self.handoffs: List[Handoff] = []
        self.call_sites: List[_CallSite] = []
        self.methods: Dict[str, ast.AST] = {}     # bare name -> def node
        self.seed_methods: Set[str] = set()       # spawn targets
        #: caller-held credit for private helpers (the `_locked` idiom)
        self.extra_held: Dict[str, FrozenSet[str]] = {}


def _self_attr(node: ast.AST) -> Optional[str]:
    """`self.X` → 'X' (direct attribute on the literal name `self`)."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _getattr_self_attr(call: ast.Call) -> Optional[str]:
    """`getattr(self, "X", ...)` / `setattr(self, "X", v)` → 'X'."""
    if (isinstance(call.func, ast.Name)
            and call.func.id in ("getattr", "setattr")
            and len(call.args) >= 2
            and isinstance(call.args[0], ast.Name)
            and call.args[0].id == "self"):
        return _const_str(call.args[1])
    return None


class _RaceModule:
    """Everything tier D derives from one module, built once per file and
    shared by the four rules (memoized on the engine's ModuleContext)."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.funcs: Dict[str, _FuncInfo] = {}
        self.classes: Dict[str, ClassScan] = {}
        self.edges: Dict[str, Set[str]] = {}      # same-module call graph
        self.seeds: Dict[str, Set[str]] = {}      # qual -> base roots
        self.roots: Dict[str, FrozenSet[str]] = {}
        self._index(ctx.tree)
        self._scan_classes()
        self._collect_spawns_and_edges()
        self._propagate_roots()
        self._credit_caller_held()

    # -- function index ----------------------------------------------------
    def _index(self, tree: ast.Module) -> None:
        def visit(node: ast.AST, owner: str, cls: Optional[str],
                  owner_is_func: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if owner_is_func:
                        qual = f"{owner}.<locals>.{child.name}"
                    elif cls:
                        qual = f"{cls}.{child.name}"
                    else:
                        qual = child.name
                    self.funcs[qual] = _FuncInfo(qual, child, cls, child.name)
                    visit(child, qual, cls, True)
                elif isinstance(child, ast.ClassDef):
                    # innermost class wins (nested handler classes)
                    visit(child, child.name, child.name, False)
                else:
                    visit(child, owner, cls, owner_is_func)

        visit(tree, "", None, False)

    # -- per-class region scan ---------------------------------------------
    def _scan_classes(self) -> None:
        for info in self.funcs.values():
            if info.cls is None:
                continue
            scan = self.classes.setdefault(info.cls, ClassScan(info.cls))
            if "<locals>" not in info.qual:
                scan.methods[info.name] = info.node
        # pass 1: lock / safe / container attribute classification —
        # needed before the access walk can compute held sets
        for cls, scan in self.classes.items():
            for name, node in scan.methods.items():
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    for t in sub.targets:
                        attr = _self_attr(t)
                        if attr is None:
                            continue
                        self._classify(scan, attr, sub.value, t.lineno)
        # pass 2: the held-region access walk over every top-level method
        for cls, scan in self.classes.items():
            for name, node in sorted(scan.methods.items()):
                _MethodScan(self, scan, name, node).run()

    def _classify(self, scan: ClassScan, attr: str, value: ast.expr,
                  line: int) -> None:
        if isinstance(value, ast.Call):
            dotted = self.ctx.imports.dotted(value.func)
            if dotted in LOCK_FACTORIES:
                scan.lock_attrs.setdefault(attr, line)
                return
            if dotted in SAFE_FACTORIES:
                scan.safe_attrs.add(attr)
                return
            if dotted in CONTAINER_FACTORIES or (
                    isinstance(value.func, ast.Name)
                    and value.func.id in CONTAINER_BUILTINS):
                scan.container_attrs.add(attr)
                return
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                              ast.ListComp, ast.SetComp)):
            scan.container_attrs.add(attr)

    # -- spawn seeds + same-module call edges -------------------------------
    def _resolve_target(self, node: ast.AST, caller: _FuncInfo
                        ) -> Optional[str]:
        """A callable expression → the qual of the function it names."""
        attr = _self_attr(node)
        if attr is not None and caller.cls is not None:
            qual = f"{caller.cls}.{attr}"
            return qual if qual in self.funcs else None
        if isinstance(node, ast.Name):
            nested = f"{caller.qual}.<locals>.{node.id}"
            if nested in self.funcs:
                return nested
            if node.id in self.funcs:
                return node.id
        return None

    def _spawn_target(self, call: ast.Call, caller: _FuncInfo
                      ) -> Optional[Tuple[str, str]]:
        """(target qual, kind) when `call` starts a thread on `target`."""
        dotted = self.ctx.imports.dotted(call.func)
        cand: Optional[ast.AST] = None
        kind = "thread"
        if dotted == "threading.Thread":
            cand = call_keyword(call, "target")
        elif dotted == "threading.Timer":
            cand = call_keyword(call, "function") or (
                call.args[1] if len(call.args) > 1 else None)
        elif (isinstance(call.func, ast.Attribute)
                and call.func.attr in POOL_SPAWN_ATTRS and call.args):
            cand, kind = call.args[0], "submit"
        if cand is None:
            return None
        qual = self._resolve_target(cand, caller)
        return (qual, kind) if qual is not None else None

    def _collect_spawns_and_edges(self) -> None:
        for info in self.funcs.values():
            callees: Set[str] = set()
            for sub in self._own_nodes(info.node):
                if not isinstance(sub, ast.Call):
                    continue
                spawn = self._spawn_target(sub, info)
                if spawn is not None:
                    qual, _ = spawn
                    self.seeds.setdefault(qual, set()).add(f"worker:{qual}")
                    target = self.funcs[qual]
                    if target.cls is not None:
                        self.classes[target.cls].seed_methods.add(target.name)
                    continue  # registration is not a same-thread call
                callee = self._resolve_target(sub.func, info)
                if callee is not None:
                    callees.add(callee)
            self.edges[info.qual] = callees
            if info.name in HTTP_HANDLER_METHODS and info.cls is not None:
                self.seeds.setdefault(info.qual, set()).add(EXT_ROOT)
            elif (info.cls is not None and "<locals>" not in info.qual
                    and not info.name.startswith("_")
                    and self.classes[info.cls].lock_attrs):
                # public surface of a lock-owning class: any-thread entry
                self.seeds.setdefault(info.qual, set()).add(EXT_ROOT)
            # dunders other than __init__ are public surface too
            elif (info.cls is not None and "<locals>" not in info.qual
                    and info.name.startswith("__")
                    and info.name not in INIT_METHODS
                    and self.classes[info.cls].lock_attrs):
                self.seeds.setdefault(info.qual, set()).add(EXT_ROOT)

    def _own_nodes(self, func: ast.AST) -> Iterable[ast.AST]:
        """Walk a function body, excluding nested function scopes (they are
        indexed as their own functions)."""
        stack: List[ast.AST] = list(ast.iter_child_nodes(func))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    # -- root propagation ---------------------------------------------------
    def _propagate_roots(self) -> None:
        member: Dict[str, Set[str]] = {
            q: set(self.seeds.get(q, ())) for q in self.funcs}

        def flow() -> None:
            changed = True
            while changed:
                changed = False
                for caller, callees in self.edges.items():
                    for callee in callees:
                        if callee not in member:
                            continue
                        before = len(member[callee])
                        member[callee] |= member[caller]
                        changed = changed or len(member[callee]) != before

        flow()
        # nested closures inherit their definer's roots unless they are
        # spawn seeds themselves (a worker body defined inline)
        for qual in self.funcs:
            if "<locals>" in qual and not member[qual]:
                definer = qual.split(".<locals>.")[0]
                member[qual] |= member.get(definer, set())
        # whatever nothing reaches runs on the caller's thread: the cycle
        # body, module entry points, plain-class public methods
        for qual, roots in member.items():
            if not roots:
                roots.add(MAIN_ROOT)
        flow()
        self.roots = {q: frozenset(r) for q, r in member.items()}

    # -- caller-held credit for private helpers -----------------------------
    def _credit_caller_held(self) -> None:
        """A private method whose EVERY non-__init__ in-module call site
        holds lock L is analyzed as holding L — the `*_locked` helper
        idiom.  Spawn seeds are excluded: the registration site's locks
        are NOT held when the worker later runs.  A ``*_locked``-SUFFIXED
        method is additionally credited by its name: the suffix is this
        codebase's documented "caller holds the lock" contract, and such
        methods are routinely passed around as callbacks (the resync
        apply), where no in-module call site exists to intersect over —
        the runtime corroborator is what checks the name keeps its
        promise."""
        for scan in self.classes.values():
            all_locks = frozenset(scan.lock_attrs)
            for name in scan.methods:
                if name.endswith("_locked") and name not in scan.seed_methods:
                    scan.extra_held[name] = all_locks
            for _ in range(4):  # propagate helper→helper chains
                for name in scan.methods:
                    if (not name.startswith("_") or name in INIT_METHODS
                            or name in scan.seed_methods
                            or name.endswith("_locked")):
                        continue
                    sites = [s for s in scan.call_sites
                             if s.callee == name and not s.from_init]
                    if not sites:
                        continue
                    held = None
                    for s in sites:
                        eff = s.held | scan.extra_held.get(
                            s.caller_key or "", frozenset())
                        held = eff if held is None else (held & eff)
                    scan.extra_held[name] = frozenset(held or ())

    # -- effective held / concurrency helpers ------------------------------
    def held_of(self, scan: ClassScan, held: FrozenSet[str],
                extra_key: Optional[str]) -> FrozenSet[str]:
        if extra_key is None:
            return held
        return held | scan.extra_held.get(extra_key, frozenset())

    def roots_of(self, qual: str) -> FrozenSet[str]:
        return self.roots.get(qual, frozenset((MAIN_ROOT,)))


def _concurrent(a: FrozenSet[str], b: FrozenSet[str]) -> bool:
    """Can code on roots `a` run concurrently with code on roots `b`?
    The ext root is concurrent with everything, itself included (many
    handler threads); otherwise two DISTINCT roots are required."""
    if EXT_ROOT in a or EXT_ROOT in b:
        return True
    return any(r1 != r2 for r1 in a for r2 in b)


# --------------------------------------------------------------------------
# per-method held-region walk
# --------------------------------------------------------------------------


class _MethodScan:
    """Walk one method recording every `self.<attr>` access with the set
    of lock attributes lexically held around it, plus check-then-act
    shapes (If tests reading an attr whose body writes it)."""

    def __init__(self, mod: _RaceModule, scan: ClassScan, name: str,
                 node: ast.AST):
        self.mod = mod
        self.scan = scan
        self.method = name
        self.node = node
        self.in_init = name in INIT_METHODS

    def run(self) -> None:
        self._stmts(self.node.body, frozenset(), f"{self.scan.name}."
                    f"{self.method}", self.method, [])

    # -- access recording ---------------------------------------------------
    def _record(self, attr: str, node: ast.AST, write: bool,
                held: FrozenSet[str], qual: str, key: Optional[str],
                if_stack: List[Tuple[Dict[str, Tuple[int, int, bool]],
                                     FrozenSet[str]]]) -> None:
        if attr in self.scan.lock_attrs or attr in self.scan.methods:
            return  # lock handles and bound-method references are not data
        self.scan.accesses.append(Access(
            attr, node.lineno, node.col_offset, write, held, qual, key,
            self.in_init))
        if write and not self.in_init:
            # pair the act with EVERY enclosing frame that tested the attr,
            # not just the nearest: the double-checked idiom's outer peek
            # (lock-free test, locked re-check + write) is only recognized
            # as sanctioned if the outer frame also yields a CheckAct
            for tests, test_held in reversed(if_stack):
                if attr in tests:
                    line, col, lazy = tests[attr]
                    self.scan.check_acts.append(CheckAct(
                        attr, line, col, test_held, node.lineno, held,
                        lazy, qual, key))

    def _expr(self, node: Optional[ast.AST], held, qual, key, if_stack,
              store: bool = False) -> None:
        if node is None or isinstance(node, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.Lambda, ast.ClassDef)):
            return
        attr = _self_attr(node)
        if attr is not None:
            write = store or isinstance(node.ctx, (ast.Store, ast.Del))
            self._record(attr, node, write, held, qual, key, if_stack)
            return
        if isinstance(node, ast.Call):
            # same-class `self.m(...)`: a call site for caller-held credit
            callee = _self_attr(node.func)
            if callee is not None and callee in self.scan.methods:
                self.scan.call_sites.append(_CallSite(
                    callee, held, key, self.in_init))
            # self.X.append(...) — in-place container mutation is a write
            if isinstance(node.func, ast.Attribute):
                recv = _self_attr(node.func.value)
                if recv is not None and node.func.attr in MUTATOR_METHODS:
                    self._record(recv, node.func.value, True, held, qual,
                                 key, if_stack)
                    for a in node.args:
                        self._expr(a, held, qual, key, if_stack)
                    for kw in node.keywords:
                        self._expr(kw.value, held, qual, key, if_stack)
                    return
            ga = _getattr_self_attr(node)
            if ga is not None:
                write = (isinstance(node.func, ast.Name)
                         and node.func.id == "setattr")
                self._record(ga, node, write, held, qual, key, if_stack)
        if store and isinstance(node, ast.Subscript):
            recv = _self_attr(node.value)
            if recv is not None:
                # self.X[k] = v mutates the container bound at X
                self._record(recv, node.value, True, held, qual, key,
                             if_stack)
                self._expr(node.slice, held, qual, key, if_stack)
                return
        if store and isinstance(node, ast.Attribute):
            recv = _self_attr(node.value)
            if recv is not None:
                # self.X.field = v mutates the OBJECT bound at X in place
                self._record(recv, node.value, True, held, qual, key,
                             if_stack)
                return
        for child in ast.iter_child_nodes(node):
            self._expr(child, held, qual, key, if_stack)

    def _assign_target(self, t: ast.AST, held, qual, key, if_stack) -> None:
        attr = _self_attr(t)
        if attr is not None:
            self._record(attr, t, True, held, qual, key, if_stack)
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._assign_target(e, held, qual, key, if_stack)
            return
        if isinstance(t, ast.Starred):
            self._assign_target(t.value, held, qual, key, if_stack)
            return
        self._expr(t, held, qual, key, if_stack, store=True)

    # -- statements ---------------------------------------------------------
    def _stmts(self, stmts, held, qual, key, if_stack) -> None:
        for s in stmts:
            self._stmt(s, held, qual, key, if_stack)

    def _stmt(self, s: ast.stmt, held, qual, key, if_stack) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a closure runs later, usually on another thread, with NO
            # lexically captured lock held; roots come from the spawn graph
            nested = f"{qual}.<locals>.{s.name}"
            self._stmts(s.body, frozenset(), nested, None, [])
            return
        if isinstance(s, ast.ClassDef):
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            acquired: Set[str] = set()
            for item in s.items:
                attr = _self_attr(item.context_expr)
                if attr is not None and attr in self.scan.lock_attrs:
                    acquired.add(attr)
                else:
                    self._expr(item.context_expr, held, qual, key, if_stack)
                if item.optional_vars is not None:
                    self._assign_target(item.optional_vars, held, qual,
                                        key, if_stack)
            self._stmts(s.body, held | acquired, qual, key, if_stack)
            return
        if isinstance(s, ast.If):
            tests: Dict[str, Tuple[int, int, bool]] = {}
            self._collect_test_attrs(s.test, tests)
            self._expr(s.test, held, qual, key, if_stack)
            self._stmts(s.body, held, qual, key, if_stack + [(tests, held)])
            self._stmts(s.orelse, held, qual, key, if_stack)
            return
        if isinstance(s, ast.While):
            self._expr(s.test, held, qual, key, if_stack)
            self._stmts(s.body, held, qual, key, if_stack)
            self._stmts(s.orelse, held, qual, key, if_stack)
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter, held, qual, key, if_stack)
            self._assign_target(s.target, held, qual, key, if_stack)
            self._stmts(s.body, held, qual, key, if_stack)
            self._stmts(s.orelse, held, qual, key, if_stack)
            return
        if isinstance(s, ast.Try):
            self._stmts(s.body, held, qual, key, if_stack)
            for h in s.handlers:
                self._stmts(h.body, held, qual, key, if_stack)
            self._stmts(s.orelse, held, qual, key, if_stack)
            self._stmts(s.finalbody, held, qual, key, if_stack)
            return
        if isinstance(s, ast.Assign):
            self._expr(s.value, held, qual, key, if_stack)
            for t in s.targets:
                self._assign_target(t, held, qual, key, if_stack)
            return
        if isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._expr(s.value, held, qual, key, if_stack)
            self._assign_target(s.target, held, qual, key, if_stack)
            return
        if isinstance(s, ast.AugAssign):
            self._expr(s.value, held, qual, key, if_stack)
            self._assign_target(s.target, held, qual, key, if_stack)
            return
        if isinstance(s, (ast.Expr, ast.Return)):
            self._expr(s.value, held, qual, key, if_stack)
            return
        if isinstance(s, ast.Match):
            self._expr(s.subject, held, qual, key, if_stack)
            for case in s.cases:
                if case.guard is not None:
                    self._expr(case.guard, held, qual, key, if_stack)
                self._stmts(case.body, held, qual, key, if_stack)
            return
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self._expr(child, held, qual, key, if_stack)

    def _collect_test_attrs(self, test: ast.AST,
                            out: Dict[str, Tuple[int, int, bool]]) -> None:
        lazy_attr = None
        if (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], ast.Is)
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None):
            lazy_attr = _self_attr(test.left)
            if lazy_attr is None and isinstance(test.left, ast.Call):
                lazy_attr = _getattr_self_attr(test.left)
        for sub in ast.walk(test):
            attr = _self_attr(sub)
            if attr is None and isinstance(sub, ast.Call):
                attr = _getattr_self_attr(sub)
            if attr is not None and attr not in self.scan.lock_attrs:
                out.setdefault(attr, (test.lineno, test.col_offset,
                                      attr == lazy_attr))


# --------------------------------------------------------------------------
# KBT302 handoff detection (dataflow walk: aliases launder nothing)
# --------------------------------------------------------------------------


class _HandoffVisitor(FlowVisitor):
    def __init__(self, mod: _RaceModule, scan: ClassScan, info: _FuncInfo,
                 mutated: Set[str]):
        self.mod = mod
        self.scan = scan
        self.info = info
        self.mutated = mutated

    def on_bind(self, ev: FlowEvent, env, value) -> None:
        attr = _self_attr(value) if value is not None else None
        if attr is not None and attr in self.scan.container_attrs:
            ev.cell["kbt_container"] = attr

    def _payload_attr(self, node: ast.AST, env) -> Optional[str]:
        attr = _self_attr(node)
        if attr is not None and attr in self.scan.container_attrs:
            return attr
        if isinstance(node, ast.Name):
            cell = env.get(node.id)
            if cell is not None:
                tainted = cell.get("kbt_container")
                if isinstance(tainted, str):
                    return tainted
        return None

    def on_call(self, ev: FlowEvent, env) -> None:
        call = ev.node
        dotted = self.mod.ctx.imports.dotted(call.func)
        payload: List[ast.AST] = []
        via = "submit"
        if dotted == "threading.Thread":
            args_t = call_keyword(call, "args")
            if isinstance(args_t, (ast.Tuple, ast.List)):
                payload = list(args_t.elts)
            via = "thread"
        elif (isinstance(call.func, ast.Attribute)
                and call.func.attr in POOL_SPAWN_ATTRS
                and len(call.args) > 1):
            payload = list(call.args[1:])
        for p in payload:
            attr = self._payload_attr(p, env)
            if attr is not None and attr in self.mutated:
                self.scan.handoffs.append(Handoff(
                    attr, p.lineno, p.col_offset, self.info.qual, via))


# --------------------------------------------------------------------------
# domain inference + rule evaluation
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Domain:
    cls: str
    attr: str
    lock: str
    guarded: int
    unguarded: int
    written: bool
    roots: FrozenSet[str]


def _excluded(relpath: str) -> bool:
    return any(relpath.startswith(p) or f"/{p}" in f"/{relpath}"
               for p in EXCLUDED_PREFIXES)


def race_context(ctx: ModuleContext) -> Optional["_RaceAnalysis"]:
    cached = getattr(ctx, "_kbt_race", None)
    if cached is not None:
        return cached
    if _excluded(ctx.relpath):
        return None
    analysis = _RaceAnalysis(ctx)
    ctx._kbt_race = analysis
    return analysis


class _RaceAnalysis:
    """Domains + the four rules' findings for one module, computed once."""

    def __init__(self, ctx: ModuleContext):
        self.mod = _RaceModule(ctx)
        self.domains: List[Domain] = []
        self.findings: Dict[str, List[Tuple[int, int, str]]] = {
            "KBT301": [], "KBT302": [], "KBT303": [], "KBT304": [],
        }
        self._evaluate()

    def _attr_state(self, scan: ClassScan):
        """Per attribute: effective accesses outside __init__."""
        mod = self.mod
        by_attr: Dict[str, List[Tuple[Access, FrozenSet[str],
                                      FrozenSet[str]]]] = {}
        for a in scan.accesses:
            if a.in_init or a.attr in scan.safe_attrs:
                continue
            eff = mod.held_of(scan, a.held, a.extra_key)
            by_attr.setdefault(a.attr, []).append(
                (a, eff & frozenset(scan.lock_attrs),
                 mod.roots_of(a.qual)))
        return by_attr

    def _evaluate(self) -> None:
        mod = self.mod
        self._claimed: Set[Tuple[str, str, int]] = set()
        for cls in sorted(mod.classes):
            scan = mod.classes[cls]
            if not scan.lock_attrs:
                self._evaluate_handoffs(scan)
                continue
            by_attr = self._attr_state(scan)
            domain_by_attr: Dict[str, Domain] = {}
            for attr in sorted(by_attr):
                accs = by_attr[attr]
                guarded = [(a, h, r) for a, h, r in accs if h]
                if not guarded:
                    continue  # never locked anywhere: no inferable domain
                counts: Counter = Counter()
                for a, h, r in guarded:
                    for lock in h:
                        # writes are stronger domain evidence than reads
                        counts[lock] += 2 if a.write else 1
                lock = min(counts, key=lambda k: (-counts[k], k))
                written = any(a.write for a, _, _ in accs)
                dom = Domain(
                    cls, attr, lock,
                    guarded=sum(1 for _, h, _ in accs if lock in h),
                    unguarded=sum(1 for _, h, _ in accs if lock not in h),
                    written=written,
                    roots=frozenset().union(*(r for _, _, r in accs)),
                )
                self.domains.append(dom)
                domain_by_attr[attr] = dom
            # check-then-act and handoffs first: their findings claim
            # their lines so KBT301 does not double-report the access
            self._evaluate_check_acts(scan, domain_by_attr)
            self._evaluate_handoffs(scan)
            for attr, dom in domain_by_attr.items():
                if dom.written:
                    self._evaluate_attr(scan, dom, by_attr[attr])

    def _evaluate_check_acts(self, scan: ClassScan,
                             domain_by_attr: Dict[str, Domain]) -> None:
        mod = self.mod
        for ca in scan.check_acts:
            dom = domain_by_attr.get(ca.attr)
            if dom is None:
                continue
            test_held = mod.held_of(scan, ca.test_held, ca.extra_key)
            write_held = mod.held_of(scan, ca.write_held, ca.extra_key)
            if dom.lock in test_held or dom.lock in write_held:
                # guarded act.  The LAZY variant with a lock-free test and
                # a guarded write is the double-checked idiom — one torn-
                # proof reference peek, re-verified under the lock before
                # the write — so the peek line is sanctioned: claim it so
                # KBT301 doesn't re-report the read the idiom depends on.
                if (ca.lazy and dom.lock not in test_held
                        and dom.lock in write_held):
                    self._claimed.add((scan.name, ca.attr, ca.test_line))
                continue
            roots = mod.roots_of(ca.qual)
            others = [r for a in scan.accesses if a.attr == ca.attr
                      and not a.in_init
                      for r in (mod.roots_of(a.qual),)]
            if not any(_concurrent(roots, r) for r in others):
                continue
            rule = "KBT304" if ca.lazy else "KBT303"
            what = ("lazy init of" if ca.lazy else "check-then-act on")
            self.findings[rule].append((
                ca.test_line, ca.test_col,
                f"{what} shared `.{ca.attr}` outside its inferred domain "
                f"lock `self.{dom.lock}` — the test at line {ca.test_line} "
                f"and the write at line {ca.write_line} are both lock-free, "
                f"so two threads can interleave between them; hold "
                f"`self.{dom.lock}` around the check AND the act (or "
                f"annotate why this window is benign)",
            ))
            self._claimed.add((scan.name, ca.attr, ca.test_line))
            self._claimed.add((scan.name, ca.attr, ca.write_line))

    def _evaluate_attr(self, scan: ClassScan, dom: Domain, accs) -> None:
        claimed = self._claimed
        guarded = [(a, h, r) for a, h, r in accs if dom.lock in h]
        for a, h, roots in accs:
            if dom.lock in h:
                continue
            if (scan.name, a.attr, a.line) in claimed:
                continue  # a check-then-act finding owns this line
            witness = next(
                (g for g, _, gr in guarded if _concurrent(roots, gr)), None)
            if witness is None:
                continue  # same single root as every guarded access
            verb = "written" if a.write else "read"
            under = (f" (holds `self.{min(h)}` instead)" if h else
                     " without a lock")
            self.findings["KBT301"].append((
                a.line, a.col,
                f"`.{a.attr}` is guarded by `self.{dom.lock}` on another "
                f"thread root (e.g. line {witness.line}) but {verb} here"
                f"{under} — hold `self.{dom.lock}` or annotate why this "
                f"access cannot race",
            ))

    def _evaluate_handoffs(self, scan: ClassScan) -> None:
        mod = self.mod
        mutated = {a.attr for a in scan.accesses
                   if a.write and not a.in_init}
        if scan.container_attrs & mutated:
            for name, node in sorted(scan.methods.items()):
                info = mod.funcs.get(f"{scan.name}.{name}")
                if info is None:
                    continue
                walk_function(node, _HandoffVisitor(
                    mod, scan, info, scan.container_attrs & mutated))
        for h in scan.handoffs:
            self.findings["KBT302"].append((
                h.line, h.col,
                f"live container `.{h.attr}` handed to another thread by "
                f"reference (via {h.via}) while this class keeps mutating "
                f"it — snapshot the value at the handoff "
                f"(`dict(...)`/`list(...)`/`.copy()`) like the StatusFlush "
                f"double buffer, or annotate the ownership transfer",
            ))
            self._claimed.add((scan.name, h.attr, h.line))


# --------------------------------------------------------------------------
# the tier-D rules (engine plumbing: suppression, scoping, --select)
# --------------------------------------------------------------------------


class _TierDRule(Rule):
    rule_key = ""

    def check_ctx(self, ctx) -> Iterable[Tuple[int, int, str]]:
        analysis = race_context(ctx)
        if analysis is None:
            return ()
        return analysis.findings[self.rule_key]

    def check(self, tree, relpath):  # tier D is flow-only
        return ()


class LockDomainRule(_TierDRule):
    """The tier's core invariant — the Go scheduler guarded the whole cache
    under one mutex; the rebuild split that into per-plane locks, and each
    split is a chance for one access site to drift off its domain.
    Grounded in the JAX package's own catch: the replication publisher's
    ``encode_errors`` counter and the guard plane's ``bundles`` list were
    written by worker threads lock-free while readers held the owning lock
    — exactly the torn-read/lost-update class ``go test -race`` reports for
    the reference."""

    id = "KBT301"
    rule_key = "KBT301"
    title = "shared attribute accessed off its inferred lock domain"


class PublishHandoffRule(_TierDRule):
    """KBT302 also carries the original KBT012 contract (the pipelined
    writeback stage must only touch the value-snapshotted StatusFlush):
    same stage-function walk, now one rule owning every cross-thread
    publish.  KBT012 remains a ``--select`` alias."""

    id = "KBT302"
    rule_key = "KBT302"
    title = ("live mutable state published across threads without a "
             "value-snapshot handoff")

    #: the one structurally-known overlapped stage (the KBT012 instance)
    STAGE_FNS = {"run_status_flush", "_writeback"}
    STAGE_SCOPE = ("cache/cache.py", "scheduler.py")
    FORBIDDEN = {
        "jobs", "nodes", "pods", "queues", "pod_groups", "columns",
        "open_cache", "dirty", "fit_state_jobs",
    }
    ROOTS = {"self", "cache", "ssn", "session"}

    def check_ctx(self, ctx):
        yield from super().check_ctx(ctx)
        in_scope = any(ctx.relpath.startswith(p)
                       or f"/{p}" in f"/{ctx.relpath}"
                       for p in self.STAGE_SCOPE)
        if not in_scope:
            return
        from kube_batch_tpu_torch.analysis.rules import (
            _leftmost_name, _walk_skipping_defs,
        )
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name not in self.STAGE_FNS:
                continue
            for sub in _walk_skipping_defs(node.body):
                if not isinstance(sub, ast.Attribute):
                    continue
                if sub.attr not in self.FORBIDDEN:
                    continue
                if _leftmost_name(sub) not in self.ROOTS:
                    continue
                yield (sub.lineno, sub.col_offset,
                       f"writeback stage `{node.name}` reads live "
                       f"`.{sub.attr}` — the overlapped stage may only "
                       "touch the value-snapshotted StatusFlush handoff "
                       "(stage the read in stage_status_flush instead)")


class CheckThenActRule(_TierDRule):
    """A guarded attribute tested lock-free and then acted on lock-free is
    a TOCTOU window even when each individual access is atomic — the bug
    class behind the cache's historical arrival-timestamp stamp-then-apply
    race (now a documented GIL-atomic ``setdefault``): two threads both
    pass the test, both act, one update is lost.  Holding the domain lock
    across the test AND the act closes the window."""

    id = "KBT303"
    rule_key = "KBT303"
    title = "check-then-act on a shared attribute outside its guarding lock"


class LazyInitRule(_TierDRule):
    """Racy lazy init (``if self.x is None: self.x = build()``) without
    the domain lock builds the resource twice under contention — for this
    codebase that means two writeback pools or two compiled-executable
    tables, where the loser's copy leaks its worker thread.  The lazy
    ``is None`` shape is split out from KBT303 because its sanctioned
    repair differs: the double-checked idiom (lock-free peek, locked
    re-check + write) passes, where a generic check-then-act must move
    wholly under the lock."""

    id = "KBT304"
    rule_key = "KBT304"
    title = "unguarded lazy initialization of a shared attribute"


RACE_RULES: Tuple[Rule, ...] = (
    LockDomainRule(), PublishHandoffRule(), CheckThenActRule(),
    LazyInitRule(),
)
RACE_RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in RACE_RULES}


# --------------------------------------------------------------------------
# the --domains report + the corroborator's domain feed
# --------------------------------------------------------------------------


def module_domains(source: str, relpath: str) -> List[Domain]:
    """Inferred lock domains for one module's source ([] on syntax error —
    tier A owns reporting that)."""
    if _excluded(relpath):
        return []
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    return _RaceAnalysis(ModuleContext(tree, relpath)).domains


def domains_report(paths=None) -> str:
    """The reviewable per-class guarded-field map, package-wide."""
    from kube_batch_tpu_torch.analysis.engine import (
        _package_relpath, iter_python_files,
    )
    from pathlib import Path

    if not paths:
        roots = [Path(__file__).resolve().parent.parent]
    else:
        roots = [Path(p) for p in paths]
    lines: List[str] = [
        "# lock domains inferred by kbt-check tier D",
        "# attr -> domain lock [guarded/unguarded access counts] {roots}",
    ]
    for f in iter_python_files(roots):
        try:
            source = f.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        relpath = _package_relpath(f)
        doms = module_domains(source, relpath)
        if not doms:
            continue
        lines.append(f"{relpath}")
        by_cls: Dict[str, List[Domain]] = {}
        for d in doms:
            by_cls.setdefault(d.cls, []).append(d)
        for cls in sorted(by_cls):
            lines.append(f"  {cls}")
            for d in sorted(by_cls[cls], key=lambda d: d.attr):
                roots = ",".join(sorted(d.roots))
                rw = "rw" if d.written else "ro"
                lines.append(
                    f"    {d.attr:<24} -> {d.lock:<14} "
                    f"[{d.guarded}g/{d.unguarded}u {rw}] {{{roots}}}")
    return "\n".join(lines)


def runtime_domain_specs(structures) -> List[Tuple[str, str, str, str]]:
    """Resolve (module, class, attr) hot-structure triples against the
    STATIC inference: returns (module, class, attr, domain lock attr) for
    the lockdep corroborator.  Raising on a miss is the point — if the
    static map stops agreeing with the instrumented table, the two have
    drifted and the cross-validation is void."""
    from pathlib import Path

    pkg_root = Path(__file__).resolve().parent.parent
    out: List[Tuple[str, str, str, str]] = []
    for module, cls, attr in structures:
        rel = module.split("kube_batch_tpu_torch.", 1)[-1].replace(".", "/") + ".py"
        src = (pkg_root / rel).read_text()
        dom = next((d for d in module_domains(src, rel)
                    if d.cls == cls and d.attr == attr), None)
        if dom is None:
            raise LookupError(
                f"tier D infers no lock domain for {module}.{cls}.{attr} — "
                "the runtime corroborator table and the static map drifted")
        out.append((module, cls, attr, dom.lock))
    return out
