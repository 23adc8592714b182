"""Flow-aware analysis infrastructure for the tier-A engine (the JAX
package's ``analysis/dataflow.py``, kept as the port's own copy).

Line-local AST matchers cannot see the bugs a device-resident hot path
breeds — a solve result read back twice, a telemetry clock value leaking
into control flow, a live container handed to a worker.  `go vet` closes
this class for the Go reference with SSA-based passes; this module is the
sized-for-us analog:

- :class:`ImportTable` — import resolution: every local name bound by an
  ``import``/``from .. import`` anywhere in the module maps to its dotted
  origin, so a rule asks "does this call resolve to ``torch.cat``?" instead
  of string-matching on whatever alias the module happened to pick.
- :class:`ModuleContext` — the per-module symbol table the engine builds
  once and shares across every flow rule: the parsed tree, resolved
  imports, last top-level binding per module-global name, and the flat
  list of function bodies to analyze.
- :func:`walk_function` — intra-procedural def-use tracking: an ordered
  walk of one function body in evaluation order, maintaining a name →
  *cell* environment.  A cell models the underlying buffer/value: plain
  ``y = x`` aliasing shares x's cell, any other assignment rebinds to a
  fresh cell — so taint set through one name is visible through its
  aliases and cleared by reassignment.  Branches fork the environment and
  merge may-style (a taint set in either branch survives the join); loop
  bodies run twice so state created at the bottom of an iteration is
  observed by reads at the top of the next.

Deliberately intra-procedural (the `go vet` passes this mirrors are too):
a value escaping into an attribute, a return, or a foreign call is treated
as leaving the analysis — rules stay conservative there and rely on the
suppression contract for the rare annotated escape.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

# --------------------------------------------------------------------------
# import resolution
# --------------------------------------------------------------------------


class ImportTable:
    """Local name → dotted origin for every import binding in the module.

    ``import torch`` binds ``torch → torch``; ``import numpy as np`` binds
    ``np → numpy``; ``from torch import cat as C`` binds ``C → torch.cat``.
    Function-local imports count too — the resolution is name-based, which
    is exact enough for lint purposes (shadowing an import with a local
    variable of the same name is its own smell)."""

    def __init__(self, tree: ast.Module):
        self.names: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.names[alias.asname] = alias.name
                    else:
                        # `import a.b` binds the TOP name `a` to module `a`
                        top = alias.name.split(".")[0]
                        self.names[top] = top
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    bound = alias.asname or alias.name
                    self.names[bound] = f"{node.module}.{alias.name}"

    def dotted(self, node: ast.AST) -> str:
        """Canonical dotted path of a Name/Attribute chain, resolved through
        the import table (``np.asarray`` → ``numpy.asarray``). Empty string
        when the base is not an imported name (a local variable, a call
        result, ...)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return ""
        base = self.names.get(node.id)
        if base is None:
            return ""
        parts.append(base)
        return ".".join(reversed(parts))


# --------------------------------------------------------------------------
# module symbol table
# --------------------------------------------------------------------------


class ModuleContext:
    """Everything the flow rules need about one module, built once per file
    by the engine and shared across rules (five rules re-walking the tree
    for imports would be pure waste at package scale)."""

    def __init__(self, tree: ast.Module, relpath: str):
        self.tree = tree
        self.relpath = relpath
        self.imports = ImportTable(tree)
        #: last top-level assignment expression per module-global name
        #: (descending through If/Try at module level, the KBT003 idiom)
        self.module_assigns: Dict[str, ast.expr] = {}
        #: every function/method body in the module (nested defs included —
        #: each is analyzed as its own scope)
        self.functions: List[ast.FunctionDef] = []
        stack: List[ast.AST] = list(tree.body)
        while stack:
            node = stack.pop(0)
            if isinstance(node, (ast.If, ast.Try)):
                stack = list(ast.iter_child_nodes(node)) + stack
                continue
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module_assigns[t.id] = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                if isinstance(node.target, ast.Name):
                    self.module_assigns[node.target.id] = node.value
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.append(node)

    def resolve_call(self, call: ast.Call) -> str:
        """Dotted origin of a call's callee ('' when unresolvable)."""
        return self.imports.dotted(call.func)


# --------------------------------------------------------------------------
# intra-procedural def-use walk
# --------------------------------------------------------------------------

#: a cell is the mutable record shared by every alias of one value; rules
#: stash taint under their own keys ("telemetry", "device", ...)
Cell = Dict[str, object]


@dataclasses.dataclass
class FlowEvent:
    """One observation during the walk, in evaluation order."""

    kind: str               # "load" | "call" | "bind"
    node: ast.AST
    name: str = ""          # load/bind: the Name involved
    cell: Optional[Cell] = None
    #: enclosing expression contexts, outermost first — e.g. ("test",
    #: "compare") for a load inside `while a - b > x:`
    where: Tuple[str, ...] = ()


class FlowVisitor:
    """Subclass hooks for :func:`walk_function`.  All hooks receive the
    live environment so they can read/alias/taint cells."""

    def on_load(self, ev: FlowEvent, env: Dict[str, Cell]) -> None: ...

    def on_call(self, ev: FlowEvent, env: Dict[str, Cell]) -> None: ...

    def on_bind(self, ev: FlowEvent, env: Dict[str, Cell],
                value: Optional[ast.expr]) -> None:
        """After the default binding action (alias copy or fresh cell)."""


def _merge_envs(base: Dict[str, Cell], forks: List[Dict[str, Cell]]) -> Dict[str, Cell]:
    """May-style join: a name maps to its fork cell when all forks agree,
    else to a fresh union cell carrying every fork's taint keys (so taint
    set in either branch survives; a clean rebind in ONE branch does not
    launder taint flowing around it)."""
    names: Set[str] = set(base)
    for f in forks:
        names.update(f)
    out: Dict[str, Cell] = {}
    for name in names:
        cells = [f[name] for f in forks if name in f]
        if name in base:
            cells.append(base[name])
        first = cells[0]
        if all(c is first for c in cells):
            out[name] = first
            continue
        union: Cell = {}
        for c in cells:
            union.update(c)
        out[name] = union
    return out


class _Walker:
    def __init__(self, visitor: FlowVisitor):
        self.v = visitor

    # -- expressions ------------------------------------------------------
    def expr(self, node: ast.AST, env: Dict[str, Cell],
             where: Tuple[str, ...]) -> None:
        if node is None or isinstance(node, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.Lambda, ast.ClassDef)):
            return  # nested scopes run later, elsewhere
        inner = where
        if isinstance(node, ast.Compare):
            inner = where + ("compare",)
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            self.v.on_load(
                FlowEvent("load", node, name=node.id, cell=env.get(node.id),
                          where=where), env)
            return
        for child in ast.iter_child_nodes(node):
            self.expr(child, env, inner)
        if isinstance(node, ast.Call):
            self.v.on_call(FlowEvent("call", node, where=where), env)

    # -- binding ----------------------------------------------------------
    def bind(self, target: ast.AST, value: Optional[ast.expr],
             env: Dict[str, Cell]) -> None:
        if isinstance(target, ast.Name):
            if isinstance(value, ast.Name) and value.id in env:
                env[target.id] = env[value.id]  # alias: share the cell
            else:
                env[target.id] = {}
            self.v.on_bind(
                FlowEvent("bind", target, name=target.id,
                          cell=env[target.id]), env, value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts_v = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                      and len(value.elts) == len(target.elts) else None)
            for i, t in enumerate(target.elts):
                # element-wise when shapes line up; otherwise every element
                # binds against the whole RHS (conservative: unpacking a
                # tainted call taints every target name)
                self.bind(t, elts_v[i] if elts_v else value, env)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, None, env)
        # attribute/subscript stores don't (re)bind a local name; the value
        # escaped — rules observe that through on_call/on_load if they care

    # -- statements -------------------------------------------------------
    def body(self, stmts: Iterable[ast.stmt], env: Dict[str, Cell]) -> None:
        for s in stmts:
            self.stmt(s, env)

    def stmt(self, s: ast.stmt, env: Dict[str, Cell]) -> None:
        if isinstance(s, ast.Assign):
            self.expr(s.value, env, ())
            for t in s.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    self.expr(t, env, ("store",))
                self.bind(t, s.value, env)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.expr(s.value, env, ())
                self.bind(s.target, s.value, env)
        elif isinstance(s, ast.AugAssign):
            self.expr(s.value, env, ())
            # target is read-modify-write: observe the read, keep the cell
            self.expr(ast.copy_location(
                ast.Name(id=s.target.id, ctx=ast.Load()), s.target)
                if isinstance(s.target, ast.Name) else s.target, env, ())
        elif isinstance(s, (ast.Expr, ast.Return)):
            self.expr(s.value, env, ())
        elif isinstance(s, ast.If):
            self.expr(s.test, env, ("test",))
            fork_a = dict(env)
            self.body(s.body, fork_a)
            fork_b = dict(env)
            self.body(s.orelse, fork_b)
            merged = _merge_envs(env, [fork_a, fork_b])
            env.clear()
            env.update(merged)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            self.expr(s.iter, env, ())
            # two passes: taint created at the bottom of the body reaches
            # reads at the top on the second iteration
            for _ in range(2):
                self.bind(s.target, None, env)
                self.body(s.body, env)
            self.body(s.orelse, env)
        elif isinstance(s, ast.While):
            for _ in range(2):
                self.expr(s.test, env, ("test",))
                self.body(s.body, env)
            self.body(s.orelse, env)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self.expr(item.context_expr, env, ())
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, None, env)
            self.body(s.body, env)
        elif isinstance(s, ast.Try):
            self.body(s.body, env)
            for h in s.handlers:
                fork = dict(env)
                if h.name:
                    fork[h.name] = {}
                self.body(h.body, fork)
                merged = _merge_envs(env, [fork])
                env.clear()
                env.update(merged)
            self.body(s.orelse, env)
            self.body(s.finalbody, env)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            return  # separate scope
        elif isinstance(s, ast.Match):
            self.expr(s.subject, env, ())
            forks: List[Dict[str, Cell]] = []
            for case in s.cases:
                fork = dict(env)
                # pattern captures (MatchAs/MatchStar names, MatchMapping
                # rest) bind fresh cells in the arm's scope
                for p in ast.walk(case.pattern):
                    name = getattr(p, "name", None) or getattr(p, "rest", None)
                    if isinstance(name, str):
                        fork[name] = {}
                if case.guard is not None:
                    self.expr(case.guard, fork, ("test",))
                self.body(case.body, fork)
                forks.append(fork)
            merged = _merge_envs(env, forks)
            env.clear()
            env.update(merged)
        elif isinstance(s, (ast.Raise, ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(s):
                self.expr(child, env, ())
            if isinstance(s, ast.Delete):
                for t in s.targets:
                    if isinstance(t, ast.Name):
                        env.pop(t.id, None)
        # Pass/Break/Continue/Global/Nonlocal/Import: nothing to track


def walk_function(func: ast.AST, visitor: FlowVisitor) -> None:
    """Run `visitor` over one function body in evaluation order (module
    docstring has the semantics: alias cells, may-merge joins, two-pass
    loops).  Parameters start with fresh cells so loads of them resolve."""
    env: Dict[str, Cell] = {}
    args = func.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        env[a.arg] = {}
    _Walker(visitor).body(func.body, env)


# --------------------------------------------------------------------------
# shared small helpers (used by the flow rules)
# --------------------------------------------------------------------------


def call_keyword(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None
