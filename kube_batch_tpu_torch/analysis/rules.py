"""Tier A's line-local rules (the JAX package's ``analysis/rules.py``,
kept as the port's own copy).  Every rule is grounded in a bug the JAX
package actually shipped; the historical incident is named in each
docstring.  KBT005 reads the torch idiom instead of the JAX one.

Rules report (line, col, message) triples; scoping and suppression live in
the engine.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from kube_batch_tpu_torch.analysis.engine import Rule

# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------


def _leftmost_name(node: ast.AST) -> str:
    """Base identifier of an attribute chain (``a.b.c()`` → ``a``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _terminal_name(node: ast.AST) -> str:
    """Rightmost identifier (``self._lock`` → ``_lock``; ``lock`` → ``lock``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


class _ImportMap(ast.NodeVisitor):
    """Names bound to the time/datetime/numpy/urllib modules anywhere in the
    module (top-level or function-local imports both count)."""

    def __init__(self) -> None:
        self.time_names: Set[str] = set()
        self.datetime_names: Set[str] = set()  # module or datetime class
        self.numpy_names: Set[str] = set()
        self.urllib_names: Set[str] = set()  # urllib / urllib.request module
        # from-imports of individual wall-clock / blocking callables:
        # local name → original attribute name
        self.from_time: Dict[str, str] = {}
        self.from_urllib: Set[str] = set()

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            bound = alias.asname or alias.name.split(".")[0]
            if alias.name == "time":
                self.time_names.add(bound)
            elif alias.name == "datetime":
                self.datetime_names.add(bound)
            elif alias.name == "numpy":
                self.numpy_names.add(bound)
            elif alias.name in ("urllib", "urllib.request"):
                self.urllib_names.add(bound)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "time":
            for alias in node.names:
                self.from_time[alias.asname or alias.name] = alias.name
        elif node.module == "datetime":
            for alias in node.names:
                if alias.name == "datetime":
                    self.datetime_names.add(alias.asname or alias.name)
        elif node.module == "numpy":
            for alias in node.names:
                if alias.name in ("asarray", "array"):
                    self.numpy_names.add(alias.asname or alias.name)
        elif node.module in ("urllib.request", "urllib"):
            for alias in node.names:
                if alias.name in ("urlopen", "request"):
                    self.from_urllib.add(alias.asname or alias.name)


def _walk_skipping_defs(body: Iterable[ast.AST]) -> Iterable[ast.AST]:
    """Yield statements/expressions lexically in ``body`` without descending
    into nested function/class bodies (their code runs later, elsewhere)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# --------------------------------------------------------------------------
# KBT001 — wall clock outside the Clock seam
# --------------------------------------------------------------------------


class WallClockRule(Rule):
    """Historical bug: the simulator needed a clock seam because the
    Scheduler loop read `time` directly; any direct wall-clock call in the
    scheduler/actions/cache/sim/framework paths silently breaks virtual-time
    replay determinism again. Telemetry that deliberately measures real
    compute (perf_counter spans feeding metrics) stays — annotated."""

    id = "KBT001"
    title = "wall-clock call outside the Clock seam"
    scope = ("scheduler.py", "actions/", "cache/", "sim/", "framework/")

    TIME_ATTRS = {
        "time", "monotonic", "sleep", "perf_counter", "process_time",
        "time_ns", "monotonic_ns", "perf_counter_ns",
    }
    DATETIME_ATTRS = {"now", "utcnow", "today"}

    def check(self, tree: ast.Module, relpath: str):
        imports = _ImportMap()
        imports.visit(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute):
                base = _leftmost_name(func)
                if base in imports.time_names and func.attr in self.TIME_ATTRS:
                    yield (node.lineno, node.col_offset,
                           f"wall-clock call `{base}.{func.attr}()` in a "
                           "clock-seamed path; read the injected clock "
                           "(Scheduler.clock / sim VirtualClock) instead")
                elif (base in imports.datetime_names
                        and func.attr in self.DATETIME_ATTRS):
                    yield (node.lineno, node.col_offset,
                           f"wall-clock call `{base}.{func.attr}()` in a "
                           "clock-seamed path; carry timestamps through the "
                           "injected clock")
            elif isinstance(func, ast.Name):
                orig = imports.from_time.get(func.id)
                if orig in self.TIME_ATTRS:
                    yield (node.lineno, node.col_offset,
                           f"wall-clock call `{func.id}()` (time.{orig}) in a "
                           "clock-seamed path; read the injected clock instead")


# --------------------------------------------------------------------------
# KBT002 — blocking call inside a lock body
# --------------------------------------------------------------------------


class BlockingUnderLockRule(Rule):
    """Historical bug: TokenBucket.take() slept while holding its lock, so
    concurrent waiters (the 16-worker status pool, the binder, the pv-writes
    thread) serialized behind whoever slept first. Any
    call that can block for I/O or scheduling latency inside a
    `with <lock>:` body stalls every other thread contending for that lock."""

    id = "KBT002"
    title = "blocking call while holding a lock"
    scope = ()  # package-wide

    # attribute calls that block regardless of receiver
    BLOCKING_ATTRS = {
        "sleep", "result", "wait", "urlopen", "getresponse", "recv",
        "recvfrom", "accept", "connect", "sendall", "select", "serve_forever",
    }
    # attribute calls that block only on specific receivers (heuristic on the
    # receiver's terminal identifier)
    CONDITIONAL_ATTRS = {
        "get": ("queue", "q"),            # queue.Queue.get, not dict.get
        "join": ("thread", "pool", "proc", "writer"),
        "take": ("bucket",),              # TokenBucket.take may sleep
        "request": ("transport", "conn", "session"),
        "shutdown": ("pool", "executor", "writer"),
    }

    @staticmethod
    def _lockish(expr: ast.AST) -> bool:
        name = _terminal_name(expr).lower()
        return "lock" in name or "mutex" in name

    def _blocking_call(self, call: ast.Call, imports: _ImportMap):
        func = call.func
        if isinstance(func, ast.Attribute):
            recv = _terminal_name(func.value).lower()
            if func.attr in self.BLOCKING_ATTRS:
                return f"`.{func.attr}()`"
            hints = self.CONDITIONAL_ATTRS.get(func.attr)
            if hints and any(h in recv for h in hints if h != "q"):
                return f"`{recv}.{func.attr}()`"
            if hints and recv in hints:  # exact match (the bare `q`)
                return f"`{recv}.{func.attr}()`"
        elif isinstance(func, ast.Name):
            if imports.from_time.get(func.id) == "sleep" or func.id == "sleep":
                return f"`{func.id}()`"
            if func.id in imports.from_urllib:
                return f"`{func.id}()`"
        return None

    def check(self, tree: ast.Module, relpath: str):
        imports = _ImportMap()
        imports.visit(tree)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(self._lockish(item.context_expr) for item in node.items):
                continue
            lock_name = next(
                _terminal_name(i.context_expr)
                for i in node.items if self._lockish(i.context_expr)
            )
            for inner in _walk_skipping_defs(node.body):
                if not isinstance(inner, ast.Call):
                    continue
                what = self._blocking_call(inner, imports)
                if what is not None:
                    yield (inner.lineno, inner.col_offset,
                           f"blocking call {what} inside `with {lock_name}:`; "
                           "reserve state under the lock and block outside it "
                           "(the TokenBucket.take pattern)")


# --------------------------------------------------------------------------
# KBT003 — module-level mutable state in actions/ and framework/
# --------------------------------------------------------------------------


class ModuleStateRule(Rule):
    """Historical bug: allocate published its per-cycle host-discard count in
    a module global that backfill read — a process-global carrying a
    per-session signal, wrong the moment two schedulers/sessions share the
    interpreter (the fix moved it onto the Session).
    Import-time registries are legitimate — annotate them as such."""

    id = "KBT003"
    title = "module-level mutable state in actions/framework"
    scope = ("actions/", "framework/")

    MUTABLE_FACTORIES = {
        "dict", "list", "set", "defaultdict", "deque", "Counter",
        "OrderedDict",
    }

    def _mutable_value(self, value: ast.AST) -> str:
        if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)):
            return type(value).__name__.lower()
        if isinstance(value, ast.Call):
            name = _terminal_name(value.func)
            if name in self.MUTABLE_FACTORIES:
                return f"{name}()"
        return ""

    @staticmethod
    def _constant_name(name: str) -> bool:
        return name.upper() == name or name.startswith("__")

    def _top_level_statements(self, tree: ast.Module):
        """Module body, descending through If/Try but not into defs."""
        stack = list(tree.body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.If, ast.Try)):
                stack.extend(ast.iter_child_nodes(node))

    def check(self, tree: ast.Module, relpath: str):
        for node in self._top_level_statements(tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = [t for t in node.targets if isinstance(t, ast.Name)]
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target] if isinstance(node.target, ast.Name) else []
                value = node.value
            else:
                continue
            kind = self._mutable_value(value)
            if not kind:
                continue
            for t in targets:
                if self._constant_name(t.id):
                    continue
                yield (node.lineno, node.col_offset,
                       f"module-level mutable {kind} `{t.id}` can carry "
                       "per-session/per-cycle state across cycles and "
                       "schedulers; move it onto the Session (the "
                       "last_host_discards fix) or annotate it as an "
                       "import-time registry")
        # writes to module globals from function bodies are the same bug in
        # verb form — the allocate→backfill signal was exactly this
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                yield (node.lineno, node.col_offset,
                       f"`global {', '.join(node.names)}` write from a "
                       "function in actions/framework; per-cycle signals "
                       "belong on the Session")


# --------------------------------------------------------------------------
# KBT004 — fail-open defaults in the translate layer
# --------------------------------------------------------------------------


class FailOpenTranslateRule(Rule):
    """Historical bug: unrecognized PV nodeAffinity translated to node=None
    ("reachable from every node"), letting --master mode bind pods onto
    nodes that could not attach the volume. In the
    translate layer, a None/empty return on unrecognized input is a policy
    decision to fail open — it must be written down or fail closed."""

    id = "KBT004"
    title = "translate-layer fail-open default return"
    scope = ("k8s/translate.py", "api/serialize.py")

    @staticmethod
    def _is_failopen_value(value) -> str:
        if value is None:
            return "bare `return`"
        if isinstance(value, ast.Constant):
            if value.value is None:
                return "`return None`"
            if value.value == "":
                return '`return ""`'
        if isinstance(value, (ast.List, ast.Tuple, ast.Set)) and not value.elts:
            return "empty-collection return"
        if isinstance(value, ast.Dict) and not value.keys:
            return "empty-dict return"
        if (isinstance(value, ast.Call) and not value.args
                and not value.keywords
                and _terminal_name(value.func) in ("dict", "list", "tuple", "set")):
            return f"`return {_terminal_name(value.func)}()`"
        return ""

    def check(self, tree: ast.Module, relpath: str):
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            returns = [
                n for n in _walk_skipping_defs(node.body)
                if isinstance(n, ast.Return)
            ]
            # procedures (every return valueless/None) aren't translators
            # with a fail-open default — only value-producing functions are
            if not any(not self._is_failopen_value(r.value) for r in returns):
                continue
            for r in returns:
                what = self._is_failopen_value(r.value)
                if what:
                    yield (r.lineno, r.col_offset,
                           f"{what} in translate-layer `{node.name}` is a "
                           "fail-open default on unrecognized input; fail "
                           "closed (sentinel / raise) or annotate why open "
                           "is sound")


# --------------------------------------------------------------------------
# KBT005 — host-device sync in ops/ hot paths
# --------------------------------------------------------------------------


class HostSyncRule(Rule):
    """Guards the cycle budget on the card: a host-device sync inside ops/
    (``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``np.asarray`` on a
    tensor, ``int()``/``float()`` materialization) stalls the device
    pipeline, and a Python loop that dispatches tensor work pays one launch
    (or more) per iteration.  Deliberate sync points (a solve's readback)
    are annotated at the call; a deliberate loop (a static unroll over a
    small axis) is annotated once, at its header.

    A sync is reported at its call.  A loop is reported once, at the header
    of the outermost loop of its nest, when its body (or a while loop's
    test) dispatches any tensor work: a ``torch.*`` call, a method of a
    tensor, an operator or an index on a tensor, an in-place update of one,
    or iteration over one.  What is a tensor is inferred inside each
    function, as tier A infers everything: a parameter annotated
    ``Tensor``, a name bound to a ``torch.*`` call, to a method only a
    tensor carries, or to an operator, index or method over a tensor; a
    closure sees its enclosing function's tensors.  A value that reaches a
    function only through an unannotated parameter or an attribute is not
    seen until such a binding names it.

    A bidding-round loop — a loop whose test or body reads back through
    ``utils.seams.round_end`` — dispatches its round on purpose: the JAX
    package's ``lax.while_loop`` became a Python loop with one readback a
    round, and tier B's per-round sync budget (KBT103, ``program_audit``)
    is what governs it.  So such a loop, and every loop inside it, is not
    reported as a loop; every sync in it other than ``round_end`` still
    is."""

    id = "KBT005"
    title = "host-device sync in ops/ hot path"
    scope = ("ops/",)

    SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
    #: torch calls that dispatch no device work (handles, shapes, dtypes)
    NON_DISPATCH = {
        "torch.device", "torch.Size", "torch.dtype", "torch.finfo",
        "torch.iinfo", "torch.is_tensor", "torch.no_grad",
        "torch.inference_mode", "torch.get_default_dtype",
    }
    #: tensor methods that read metadata: no dispatch, and no tensor back
    METADATA_METHODS = {
        "size", "dim", "numel", "nelement", "stride", "data_ptr",
        "is_contiguous", "element_size", "get_device",
    }
    #: methods that only a tensor carries among the values ops/ code holds
    #: (numpy's shared names — sum, any, max, reshape — are left out; a
    #: method whose name ends in one ``_`` is an in-place tensor method too)
    TENSOR_METHODS = {
        "amax", "amin", "bool", "clamp", "clamp_max", "clamp_min", "clone",
        "contiguous", "double", "expand", "expand_as", "float", "gather",
        "half", "index_select", "int", "long", "masked_fill", "narrow",
        "new_empty", "new_full", "new_ones", "new_tensor", "new_zeros",
        "permute", "scatter", "scatter_add", "scatter_reduce", "to",
        "topk", "type_as", "unsqueeze", "view_as",
    }
    #: attributes that are tensors of a tensor
    TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag"}
    ROUND_END = "utils.seams.round_end"

    def _is_round_end(self, call: ast.Call, ctx) -> bool:
        dotted = ctx.imports.dotted(call.func)
        if dotted.endswith(self.ROUND_END):
            return True
        return isinstance(call.func, ast.Name) and call.func.id == "round_end"

    def _bidding(self, loop: ast.AST, ctx) -> bool:
        parts = list(loop.body) + ([loop.test] if isinstance(loop, ast.While) else [])
        return any(isinstance(n, ast.Call) and self._is_round_end(n, ctx)
                   for n in _walk_skipping_defs(parts))

    # -- what is a tensor --------------------------------------------------
    def _torch_call(self, call: ast.Call, ctx) -> str:
        dotted = ctx.imports.dotted(call.func)
        if dotted.startswith("torch.") and dotted not in self.NON_DISPATCH:
            return dotted
        return ""

    def _tensor_method(self, name: str) -> bool:
        return name in self.TENSOR_METHODS or (
            name.endswith("_") and not name.endswith("__") and not name.startswith("_"))

    def _tensor(self, e: ast.AST, names: Set[str], ctx) -> bool:
        """``e`` evaluates to a tensor, as far as the function shows."""
        if isinstance(e, ast.Name):
            return e.id in names
        if isinstance(e, ast.Call):
            if self._torch_call(e, ctx):
                return True
            f = e.func
            if isinstance(f, ast.Attribute) and f.attr not in self.METADATA_METHODS \
                    and f.attr not in self.SYNC_ATTRS:
                return self._tensor_method(f.attr) or self._tensor(f.value, names, ctx)
            return False
        if isinstance(e, ast.BinOp):
            return self._tensor(e.left, names, ctx) or self._tensor(e.right, names, ctx)
        if isinstance(e, ast.UnaryOp):
            return self._tensor(e.operand, names, ctx)
        if isinstance(e, ast.Compare):
            return any(self._tensor(x, names, ctx) for x in [e.left, *e.comparators])
        if isinstance(e, ast.Subscript):
            return self._tensor(e.value, names, ctx)
        if isinstance(e, ast.Attribute):
            return e.attr in self.TENSOR_ATTRS and self._tensor(e.value, names, ctx)
        if isinstance(e, ast.IfExp):
            return self._tensor(e.body, names, ctx) or self._tensor(e.orelse, names, ctx)
        return False

    def _tensor_names(self, scope: ast.AST, outer: Set[str], ctx) -> Set[str]:
        """The names bound to tensors in ``scope`` (a function or the
        module), over ``outer`` (its enclosing function's)."""
        names = set(outer)
        args = getattr(scope, "args", None)
        if args is not None:
            for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
                if a.annotation is not None and "Tensor" in ast.unparse(a.annotation):
                    names.add(a.arg)
        binds = []
        for n in _walk_skipping_defs(scope.body):
            if isinstance(n, ast.Assign):
                binds.extend((t, n.value) for t in n.targets)
            elif isinstance(n, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)) \
                    and n.value is not None:
                binds.append((n.target, n.value))
            elif isinstance(n, (ast.For, ast.AsyncFor)):
                binds.append((n.target, n.iter))
        changed = True
        while changed:
            changed = False
            for target, value in binds:
                if not self._tensor(value, names, ctx):
                    continue
                for t in ast.walk(target):
                    if isinstance(t, ast.Name) and t.id not in names:
                        names.add(t.id)
                        changed = True
        return names

    def _work(self, n: ast.AST, names: Set[str], ctx) -> str:
        """What tensor work ``n`` itself dispatches, or ``""``."""
        if isinstance(n, ast.Call):
            dotted = self._torch_call(n, ctx)
            if dotted:
                return f"`{dotted}`"
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr not in self.METADATA_METHODS and (
                    self._tensor_method(f.attr) or self._tensor(f.value, names, ctx)):
                return f"`.{f.attr}()`"
        elif isinstance(n, (ast.BinOp, ast.UnaryOp, ast.Compare)):
            if self._tensor(n, names, ctx):
                return "an operator on a tensor"
        elif isinstance(n, ast.Subscript):
            if self._tensor(n.value, names, ctx):
                return "indexing a tensor"
        elif isinstance(n, ast.AugAssign):
            if self._tensor(n.target, names, ctx) or self._tensor(n.value, names, ctx):
                return "an in-place operator on a tensor"
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            if self._tensor(n.iter, names, ctx):
                return "iterating over a tensor"
        return ""

    def _loop_work(self, loop: ast.AST, names: Set[str], ctx) -> Tuple[int, str]:
        """(line, what) of the first tensor work a loop runs per iteration
        — its body, a while loop's test, iteration over a tensor — skipping
        nested definitions and bidding-round loops; (0, "") when none."""
        found: List[Tuple[int, str]] = []
        what = self._work(loop, names, ctx)
        if what:
            found.append((loop.lineno, what))
        stack = list(loop.body) + ([loop.test] if isinstance(loop, ast.While) else [])
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                              ast.ClassDef)):
                continue
            if (isinstance(n, (ast.For, ast.AsyncFor, ast.While))
                    and self._bidding(n, ctx)):
                continue
            what = self._work(n, names, ctx)
            if what:
                found.append((getattr(n, "lineno", loop.lineno), what))
            stack.extend(ast.iter_child_nodes(n))
        return min(found) if found else (0, "")

    def check_ctx(self, ctx):
        out: List[Tuple[int, int, str]] = []

        def visit(node: ast.AST, loop: str, names: Set[str]) -> None:
            # loop: "" outside any loop, "plain", or "bidding" (sticky)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names = self._tensor_names(node, names, ctx)
                loop = ""
            elif isinstance(node, ast.Lambda):
                loop = ""
            if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                bidding = loop == "bidding" or self._bidding(node, ctx)
                if not bidding and loop == "":
                    line, what = self._loop_work(node, names, ctx)
                    if what:
                        out.append((node.lineno, node.col_offset,
                                    f"Python loop in ops/ dispatches tensor work "
                                    f"every iteration ({what}, line {line}); "
                                    "vectorize, or annotate the loop header "
                                    "(a bidding-round loop that reads back "
                                    "through utils.seams.round_end is exempt: "
                                    "tier B's per-round budget governs it)"))
                inner = "bidding" if bidding else "plain"
                if isinstance(node, ast.While):
                    visit(node.test, inner, names)
                else:
                    visit(node.target, loop, names)
                    visit(node.iter, loop, names)
                for s in node.body:
                    visit(s, inner, names)
                for s in node.orelse:
                    visit(s, loop, names)
                return
            if isinstance(node, ast.Call):
                self._sync(node, ctx, out)
            for child in ast.iter_child_nodes(node):
                visit(child, loop, names)

        visit(ctx.tree, "", self._tensor_names(ctx.tree, set(), ctx))
        return out

    def _sync(self, node: ast.Call, ctx, out) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in self.SYNC_ATTRS:
                out.append((node.lineno, node.col_offset,
                            f"`.{func.attr}()` forces a host-device sync in an "
                            "ops/ hot path; keep results on device or annotate "
                            "the sync point"))
                return
            dotted = ctx.imports.dotted(func)
            if dotted in ("numpy.asarray", "numpy.array"):
                base = _leftmost_name(func)
                out.append((node.lineno, node.col_offset,
                            f"`{base}.{func.attr}()` materializes device data "
                            "on host in an ops/ hot path; stay in torch or "
                            "annotate the sync point"))
        elif isinstance(func, ast.Name) and func.id in ("float", "int"):
            arg = node.args[0] if node.args else None
            if isinstance(arg, (ast.Name, ast.Subscript)):
                out.append((node.lineno, node.col_offset,
                            f"`{func.id}()` on a tensor value forces a "
                            "host-device sync in an ops/ hot path; keep the "
                            "value on device or annotate the sync point"))


# --------------------------------------------------------------------------
# KBT011 — raw transport / ad-hoc retry loop outside k8s/transport.py
# --------------------------------------------------------------------------


class RawTransportRule(Rule):
    """Historical bug: the watch loop hand-rolled a jitterless 1→30s
    doubling backoff while `ApiTransport.request()` had no retry policy at
    all — every apiserver caller invented its own (or no) failure handling.
    The transport centralized classification, capped decorrelated-jitter
    backoff, per-endpoint-class budgets, and the circuit breaker in
    k8s/transport.py; this rule keeps it that way: a raw
    `urllib.request.urlopen` or an ad-hoc `time.sleep` retry loop anywhere
    else in k8s//cmd/ bypasses the classified policy (and the breaker's
    fail-fast), so every apiserver call is forced through the transport."""

    id = "KBT011"
    title = "raw urllib / ad-hoc sleep retry loop outside the transport"
    scope = ("k8s/", "cmd/")

    @staticmethod
    def _exempt(relpath: str) -> bool:
        # the transport module IS the sanctioned home of urlopen + backoff
        return relpath.endswith("k8s/transport.py") or relpath == "transport.py"

    def check(self, tree: ast.Module, relpath: str):
        if self._exempt(relpath):
            return
        imports = _ImportMap()
        imports.visit(tree)
        # lexical spans of loop bodies (retry loops hide sleeps in them)
        loop_spans: List[Tuple[int, int]] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.For, ast.While)):
                lines = [
                    getattr(n, "end_lineno", None) or n.lineno
                    for n in _walk_skipping_defs(node.body)
                    if hasattr(n, "lineno")
                ]
                if lines:
                    loop_spans.append((node.body[0].lineno, max(lines)))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            is_urlopen = False
            is_sleep = False
            if isinstance(func, ast.Attribute):
                base = _leftmost_name(func)
                if func.attr == "urlopen" and base in imports.urllib_names:
                    is_urlopen = True
                elif func.attr == "sleep" and base in imports.time_names:
                    is_sleep = True
            elif isinstance(func, ast.Name):
                if func.id in imports.from_urllib and func.id == "urlopen":
                    is_urlopen = True
                elif imports.from_time.get(func.id) == "sleep":
                    is_sleep = True
            if is_urlopen:
                yield (node.lineno, node.col_offset,
                       "raw `urlopen()` outside k8s/transport.py bypasses "
                       "the classified retry policy and the circuit "
                       "breaker; route the call through ApiTransport")
            elif is_sleep and any(
                lo <= node.lineno <= hi for lo, hi in loop_spans
            ):
                yield (node.lineno, node.col_offset,
                       "ad-hoc sleep inside a loop looks like a hand-rolled "
                       "retry/backoff; use the transport's RetryPolicy "
                       "(decorrelated jitter, budgets) or annotate why this "
                       "pacing is not a retry")


# --------------------------------------------------------------------------
# KBT012 — MOVED: the pipeline writeback-stage handoff contract is now a
# KBT302 instance (analysis/races.py PublishHandoffRule — the generalized
# publish-then-mutate rule owns the one hardcoded case it grew from).
# `--select KBT012` still works via RULE_ALIASES in races.py.
# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# KBT013 — bind/evict dispatch site without a sentinel-verdict consumer
# --------------------------------------------------------------------------


class SentinelConsumeRule(Rule):
    """Guard for the result-integrity plane (guard/): every
    action-layer function that dispatches a committed solve — the programs
    whose results become real binds and evictions — must consume the fused
    sentinel's verdict through ``GuardPlane.consume_verdict`` before acting
    on the result.  A dispatch site added without the consumer silently
    re-opens the exact hole the guard plane closed: a condemned solve's
    placements would flow to the binder with zero detection.  The bug
    class is structural (a future action or refactor forgetting the
    verdict), so the rule is structural too: a function in actions/ that
    calls a solve dispatch and never calls a verdict consumer reports.
    ``dispatch_*``-named helpers are the sanctioned SEAM layer: they
    return the un-consumed sentinel to their caller and are skipped here —
    but their names sit in DISPATCH_FNS, so every CALL SITE of the seam is
    still held to the consumer requirement."""

    id = "KBT013"
    title = "solve dispatch without a sentinel-verdict consumer"
    scope = ("actions/",)

    #: callables whose results become binds/evictions — the committed
    #: solve dispatch surface (single-device, sharded, and the actions'
    #: own dispatch helpers)
    DISPATCH_FNS = {
        "dispatch_allocate_solve", "allocate_solve", "allocate_topk_solve",
        "warm_allocate_solve", "warm_allocate_sentinel_solve",
        "allocate_sentinel_solve", "allocate_topk_sentinel_solve",
        "evict_solve", "evict_sentinel_solve",
        "sharded_allocate_solve", "sharded_allocate_topk_solve",
        "sharded_warm_allocate_solve",
        "sharded_evict_solve", "sentinel_sharded_allocate_solve",
        "sentinel_sharded_allocate_topk_solve",
        "sentinel_sharded_warm_allocate_solve",
        "sentinel_sharded_evict_solve",
        "dispatch_enqueue_gate",
    }
    #: verdict consumers: the GuardPlane choke point and the shared
    #: readback-side consumers (guard/plane.consume_sentinel /
    #: consume_assignment_sentinel) — matched by SUBSTRING so an action's
    #: thin wrapper (`_consume_sentinel`) and shaped variants count
    #: without baking private names into the rule
    CONSUME_FNS = {"consume_verdict"}
    CONSUME_SUBSTR = "consume_"

    def check(self, tree: ast.Module, relpath: str):
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name.startswith("dispatch_"):
                continue  # the seam layer (docstring) — call sites checked
            dispatches: List[ast.Call] = []
            consumes = False
            for sub in _walk_skipping_defs(node.body):
                if not isinstance(sub, ast.Call):
                    continue
                name = _terminal_name(sub.func)
                if name in self.DISPATCH_FNS:
                    dispatches.append(sub)
                elif (name in self.CONSUME_FNS
                        or (self.CONSUME_SUBSTR in name
                            and "sentinel" in name)):
                    consumes = True
            if consumes:
                continue
            for call in dispatches:
                yield (call.lineno, call.col_offset,
                       f"`{_terminal_name(call.func)}(...)` dispatches a "
                       "committed solve but this function never consumes a "
                       "sentinel verdict (GuardPlane.consume_verdict) — a "
                       "condemned result could reach the binder; consume "
                       "the verdict, or annotate a dispatch seam that "
                       "returns the un-consumed sentinel to its caller")


# --------------------------------------------------------------------------
# KBT014 — span discipline: spans via obs.trace only, no clock reads in
# span bodies
# --------------------------------------------------------------------------


class SpanDisciplineRule(Rule):
    """Guard for the cycle tracing plane (obs/): spans in the
    clock-seamed paths are created ONLY through the ``obs.trace`` context
    managers (``tracer.span`` / ``device_span`` / ``cycle_span``), and a
    span body contains no clock reads of its own — the span IS the
    measurement.  Two bug classes this kills: (1) a hand-rolled Span (or a
    begin/end pair) that skips the context manager loses exception-safe
    closing and the per-thread nesting stack, producing unbalanced trace
    trees that the Chrome-export validation then rejects at smoke time;
    (2) an ad-hoc ``telemetry.perf_counter`` pair (or worse, raw
    ``time.*``) lexically inside a ``with ...span(...):`` body re-creates
    exactly the scattered-timer drift this plane replaced — the span's own
    stamps and the ad-hoc pair silently diverge, and the virtual-time
    seam is bypassed.  Metrics that want a span's duration read
    ``sp.dur_ms`` / ``sp.dur_us`` AFTER the block (the scheduler's action
    and plugin histograms are the shipped examples)."""

    id = "KBT014"
    title = "span discipline: manual span or clock read in a span body"
    #: the clock-seamed core PLUS every module that may adopt spans later —
    #: obs/ itself is exempt (it IS the implementation)
    scope = ("scheduler.py", "actions/", "cache/", "sim/", "framework/",
             "serve/", "guard/", "plugins/")

    SPAN_FACTORIES = {"span", "device_span", "cycle_span"}
    TIME_ATTRS = WallClockRule.TIME_ATTRS
    DATETIME_ATTRS = WallClockRule.DATETIME_ATTRS

    def _is_span_with(self, node) -> bool:
        for item in node.items:
            ctx = item.context_expr
            if (isinstance(ctx, ast.Call)
                    and isinstance(ctx.func, ast.Attribute)
                    and ctx.func.attr in self.SPAN_FACTORIES):
                return True
        return False

    def check(self, tree: ast.Module, relpath: str):
        imports = _ImportMap()
        imports.visit(tree)
        for node in ast.walk(tree):
            # (1) manual span construction outside the context managers
            if isinstance(node, ast.Call):
                name = _terminal_name(node.func)
                if name == "Span" or name in ("begin_span", "end_span"):
                    yield (node.lineno, node.col_offset,
                           "manual span construction bypasses the obs.trace "
                           "context managers (nesting stack, exception-safe "
                           "close); use `with tracer.span(...)`")
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not self._is_span_with(node):
                continue
            # (2) clock reads lexically inside the span body
            for inner in _walk_skipping_defs(node.body):
                if not isinstance(inner, ast.Call):
                    continue
                func = inner.func
                what = None
                if isinstance(func, ast.Attribute):
                    base = _leftmost_name(func)
                    if (base in imports.time_names
                            and func.attr in self.TIME_ATTRS):
                        what = f"`{base}.{func.attr}()`"
                    elif (base in imports.datetime_names
                            and func.attr in self.DATETIME_ATTRS):
                        what = f"`{base}.{func.attr}()`"
                    elif base == "telemetry" and func.attr == "perf_counter":
                        what = "`telemetry.perf_counter()`"
                elif isinstance(func, ast.Name):
                    if imports.from_time.get(func.id) in self.TIME_ATTRS:
                        what = f"`{func.id}()`"
                if what is not None:
                    yield (inner.lineno, inner.col_offset,
                           f"clock read {what} inside a span body — the "
                           "span already stamps its own wall/virtual time; "
                           "read `sp.dur_ms`/`sp.dur_us` after the block or "
                           "open a child span")


from kube_batch_tpu_torch.analysis.flowrules import FLOW_RULES  # noqa: E402

ALL_RULES = (
    WallClockRule(),
    BlockingUnderLockRule(),
    ModuleStateRule(),
    FailOpenTranslateRule(),
    HostSyncRule(),
    RawTransportRule(),
    SentinelConsumeRule(),
    SpanDisciplineRule(),
) + FLOW_RULES

RULES_BY_ID = {r.id: r for r in ALL_RULES}
