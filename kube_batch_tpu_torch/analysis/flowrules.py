"""Tier A's flow-aware rules (KBT008–KBT010; the JAX package's
``analysis/flowrules.py``, kept as the port's own copy).  Line-local
matching (rules.py, KBT001–005) cannot see these bug shapes: each rule
here consumes the per-module :class:`ModuleContext` the engine builds
(import resolution + symbol table) and, where the bug is a *sequence* of
statements, the intra-procedural def-use walk in dataflow.py.

KBT006 (use after donation) and KBT007 (jit retrace hazard) name JAX
idioms — ``donate_argnums`` and ``jax.jit`` wrappers — that the port does
not have, so they are not carried.  KBT010 reads the port's device
sources and torch's syncs.

Rules report (line, col, message) triples; scoping and suppression live in
the engine, exactly like the line-local rules.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from kube_batch_tpu_torch.analysis.dataflow import (
    FlowEvent,
    FlowVisitor,
    ModuleContext,
    walk_function,
)
from kube_batch_tpu_torch.analysis.engine import Rule

# --------------------------------------------------------------------------
# KBT008 — fail-open seam probes in the k8s layer
# --------------------------------------------------------------------------


class FailOpenSeamProbeRule(Rule):
    """ROADMAP follow-on to KBT004: the translate/watch layer probed its
    volume-binder seam with 3-arg ``getattr(binder, "add_pv", lambda..)`` —
    a binder missing the method silently dropped every PV event, the exact
    shape of the round-5 PV fail-open but one layer up.  Now that the seam
    surface is stable (cache/interface.py Protocols + explicit no-op
    fakes), a defaulted getattr probe in k8s/ is a policy decision to fail
    open and must be written down or replaced with a declared method.
    Dispatch-table ``.get()`` probes whose miss silently drops an event are
    the same bug through a dict."""

    id = "KBT008"
    title = "fail-open seam probe (defaulted getattr / dispatch-table get)"
    scope = ("k8s/",)

    DISPATCH_NAMES = ("handlers", "registry", "builders", "dispatch", "hooks")

    def check_ctx(self, ctx: ModuleContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Name) and f.id == "getattr"
                    and len(node.args) == 3):
                default = node.args[2]
                attr = node.args[1]
                attr_txt = (
                    repr(attr.value) if isinstance(attr, ast.Constant) else "?"
                )
                if (isinstance(default, ast.Constant) and default.value is None) \
                        or isinstance(default, ast.Lambda):
                    yield (node.lineno, node.col_offset,
                           f"3-arg getattr probe of {attr_txt} fails open "
                           "when the seam object lacks it (events silently "
                           "dropped); declare the method on the interface "
                           "Protocol with an explicit no-op on fakes, or "
                           "annotate why silent absence is sound")
            elif (isinstance(f, ast.Attribute) and f.attr == "get"
                    and isinstance(f.value, ast.Name)
                    and f.value.id.lower() in self.DISPATCH_NAMES):
                default = node.args[1] if len(node.args) > 1 else None
                if default is None or (
                    isinstance(default, ast.Constant) and default.value is None
                ):
                    yield (node.lineno, node.col_offset,
                           f"dispatch-table `{f.value.id}.get(...)` miss "
                           "returns None and silently drops the event; "
                           "fail closed (raise/log at the seam) or "
                           "annotate the open default")


# --------------------------------------------------------------------------
# KBT009 — telemetry clock outside metrics-feeding expressions
# --------------------------------------------------------------------------

_TELEMETRY_PATHS = {
    "kube_batch_tpu_torch.utils.telemetry.perf_counter",
    "kube_batch_tpu_torch.utils.telemetry",
}


class TelemetryMisuseRule(Rule):
    """ROADMAP follow-on to KBT001: ``telemetry.perf_counter`` is the ONE
    sanctioned wall-clock read in the clock-seamed paths, sanctioned
    precisely because it only feeds latency metrics.  A telemetry value
    reaching *control flow* (a comparison, a loop/if test, a sleep arg)
    smuggles real wall-clock back into scheduling decisions — the exact
    determinism break KBT001 exists to stop, laundered through the
    telemetry seam.  Flow-tracked: bindings are tainted, aliases follow,
    and a binding that is never read at all is a dead wall-clock read."""

    id = "KBT009"
    title = "telemetry clock value outside metrics-feeding expressions"
    scope = ("scheduler.py", "actions/", "cache/", "sim/", "framework/")

    @staticmethod
    def _is_perf_counter(call: ast.Call, ctx: ModuleContext) -> bool:
        dotted = ctx.resolve_call(call)
        if dotted in _TELEMETRY_PATHS or dotted.endswith(
            ".telemetry.perf_counter"
        ):
            return True
        # `from ..utils.telemetry import perf_counter` form
        return dotted.endswith("utils.telemetry.perf_counter")

    def check_ctx(self, ctx: ModuleContext):
        rule = self
        findings: List[Tuple[int, int, str]] = []
        seen: Set[int] = set()

        def flag(node: ast.AST, msg: str) -> None:
            if node.lineno in seen:
                return
            seen.add(node.lineno)
            findings.append((node.lineno, node.col_offset, msg))

        class V(FlowVisitor):
            def __init__(self) -> None:
                # dead-read tracking is keyed by BIND SITE and marked by
                # NAME, not by cell identity: branch joins replace cells
                # with union copies and the two-pass loop walk rebinds, so
                # a cell-held counter misses legitimate post-join /
                # loop-carried reads
                self.bind_nodes: Dict[int, ast.AST] = {}   # id(node) → node
                self.bind_used: Dict[int, bool] = {}
                self.binds_by_name: Dict[str, List[int]] = {}

            def on_call(self, ev: FlowEvent, env) -> None:
                call = ev.node
                if not rule._is_perf_counter(call, ctx):
                    return
                if "compare" in ev.where or "test" in ev.where:
                    flag(call,
                         "telemetry.perf_counter() used directly in control "
                         "flow — pacing/timeout decisions belong to the "
                         "injected clock (Scheduler.clock / sim "
                         "VirtualClock); the telemetry seam is for latency "
                         "metrics only")

            def on_bind(self, ev: FlowEvent, env, value) -> None:
                if (isinstance(value, ast.Call)
                        and rule._is_perf_counter(value, ctx)
                        and ev.cell is not None):
                    ev.cell["telemetry"] = value.lineno
                    key = id(ev.node)
                    self.bind_nodes[key] = ev.node
                    self.bind_used.setdefault(key, False)
                    self.binds_by_name.setdefault(ev.name, []).append(key)

            def on_load(self, ev: FlowEvent, env) -> None:
                for key in self.binds_by_name.get(ev.name, ()):
                    self.bind_used[key] = True
                cell = ev.cell
                if cell is None or "telemetry" not in cell:
                    return
                if "compare" in ev.where or "test" in ev.where:
                    flag(ev.node,
                         f"telemetry clock value `{ev.name}` reaches a "
                         "comparison/branch — wall clock is steering "
                         "scheduling control flow; use the injected clock "
                         "for pacing, telemetry for metrics spans only")

        for func in ctx.functions:
            v = V()
            walk_function(func, v)
            for key, used in v.bind_used.items():
                if not used:
                    flag(v.bind_nodes[key],
                         "telemetry.perf_counter() bound but never read — "
                         "a dead wall-clock read in a clock-seamed path; "
                         "delete it or feed it to a metrics expression")
        yield from findings


# --------------------------------------------------------------------------
# KBT010 — host-device sync on resident values in the action layer
# --------------------------------------------------------------------------

_PKG = "kube_batch_tpu_torch"
#: calls whose results live on the card: the solves, the probe, the gate,
#: the sharded solves and the resident snapshot — device tensors until the
#: action's one sanctioned readback
_DEVICE_SOURCES = {
    f"{_PKG}.ops.assignment.allocate_solve",
    f"{_PKG}.ops.assignment.allocate_topk_solve",
    f"{_PKG}.ops.assignment.warm_allocate_solve",
    f"{_PKG}.ops.assignment.failure_histogram_solve",
    f"{_PKG}.ops.assignment.failure_histogram_bucket_solve",
    f"{_PKG}.ops.eviction.evict_solve",
    f"{_PKG}.ops.probe.probe_solve",
    f"{_PKG}.ops.admission.enqueue_gate",
    f"{_PKG}.ops.admission.gate_scan",
    f"{_PKG}.ops.invariants.evict_sentinel_solve",
    f"{_PKG}.ops.invariants.enqueue_gate_sentinel_solve",
    f"{_PKG}.parallel.mesh.sharded_allocate_solve",
    f"{_PKG}.parallel.mesh.sharded_allocate_topk_solve",
    f"{_PKG}.parallel.mesh.sharded_warm_allocate_solve",
    f"{_PKG}.parallel.mesh.sharded_failure_histogram",
    f"{_PKG}.parallel.mesh.sharded_failure_histogram_bucket",
    f"{_PKG}.parallel.mesh.sharded_evict_solve",
    f"{_PKG}.parallel.mesh.sentinel_sharded_allocate_solve",
    f"{_PKG}.parallel.mesh.sentinel_sharded_allocate_topk_solve",
    f"{_PKG}.parallel.mesh.sentinel_sharded_warm_allocate_solve",
    f"{_PKG}.parallel.mesh.sentinel_sharded_evict_solve",
    f"{_PKG}.api.columns.resident_snap",
    f"{_PKG}.api.resident.resident_snap",
}
#: local-name fallbacks for intra-module dispatch helpers: direct calls
#: (`..._solve(...)`) and the factory form that returns a device function
#: (`_scatter_fn()(dev, ...)`, `_gate_fn(mesh)(...)`)
_DEVICE_SOURCE_SUFFIXES = ("_solve", "solve_dispatch")
_DEVICE_FACTORY_SUFFIXES = ("_scatter_fn", "_gate_fn")


class ResidentSyncRule(Rule):
    """Guards the cycle budget at its weakest point: the action layer
    holds BOTH host-backed snapshots (cheap numpy reads) and device-resident
    solve results (each read = a blocking transfer).  KBT005 can't tell
    them apart — this rule can: solve dispatches and resident swaps taint
    their results "device", aliases follow, and a ``.cpu()``/``.numpy()``/
    ``.item()``/``.tolist()``/``.to("cpu")``, an ``np.asarray`` or an
    ``int()``/``float()`` on a tainted value is a host-device sync.  The
    sanctioned choke points (each action's ONE blocking readback, as the
    JAX package's one ``device_get``) carry ``# kbt: allow[KBT010]``
    annotations — everything else is a new stall on the cycle's path."""

    id = "KBT010"
    title = "host-device sync on a device-resident value"
    # serve/: probe results are device-resident until the micro-batcher's
    # one sanctioned per-window readback (serve/plane.py annotates it)
    scope = ("actions/", "api/resident.py", "serve/")

    SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}

    @staticmethod
    def _is_device_source(call: ast.Call, ctx: ModuleContext) -> bool:
        dotted = ctx.resolve_call(call)
        if dotted in _DEVICE_SOURCES:
            return True
        f = call.func
        if isinstance(f, ast.Name):
            return f.id.endswith(_DEVICE_SOURCE_SUFFIXES) or f.id == "resident_snap"
        # the factory form: the inner call returns a device function, so
        # the outer call's result lives on the card
        if (isinstance(f, ast.Call) and isinstance(f.func, ast.Name)
                and f.func.id.endswith(_DEVICE_FACTORY_SUFFIXES)):
            return True
        return False

    @staticmethod
    def _to_cpu(call: ast.Call) -> bool:
        """``x.to("cpu")``, ``x.to(device="cpu")``, ``x.to(torch.device("cpu"))``."""
        args = list(call.args) + [kw.value for kw in call.keywords if kw.arg == "device"]
        for a in args:
            if isinstance(a, ast.Call) and a.args:
                a = a.args[0]
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return True
        return False

    @staticmethod
    def _base_name(node: ast.AST) -> str:
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        if isinstance(node, ast.Name):
            return node.id
        return ""

    def check_ctx(self, ctx: ModuleContext):
        rule = self
        findings: List[Tuple[int, int, str]] = []
        seen: Set[int] = set()

        def flag(node: ast.AST, msg: str) -> None:
            if node.lineno in seen:
                return
            seen.add(node.lineno)
            findings.append((node.lineno, node.col_offset, msg))

        def tainted(env, expr: ast.AST) -> bool:
            for sub in ast.walk(expr):
                name = rule._base_name(sub) if isinstance(
                    sub, (ast.Name, ast.Attribute, ast.Subscript)) else ""
                if name:
                    cell = env.get(name)
                    if cell is not None and "device" in cell:
                        return True
            return False

        class V(FlowVisitor):
            def on_call(self, ev: FlowEvent, env) -> None:
                call = ev.node
                dotted = ctx.resolve_call(call)
                f = call.func
                if dotted in ("numpy.asarray", "numpy.array") and call.args:
                    if tainted(env, call.args[0]):
                        flag(call,
                             "np.asarray on a device-resident value forces "
                             "a blocking transfer outside the sanctioned "
                             "readback; keep it on device or fold it into "
                             "the cycle's choke point")
                    return
                if isinstance(f, ast.Attribute) and tainted(env, f.value) and (
                        f.attr in rule.SYNC_ATTRS
                        or (f.attr == "to" and rule._to_cpu(call))):
                    what = "to(\"cpu\")" if f.attr == "to" else f"{f.attr}()"
                    flag(call,
                         f"`.{what}` on a device-resident value is a "
                         "blocking host-device sync in the action layer; "
                         "batch it into the sanctioned readback")
                    return
                if (isinstance(f, ast.Name) and f.id in ("float", "int")
                        and call.args and tainted(env, call.args[0])):
                    flag(call,
                         f"`{f.id}()` on a device-resident value "
                         "materializes it on host; read it back through "
                         "the sanctioned choke point")

            def on_bind(self, ev: FlowEvent, env, value) -> None:
                if (isinstance(value, ast.Call)
                        and rule._is_device_source(value, ctx)
                        and ev.cell is not None):
                    ev.cell["device"] = value.lineno

        for func in ctx.functions:
            walk_function(func, V())
        yield from findings


FLOW_RULES = (
    FailOpenSeamProbeRule(),
    TelemetryMisuseRule(),
    ResidentSyncRule(),
)
