"""Tier A of the port's analyzer (``kube_batch_tpu_torch/analysis``), case
for case with ``tests/test_analysis.py`` less KBT006/KBT007 (JAX idioms):
fixture-driven good/bad snippets per rule — KBT005 and KBT010 in the torch
idiom —, the def-use walker, the suppression contract, the CLI, and the
self-enforcement check that keeps the port clean.  No JAX is imported."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

from kube_batch_tpu_torch.analysis import check_source, run_paths
from kube_batch_tpu_torch.analysis import __main__ as cli
from kube_batch_tpu_torch.analysis.rules import RULES_BY_ID
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker


def findings_for(src: str, relpath: str):
    return check_source(textwrap.dedent(src), relpath)


def rule_ids(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# KBT001 — wall clock outside the Clock seam
# ---------------------------------------------------------------------------


class TestKBT001:
    BAD = """
    import time

    def pace():
        time.sleep(1.0)
        return time.monotonic()
    """

    def test_bad_snippet_triggers_exactly_kbt001(self):
        findings = findings_for(self.BAD, "actions/x.py")
        assert rule_ids(findings) == ["KBT001"]
        assert len(findings) == 2

    def test_from_import_alias_is_caught(self):
        findings = findings_for(
            "from time import sleep as zzz\ndef f():\n    zzz(1)\n",
            "sim/x.py",
        )
        assert rule_ids(findings) == ["KBT001"]

    def test_datetime_now_is_caught(self):
        findings = findings_for(
            "import datetime\ndef f():\n    return datetime.datetime.now()\n",
            "cache/x.py",
        )
        assert rule_ids(findings) == ["KBT001"]

    def test_injected_clock_is_the_sanctioned_path(self):
        good = """
        class S:
            def pace(self):
                t = self.clock.monotonic()
                self.clock.sleep(1.0)
                return t
        """
        assert findings_for(good, "scheduler.py") == []

    def test_out_of_scope_paths_unflagged(self):
        # cmd/ owns real wall-clock concerns (leases, rate limits)
        assert findings_for(self.BAD, "cmd/x.py") == []

    def test_annotation_suppresses(self):
        src = """
        import time

        def f():
            # kbt: allow[KBT001] measures real compute for the bench
            return time.perf_counter()
        """
        assert findings_for(src, "actions/x.py") == []


# ---------------------------------------------------------------------------
# KBT002 — blocking call under a lock
# ---------------------------------------------------------------------------


class TestKBT002:
    def test_sleep_under_lock_triggers(self):
        src = """
        import time

        def take(self):
            with self._lock:
                time.sleep(0.1)
        """
        # KBT002 everywhere; out of KBT001 scope so only the lock rule fires
        findings = findings_for(src, "cmd/server.py")
        assert rule_ids(findings) == ["KBT002"]

    def test_future_result_and_queue_get_under_lock_trigger(self):
        src = """
        def drain(self):
            with self._lock:
                self.future.result()
                item = work_queue.get()
        """
        findings = findings_for(src, "k8s/x.py")
        assert len(findings) == 2 and rule_ids(findings) == ["KBT002"]

    def test_tokenbucket_pattern_is_clean(self):
        src = """
        def take(self):
            with self._lock:
                self._tokens -= 1.0
                wait = max(0.0, -self._tokens / self._qps)
            if wait:
                self._time.sleep(wait)
        """
        assert findings_for(src, "cmd/server.py") == []

    def test_dict_get_under_lock_is_not_blocking(self):
        src = """
        def read(self):
            with self._lock:
                return self.index.get("k")
        """
        assert findings_for(src, "k8s/x.py") == []

    def test_nested_def_body_is_not_under_the_lock(self):
        src = """
        import time

        def sched(self):
            with self._lock:
                def later():
                    time.sleep(1)
                return later
        """
        assert findings_for(src, "cmd/x.py") == []

    def test_non_lock_with_is_ignored(self):
        src = """
        import time

        def f():
            with open("x") as fh:
                time.sleep(1)
                return fh
        """
        assert findings_for(src, "cmd/x.py") == []


# ---------------------------------------------------------------------------
# KBT003 — module-level mutable state in actions/framework
# ---------------------------------------------------------------------------


class TestKBT003:
    def test_module_dict_and_global_write_trigger(self):
        src = """
        last_host_discards = {}

        def execute(ssn):
            global cycle_count
            cycle_count = 1
        """
        findings = findings_for(src, "actions/x.py")
        assert rule_ids(findings) == ["KBT003"]
        assert len(findings) == 2

    def test_constants_and_dunders_are_fine(self):
        src = """
        OVERCOMMIT = {"cpu": 1.2}
        __all__ = ["execute"]
        logger = get_logger("x")
        """
        assert findings_for(src, "framework/x.py") == []

    def test_annotated_registry_is_fine(self):
        src = """
        # kbt: allow[KBT003] import-time registry, read-only after import
        _builders = {}
        """
        assert findings_for(src, "framework/x.py") == []

    def test_out_of_scope_module_state_unflagged(self):
        assert findings_for("cache = {}\n", "plugins/x.py") == []


# ---------------------------------------------------------------------------
# KBT004 — translate-layer fail-open defaults
# ---------------------------------------------------------------------------


class TestKBT004:
    def test_none_fallback_in_value_function_triggers(self):
        src = """
        def node_from(spec):
            if spec.get("kind") == "node":
                return spec["name"]
            return None
        """
        findings = findings_for(src, "k8s/translate.py")
        assert rule_ids(findings) == ["KBT004"]

    def test_empty_collection_fallback_triggers(self):
        src = """
        def terms_from(spec):
            if "terms" in spec:
                return list(spec["terms"])
            return []
        """
        assert rule_ids(findings_for(src, "k8s/translate.py")) == ["KBT004"]

    def test_procedures_with_bare_returns_are_fine(self):
        src = """
        def apply(cache, obj):
            if obj is None:
                return
            cache.add(obj)
        """
        assert findings_for(src, "k8s/translate.py") == []

    def test_fail_closed_sentinel_is_fine(self):
        src = """
        SENTINEL = "__restricted__"

        def node_from(spec):
            if spec.get("kind") == "node":
                return spec["name"]
            return SENTINEL
        """
        assert findings_for(src, "k8s/translate.py") == []

    def test_annotated_default_is_fine(self):
        src = """
        def owner_of(meta):
            for ref in meta.get("ownerReferences") or []:
                return ref["uid"]
            # kbt: allow[KBT004] ownerless pods are a valid spec state
            return None
        """
        assert findings_for(src, "k8s/translate.py") == []

    def test_out_of_scope_none_returns_unflagged(self):
        src = "def f(x):\n    if x:\n        return x\n    return None\n"
        assert findings_for(src, "cache/x.py") == []


# ---------------------------------------------------------------------------
# KBT005 — host-device sync in ops/
# ---------------------------------------------------------------------------


class TestKBT005:
    def test_sync_calls_trigger(self):
        src = """
        import numpy as np

        def solve(x):
            y = np.asarray(x)
            x.cpu()
            n = x.item()
            return float(y) + n
        """
        findings = findings_for(src, "ops/x.py")
        assert rule_ids(findings) == ["KBT005"]
        assert len(findings) == 4

    def test_tolist_and_numpy_trigger(self):
        src = """
        def read(x):
            return x.tolist(), x.numpy()
        """
        findings = findings_for(src, "ops/x.py")
        assert [f.rule for f in findings] == ["KBT005", "KBT005"]

    def test_torch_dispatch_in_python_loop_triggers(self):
        src = """
        import torch

        def f(keys):
            total = 0
            for k in keys:
                total = total + torch.sum(k)
            return total
        """
        assert rule_ids(findings_for(src, "ops/x.py")) == ["KBT005"]

    def test_aliased_torch_in_while_loop_triggers(self):
        src = """
        import torch.nn.functional as F

        def f(x, n):
            while n:
                x = F.pad(x, (0, 1))
                n -= 1
            return x
        """
        findings = findings_for(src, "ops/x.py")
        assert rule_ids(findings) == ["KBT005"]
        assert "torch.nn.functional.pad" in findings[0].message

    def test_vectorized_torch_is_fine(self):
        src = """
        import torch

        def f(x):
            return torch.sum(x, dim=0)
        """
        assert findings_for(src, "ops/x.py") == []

    def test_non_dispatch_torch_calls_in_a_loop_are_fine(self):
        src = """
        import torch

        def f(devs):
            for d in devs:
                yield torch.device(d), torch.finfo(torch.float32)
        """
        assert findings_for(src, "ops/x.py") == []

    def test_bidding_round_loop_is_governed_by_tier_b(self):
        # a loop that reads back through seams.round_end dispatches its
        # round on purpose; tier B's per-round budget governs it
        src = """
        import torch
        from kube_batch_tpu_torch.utils.seams import round_end

        def rounds(x, n):
            i, progress = 0, True
            while i < n and progress:
                y = torch.where(x > 0, x, 0)
                for r in range(4):
                    y = torch.maximum(y, x)
                i += 1
                progress = round_end(y.any())
            return y
        """
        assert findings_for(src, "ops/x.py") == []

    def test_sync_inside_a_bidding_round_still_triggers(self):
        src = """
        import torch
        from kube_batch_tpu_torch.utils import seams

        def rounds(x):
            progress = True
            while progress:
                n = x.sum().item()
                progress = seams.round_end(x.any())
            return n
        """
        findings = findings_for(src, "ops/x.py")
        assert [f.rule for f in findings] == ["KBT005"]
        assert ".item()" in findings[0].message

    def test_round_end_outside_the_loop_does_not_exempt_it(self):
        src = """
        import torch
        from kube_batch_tpu_torch.utils.seams import round_end

        def f(xs):
            for x in xs:
                y = torch.exp(x)
            return round_end(y.any())
        """
        assert rule_ids(findings_for(src, "ops/x.py")) == ["KBT005"]

    def test_annotated_static_unroll_is_fine(self):
        # one annotation at the loop header covers the whole loop
        src = """
        import torch

        def f(xs):
            acc = xs[0]
            # kbt: allow[KBT005] static unroll over a fixed small tuple
            for x in xs[1:]:
                acc = torch.maximum(acc, x)
                acc = torch.minimum(acc, x + 1)
            return acc
        """
        assert findings_for(src, "ops/x.py") == []

    def test_annotation_inside_the_loop_does_not_cover_it(self):
        src = """
        import torch

        def f(xs):
            acc = xs[0]
            for x in xs[1:]:
                # kbt: allow[KBT005] static unroll over a fixed small tuple
                acc = torch.maximum(acc, x)
            return acc
        """
        findings = findings_for(src, "ops/x.py")
        assert [(f.rule, f.line) for f in findings] == [("KBT005", 6)]

    def test_loop_reported_once_at_its_header(self):
        src = """
        import torch

        def f(xs, n):
            acc = torch.zeros(n)
            for x in xs:
                acc = acc + torch.exp(x)
                for k in range(3):
                    acc = torch.maximum(acc, x * k)
            return acc
        """
        findings = findings_for(src, "ops/x.py")
        assert [(f.rule, f.line, f.col) for f in findings] == [("KBT005", 6, 4)]
        assert "torch.exp" in findings[0].message

    def test_tensor_method_in_loop_triggers(self):
        src = """
        import torch

        def f(bval: torch.Tensor, k: int):
            out = []
            for _ in range(k):
                out.append(bval.amax(dim=1))
            return out
        """
        findings = findings_for(src, "ops/x.py")
        assert rule_ids(findings) == ["KBT005"]
        assert ".amax()" in findings[0].message

    def test_tensor_only_method_on_unknown_receiver_triggers(self):
        src = """
        def f(snap, rows):
            for r in rows:
                snap.idle.scatter_(0, r, 0.0)
        """
        findings = findings_for(src, "ops/x.py")
        assert rule_ids(findings) == ["KBT005"]
        assert ".scatter_()" in findings[0].message

    def test_operator_on_a_tensor_in_loop_triggers(self):
        src = """
        import torch

        def f(req, n):
            ok = torch.ones(n, dtype=torch.bool)
            for r in range(4):
                ok &= req[:, r] <= 1.0
            return ok
        """
        findings = findings_for(src, "ops/x.py")
        assert rule_ids(findings) == ["KBT005"]
        assert "operator" in findings[0].message

    def test_indexing_a_tensor_in_loop_triggers(self):
        src = """
        def f(x: "torch.Tensor", idx):
            out = []
            for i in idx:
                out.append(x[i])
            return out
        """
        findings = findings_for(src, "ops/x.py")
        assert rule_ids(findings) == ["KBT005"]
        assert "indexing" in findings[0].message

    def test_iterating_over_a_tensor_triggers(self):
        src = """
        import torch

        def f(n):
            rows = torch.arange(n)
            for r in rows:
                print(r)
        """
        findings = findings_for(src, "ops/x.py")
        assert rule_ids(findings) == ["KBT005"]
        assert "iterating" in findings[0].message

    def test_closure_sees_its_enclosing_tensors(self):
        src = """
        import torch

        def outer(n):
            acc = torch.zeros(n)

            def inner(xs):
                for x in xs:
                    acc[x] = 1.0
            return inner
        """
        assert rule_ids(findings_for(src, "ops/x.py")) == ["KBT005"]

    def test_host_only_loop_is_fine(self):
        src = """
        def f(out: str, shape):
            names = []
            for ln in out.splitlines():
                names.append(ln.strip() + "!")
            for d in range(len(shape)):
                names.append(shape[d] * 2)
            return names
        """
        assert findings_for(src, "ops/x.py") == []

    def test_metadata_methods_in_loop_are_fine(self):
        src = """
        import torch

        def f(xs: torch.Tensor):
            dims = []
            for k in range(3):
                dims.append(xs.size(k) + xs.dim())
            return dims
        """
        assert findings_for(src, "ops/x.py") == []

    def test_bidding_round_exempts_methods_and_operators(self):
        src = """
        import torch
        from kube_batch_tpu_torch.utils.seams import round_end

        def rounds(x: torch.Tensor, n):
            progress = True
            while progress:
                x = x.clamp(min=0) - 1
                x[0] = 0
                progress = round_end(x.amax() > 0)
            return x
        """
        assert findings_for(src, "ops/x.py") == []

    def test_out_of_scope_numpy_unflagged(self):
        src = "import numpy as np\ndef f(x):\n    return np.asarray(x)\n"
        assert findings_for(src, "cache/x.py") == []


# ---------------------------------------------------------------------------
# KBT008 — fail-open seam probes in k8s/
# ---------------------------------------------------------------------------


class TestKBT008:
    def test_defaulted_getattr_probe_triggers(self):
        src = """
        def apply(binder, obj):
            getattr(binder, "add_pv", None)(obj)
        """
        findings = findings_for(src, "k8s/x.py")
        assert rule_ids(findings) == ["KBT008"]
        assert "'add_pv'" in findings[0].message

    def test_lambda_default_probe_triggers(self):
        src = """
        def apply(binder, obj):
            getattr(binder, "add_pv", lambda _o: None)(obj)
        """
        assert rule_ids(findings_for(src, "k8s/x.py")) == ["KBT008"]

    def test_two_arg_getattr_is_fine(self):
        # no default: a missing attribute raises — fail closed
        src = """
        def apply(binder, obj):
            getattr(binder, "add_pv")(obj)
        """
        assert findings_for(src, "k8s/x.py") == []

    def test_dispatch_table_get_probe_triggers(self):
        src = """
        def route(handlers, kind, obj):
            handlers.get(kind)(obj)
        """
        assert rule_ids(findings_for(src, "k8s/x.py")) == ["KBT008"]

    def test_out_of_scope_probe_unflagged(self):
        src = """
        def probe(cache):
            return getattr(cache, "flush_binds", None)
        """
        assert findings_for(src, "framework/x.py") == []

    def test_annotated_capability_probe_is_fine(self):
        src = """
        def reconcile(binder):
            # kbt: allow[KBT008] capability probe: absence means no ledger
            pvs = getattr(binder, "pvs", None)
            return pvs
        """
        assert findings_for(src, "k8s/x.py") == []


# ---------------------------------------------------------------------------
# KBT009 — telemetry clock outside metrics-feeding expressions
# ---------------------------------------------------------------------------


class TestKBT009:
    def test_telemetry_value_in_control_flow_triggers(self):
        src = """
        from kube_batch_tpu_torch.utils import telemetry

        def pace(self):
            t0 = telemetry.perf_counter()
            self.work()
            if telemetry.perf_counter() - t0 > 1.0:
                self.abort()
        """
        findings = findings_for(src, "actions/x.py")
        assert rule_ids(findings) == ["KBT009"]

    def test_metrics_feeding_span_is_the_sanctioned_shape(self):
        src = """
        from kube_batch_tpu_torch.utils import telemetry
        from kube_batch_tpu_torch import metrics

        def timed(self):
            t0 = telemetry.perf_counter()
            self.work()
            metrics.observe_e2e_latency(
                (telemetry.perf_counter() - t0) * 1e3
            )
        """
        assert findings_for(src, "actions/x.py") == []

    def test_unused_binding_is_a_dead_wall_clock_read(self):
        src = """
        from kube_batch_tpu_torch.utils import telemetry

        def f(self):
            t0 = telemetry.perf_counter()
            self.work()
        """
        findings = findings_for(src, "framework/x.py")
        assert rule_ids(findings) == ["KBT009"]
        assert "never read" in findings[0].message

    def test_sink_accumulation_is_clean(self):
        # the allocate action's _PhaseMarks shape: the value flows into an
        # ms sink and the next-mark attribute store
        src = """
        from kube_batch_tpu_torch.utils import telemetry

        def mark(self, key):
            now = telemetry.perf_counter()
            self.sink[key] = self.sink.get(key, 0.0) + (now - self.t) * 1e3
            self.t = now
        """
        assert findings_for(src, "actions/x.py") == []

    def test_read_after_branch_join_is_not_dead(self):
        # a false-positive shape: the binding happens in one branch and the
        # read after the join lands on the merge's union cell — the
        # dead-read check must key on the bind SITE, not cell identity
        src = """
        from kube_batch_tpu_torch.utils import telemetry
        from kube_batch_tpu_torch import metrics

        def f(self, cond):
            t0 = 0.0
            if cond:
                t0 = telemetry.perf_counter()
            metrics.observe_e2e_latency(t0)
        """
        assert findings_for(src, "actions/x.py") == []

    def test_loop_carried_read_is_not_dead(self):
        # a false-positive shape: the next iteration reads the previous
        # iteration's binding (two-pass loop walk rebinds the cell)
        src = """
        from kube_batch_tpu_torch.utils import telemetry
        from kube_batch_tpu_torch import metrics

        def f(self, items):
            prev = telemetry.perf_counter()
            for item in items:
                self.work(item)
                metrics.observe_e2e_latency(prev)
                prev = telemetry.perf_counter()
        """
        assert findings_for(src, "actions/x.py") == []

    def test_out_of_scope_unflagged(self):
        src = """
        from kube_batch_tpu_torch.utils import telemetry

        def f():
            t0 = telemetry.perf_counter()
        """
        assert findings_for(src, "testing/x.py") == []


# ---------------------------------------------------------------------------
# KBT010 — host-device sync on resident values in the action layer
# ---------------------------------------------------------------------------


class TestKBT010:
    def test_asarray_on_solve_result_triggers(self):
        src = """
        import numpy as np
        from kube_batch_tpu_torch.ops.assignment import allocate_solve

        def read(snap, config):
            result = allocate_solve(snap, config)
            return np.asarray(result)
        """
        findings = findings_for(src, "actions/x.py")
        # the fixture's bare dispatch also (correctly) lacks a sentinel
        # consumer, so KBT013 fires alongside
        assert rule_ids(findings) == ["KBT010", "KBT013"]

    def test_attribute_of_result_is_still_the_result(self):
        src = """
        from kube_batch_tpu_torch.ops.eviction import evict_solve

        def read(snap, config):
            result = evict_solve(snap, config)
            return result.claim_node.cpu().numpy()
        """
        assert rule_ids(findings_for(src, "actions/x.py")) == [
            "KBT010", "KBT013",  # bare dispatch: no sentinel consumer either
        ]

    def test_to_cpu_on_device_value_triggers(self):
        src = """
        import torch
        from kube_batch_tpu_torch.ops.assignment import failure_histogram_solve

        def read(snap):
            hist = failure_histogram_solve(snap)
            a = hist.to("cpu")
            b = hist.to(device="cpu")
            return a, b, hist.to(torch.device("cpu"))
        """
        findings = findings_for(src, "actions/x.py")
        assert [f.rule for f in findings] == ["KBT010"] * 3
        assert 'to("cpu")' in findings[0].message

    def test_to_another_card_is_not_a_readback(self):
        src = """
        from kube_batch_tpu_torch.ops.assignment import failure_histogram_solve

        def move(snap):
            hist = failure_histogram_solve(snap)
            return hist.to("cuda:1")
        """
        assert findings_for(src, "actions/x.py") == []

    def test_asarray_on_host_snapshot_is_fine(self):
        # the flow-awareness KBT005 lacks: host-backed snap reads are free
        src = """
        import numpy as np

        def read(snap):
            return np.asarray(snap.task_job)
        """
        assert findings_for(src, "actions/x.py") == []

    def test_item_on_device_value_triggers(self):
        src = """
        from kube_batch_tpu_torch.ops.assignment import failure_histogram_solve

        def read(snap):
            hist = failure_histogram_solve(snap)
            return hist.item()
        """
        assert rule_ids(findings_for(src, "actions/x.py")) == ["KBT010"]

    def test_int_and_tolist_on_device_value_trigger(self):
        src = """
        from kube_batch_tpu_torch.ops.probe import probe_solve

        def read(snap, batch, rows, config):
            res = probe_solve(snap, batch, rows, config)
            return int(res.feasible[0]), res.assigned.tolist()
        """
        findings = findings_for(src, "serve/x.py")
        assert rule_ids(findings) == ["KBT010"]

    def test_taint_survives_branch_merge(self):
        src = """
        import numpy as np
        from kube_batch_tpu_torch.ops.assignment import failure_histogram_solve

        def read(snap, wanted):
            hist = None
            if wanted:
                hist = failure_histogram_solve(snap)
            return np.asarray(hist)
        """
        assert rule_ids(findings_for(src, "actions/x.py")) == ["KBT010"]

    def test_annotation_marks_the_sanctioned_readback(self):
        src = """
        from kube_batch_tpu_torch.ops.assignment import failure_histogram_solve

        def read(snap):
            hist = failure_histogram_solve(snap)
            # kbt: allow[KBT010] the cycle's one blocking readback
            return hist.cpu().numpy()
        """
        assert findings_for(src, "actions/x.py") == []

    def test_out_of_scope_sync_unflagged(self):
        src = """
        from kube_batch_tpu_torch.ops.assignment import failure_histogram_solve

        def read(snap):
            return failure_histogram_solve(snap).cpu()
        """
        assert findings_for(src, "testing/x.py") == []

    def test_enqueue_gate_is_a_device_source(self):
        src = """
        from kube_batch_tpu_torch.ops.admission import enqueue_gate

        def gate(minr, cand, idle, quanta):
            admitted = enqueue_gate(minr, cand, idle, quanta)
            return admitted.cpu().numpy()
        """
        assert rule_ids(findings_for(src, "actions/x.py")) == ["KBT010"]

    def test_sharded_solve_and_resident_snap_are_device_sources(self):
        src = """
        from kube_batch_tpu_torch.api.columns import resident_snap
        from kube_batch_tpu_torch.parallel import mesh

        def read(cols, snap, target, config):
            dev = resident_snap(cols, snap, target)
            res = mesh.sharded_allocate_solve(dev, config)
            return dev.task_pending.cpu(), res.assigned.cpu()
        """
        findings = findings_for(src, "api/resident.py")
        assert [f.rule for f in findings] == ["KBT010"]  # one per line

    def test_scatter_factory_result_is_a_device_source(self):
        # the factory form: `_shard_scatter_fn(mesh)(dev, rows, vals)`
        src = """
        def refresh(mesh, dev, rows, vals):
            dev = _mesh_shard_scatter_fn(mesh)(dev, rows, vals)
            return dev.numpy()
        """
        assert rule_ids(findings_for(src, "api/resident.py")) == ["KBT010"]


# ---------------------------------------------------------------------------
# dataflow: the def-use engine itself
# ---------------------------------------------------------------------------


class TestDataflow:
    @staticmethod
    def _run(src: str):
        """Walk `f` in `src` with a tiny taint visitor: `taint(x)` taints
        x's cell, every load of a tainted name is recorded."""
        import ast as _ast

        from kube_batch_tpu_torch.analysis.dataflow import (
            FlowVisitor,
            walk_function,
        )

        tree = _ast.parse(textwrap.dedent(src))
        func = next(n for n in _ast.walk(tree)
                    if isinstance(n, _ast.FunctionDef) and n.name == "f")
        hits = []

        class V(FlowVisitor):
            def on_call(self, ev, env):
                call = ev.node
                if (isinstance(call.func, _ast.Name)
                        and call.func.id == "taint"):
                    for a in call.args:
                        if isinstance(a, _ast.Name) and a.id in env:
                            env[a.id]["t"] = True

            def on_load(self, ev, env):
                if ev.cell is not None and ev.cell.get("t"):
                    hits.append((ev.name, ev.node.lineno))

        walk_function(func, V())
        return hits

    def test_alias_shares_the_cell(self):
        hits = self._run("""
        def f(a):
            b = a
            taint(a)
            return b
        """)
        assert [h[0] for h in hits] == ["b"]

    def test_reassignment_rebinds_to_a_fresh_cell(self):
        hits = self._run("""
        def f(a, c):
            taint(a)
            a = c
            return a
        """)
        assert hits == []

    def test_branch_taint_survives_the_join(self):
        hits = self._run("""
        def f(a, cond):
            if cond:
                taint(a)
            return a
        """)
        assert [h[0] for h in hits] == ["a"]

    def test_clean_rebind_in_one_branch_does_not_launder(self):
        hits = self._run("""
        def f(a, c, cond):
            taint(a)
            if cond:
                a = c
            return a
        """)
        assert [h[0] for h in hits] == ["a"]

    def test_loop_bottom_taint_reaches_the_top(self):
        hits = self._run("""
        def f(a, xs):
            for x in xs:
                y = a + 1
                taint(a)
            return y
        """)
        assert ("a", 4) in hits  # second pass sees the taint

    def test_tuple_unpack_from_call_taints_every_target(self):
        hits = self._run("""
        def f(a):
            taint(a)
            x, y = a
            return x, y
        """)
        names = {h[0] for h in hits}
        assert {"a", "x", "y"} <= names

    def test_match_arm_bodies_are_walked(self):
        # a soundness hole: unhandled statement types were
        # silently skipped, blinding every flow rule inside match blocks
        hits = self._run("""
        def f(a, mode):
            taint(a)
            match mode:
                case "x":
                    return a
                case _:
                    return None
        """)
        assert [h[0] for h in hits] == ["a"]

    def test_match_capture_binds_fresh_and_guard_is_a_test(self):
        hits = self._run("""
        def f(a, mode):
            taint(a)
            match mode:
                case str() as a:
                    return a
        """)
        # the capture rebinds `a` to a fresh cell inside the arm
        assert hits == []


# ---------------------------------------------------------------------------
# engine: suppression contract
# ---------------------------------------------------------------------------


class TestSuppressions:
    def test_allow_without_reason_does_not_suppress(self):
        src = """
        import time

        def f():
            return time.time()  # kbt: allow[KBT001]
        """
        findings = findings_for(src, "actions/x.py")
        # the original finding survives AND the empty allow is itself flagged
        assert rule_ids(findings) == ["KBT000", "KBT001"]

    def test_multiline_annotation_block_covers_next_statement(self):
        src = """
        import time

        def f():
            # kbt: allow[KBT001] long explanation of why this wall-clock
            # read is deliberate, spilling onto a second comment line
            return time.time()
        """
        assert findings_for(src, "actions/x.py") == []

    def test_allow_only_suppresses_its_own_rule(self):
        src = """
        import time

        def f(self):
            with self._lock:
                # kbt: allow[KBT002] reason that names the wrong rule
                time.sleep(1)
        """
        findings = findings_for(src, "actions/x.py")
        assert rule_ids(findings) == ["KBT001"]  # KBT002 suppressed, 001 not

    def test_syntax_error_reports_kbt000(self):
        findings = findings_for("def f(:\n", "actions/x.py")
        assert rule_ids(findings) == ["KBT000"]


# ---------------------------------------------------------------------------
# KBT011 — raw urllib / ad-hoc sleep retry loop outside the transport
# ---------------------------------------------------------------------------


class TestKBT011:
    def test_raw_urlopen_in_k8s_triggers(self):
        src = """
        import urllib.request

        def fetch(url):
            with urllib.request.urlopen(url) as r:
                return r.read()
        """
        assert rule_ids(findings_for(src, "k8s/watch.py")) == ["KBT011"]

    def test_from_import_urlopen_is_caught(self):
        src = """
        from urllib.request import urlopen

        def fetch(url):
            return urlopen(url).read()
        """
        assert rule_ids(findings_for(src, "cmd/server.py")) == ["KBT011"]

    def test_sleep_retry_loop_triggers(self):
        src = """
        import time

        def renew(call):
            for attempt in range(5):
                try:
                    return call()
                except OSError:
                    time.sleep(2 ** attempt)
        """
        assert rule_ids(findings_for(src, "k8s/bind.py")) == ["KBT011"]

    def test_transport_module_is_the_sanctioned_home(self):
        src = """
        import time
        import urllib.request

        def call(url, delays):
            for d in delays:
                try:
                    return urllib.request.urlopen(url)
                except OSError:
                    time.sleep(d)
        """
        assert findings_for(src, "k8s/transport.py") == []

    def test_sleep_outside_a_loop_is_not_a_retry(self):
        src = """
        import time

        def settle():
            time.sleep(0.1)
        """
        assert findings_for(src, "k8s/bind.py") == []

    def test_annotation_suppresses(self):
        src = """
        import time

        def sample(frames):
            while frames:
                frames.pop()
                # kbt: allow[KBT011] sampling cadence, not a retry loop
                time.sleep(0.01)
        """
        assert findings_for(src, "cmd/server.py") == []

    def test_out_of_scope_urlopen_unflagged(self):
        src = """
        import urllib.request

        def fetch(url):
            return urllib.request.urlopen(url).read()
        """
        assert findings_for(src, "testing/e2e.py") == []


# ---------------------------------------------------------------------------
# KBT012 — MOVED to tier D: the writeback-stage handoff contract is a
# KBT302 instance now (analysis/races.py); its fixtures live in
# tests/test_races.py::TestKBT302Legacy and `--select KBT012` aliases
# through (TestCli covers the alias).
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# KBT013 — solve dispatch without a sentinel-verdict consumer
# ---------------------------------------------------------------------------


class TestKBT013:
    def test_dispatch_without_consumer_triggers(self):
        src = """
        def execute(ssn, snap, config):
            result, mode, topk, ginfo = dispatch_allocate_solve(
                snap, config, cols=ssn.columns
            )
            return result
        """
        findings = findings_for(src, "actions/x.py")
        assert rule_ids(findings) == ["KBT013"]
        assert "consume" in findings[0].message

    def test_dispatch_with_consumer_is_clean(self):
        src = """
        def execute(ssn, snap, config, gp):
            result, mode, topk, ginfo = dispatch_allocate_solve(
                snap, config, cols=ssn.columns, guard=gp
            )
            if not gp.consume_verdict("allocate", ginfo["engaged"], 0):
                return None
            return result
        """
        assert findings_for(src, "actions/x.py") == []

    def test_direct_evict_solve_without_consumer_triggers(self):
        src = """
        def solve(ssn, snap, config):
            return evict_solve(snap, config)
        """
        assert rule_ids(findings_for(src, "actions/x.py")) == ["KBT013"]

    def test_dispatch_seam_layer_is_exempt(self):
        # dispatch_*-named helpers RETURN the un-consumed sentinel — the
        # rule holds their call sites to the consumer requirement instead
        src = """
        def dispatch_allocate_solve(snap, config):
            return allocate_sentinel_solve(snap, config)
        """
        assert findings_for(src, "actions/x.py") == []

    def test_out_of_scope_unflagged(self):
        src = """
        def probe(snap, config):
            return evict_solve(snap, config)
        """
        assert findings_for(src, "serve/x.py") == []

    def test_annotation_suppresses(self):
        src = """
        def helper(snap, config):
            # kbt: allow[KBT013] read-only diagnostic solve, never bound
            return evict_solve(snap, config)
        """
        assert findings_for(src, "actions/x.py") == []


# ---------------------------------------------------------------------------
# self-enforcement: the package must be clean (tier-1)
# ---------------------------------------------------------------------------


class TestSelfEnforcement:
    def test_package_has_zero_unsuppressed_findings(self):
        findings = run_paths()  # defaults to the kube_batch_tpu_torch tree
        assert findings == [], "\n" + "\n".join(f.render() for f in findings)

    def test_package_is_clean_under_tiers_a_and_d_together(self):
        from kube_batch_tpu_torch.analysis.races import RACE_RULES
        from kube_batch_tpu_torch.analysis.rules import ALL_RULES

        findings = run_paths(rules=list(ALL_RULES) + list(RACE_RULES))
        assert findings == [], "\n" + "\n".join(f.render() for f in findings)

    def test_every_rule_has_title_and_grounding_doc(self):
        for rule in RULES_BY_ID.values():
            assert rule.title
            # each rule documents the incident that motivated it
            assert rule.__doc__ and len(rule.__doc__.strip()) > 40

    def test_all_static_rules_are_registered(self):
        # KBT012 lives in tier D (KBT302); KBT006/KBT007 name JAX idioms
        assert sorted(RULES_BY_ID) == [
            f"KBT{i:03d}" for i in range(1, 15) if i not in (6, 7, 12)
        ]


# ---------------------------------------------------------------------------
# CLI: exit codes + JSONL
# ---------------------------------------------------------------------------


class TestCli:
    def _run(self, *args):
        return subprocess.run(
            [sys.executable, "-m", "kube_batch_tpu_torch.analysis", *args],
            capture_output=True, text=True,
            cwd=str(Path(__file__).resolve().parent.parent),
        )

    def test_clean_tree_exits_zero(self):
        proc = self._run("kube_batch_tpu_torch/analysis")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert proc.stdout.strip().endswith("kbt-check: clean")

    def test_races_over_the_package_exits_zero(self):
        proc = self._run("--races")
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_findings_exit_nonzero_and_jsonl_parses(self, tmp_path):
        bad = tmp_path / "ops" / "hot.py"
        bad.parent.mkdir()
        bad.write_text("def f(x):\n    x.cpu()\n")
        proc = self._run("--jsonl", str(bad))
        assert proc.returncode == 1
        rows = [json.loads(l) for l in proc.stdout.splitlines() if l.strip()]
        assert rows and rows[0]["rule"] == "KBT005"
        assert rows[0]["line"] == 2

    def test_select_unknown_rule_is_usage_error(self):
        proc = self._run("--select", "KBT999")
        assert proc.returncode == 2

    def test_jax_only_rule_ids_are_unknown(self):
        # KBT006/KBT007 name JAX idioms and are not carried
        assert cli.main(["--select", "KBT006"]) == 2
        assert cli.main(["--select", "KBT007"]) == 2

    def test_nonexistent_path_is_a_finding_not_clean(self):
        # a typo'd CI path must not report clean/exit 0
        proc = self._run("no/such/dir")
        assert proc.returncode == 1
        assert "does not exist" in proc.stdout

    def test_no_tier_is_a_usage_error(self):
        assert cli.main([]) == 2

    def test_static_select_skips_the_device_tiers(self, monkeypatch):
        # a tier-A-only selection must not run tier B or C only to discard
        # their findings
        from kube_batch_tpu_torch.analysis import memory_audit, program_audit

        def boom(*a, **k):
            raise AssertionError("a device tier must not run for a static-only select")

        monkeypatch.setattr(program_audit, "run_audit", boom)
        monkeypatch.setattr(memory_audit, "run_memory_audit", boom)
        rc = cli.main(["--programs", "--memory", "--select", "KBT001",
                       "kube_batch_tpu_torch/analysis"])
        assert rc == 0

    def test_device_select_skips_tiers_a_and_d(self, monkeypatch):
        # a KBT20x selection routes to tier C alone
        from kube_batch_tpu_torch.analysis import memory_audit, program_audit

        calls = {}

        def fake_memory(registry, device=None, select=None, runs=None):
            calls["select"] = select
            return []

        def boom(*a, **k):
            raise AssertionError("tiers A and D must not run for a KBT20x select")

        monkeypatch.setattr(memory_audit, "run_memory_audit", fake_memory)
        monkeypatch.setattr(program_audit, "default_registry", lambda device: ())
        monkeypatch.setattr(cli, "run_paths", boom)
        assert cli.main(["--select", "KBT203", "--device", "cpu"]) == 0
        assert calls["select"] == ["KBT203"]

    def test_list_rules_includes_all_tiers(self):
        proc = self._run("--list-rules")
        assert proc.returncode == 0
        for rid in ("KBT005", "KBT010", "KBT101", "KBT201", "KBT204", "KBT301"):
            assert rid in proc.stdout
        assert "KBT006" not in proc.stdout and "KBT007" not in proc.stdout


# ---------------------------------------------------------------------------
# KBT014 — span discipline (obs.trace context managers, no clocks in bodies)
# ---------------------------------------------------------------------------


class TestKBT014:
    def test_perf_counter_pair_inside_span_body_flagged(self):
        src = """
        from kube_batch_tpu_torch import metrics
        from kube_batch_tpu_torch.utils import telemetry

        def f(tracer, action):
            with tracer.span("a"):
                t0 = telemetry.perf_counter()
                action()
                metrics.observe_action_latency(
                    "a", (telemetry.perf_counter() - t0) * 1e6)
        """
        findings = findings_for(src, "actions/x.py")
        assert "KBT014" in rule_ids(findings)
        assert sum(1 for f in findings if f.rule == "KBT014") == 2

    def test_raw_time_inside_span_body_flagged(self):
        # serve/ is outside KBT001's scope — the span-body ban still holds
        src = """
        import time

        def f(tracer):
            with tracer.device_span("probe"):
                time.monotonic()
        """
        findings = findings_for(src, "serve/x.py")
        assert rule_ids(findings) == ["KBT014"]

    def test_manual_span_construction_flagged(self):
        src = """
        from kube_batch_tpu_torch.obs.trace import Span

        def f(tracer):
            sp = Span(tracer, "x")
            return sp
        """
        findings = findings_for(src, "cache/x.py")
        assert "KBT014" in rule_ids(findings)

    def test_span_duration_read_after_block_is_the_sanctioned_form(self):
        src = """
        from kube_batch_tpu_torch import metrics

        def f(tracer, action):
            with tracer.span("a") as sp:
                action()
            metrics.observe_action_latency("a", sp.dur_us)
        """
        assert findings_for(src, "scheduler.py") == []

    def test_injected_clock_inside_span_body_is_sanctioned(self):
        src = """
        class S:
            def f(self):
                with self.tracer.span("pace"):
                    t = self.clock.monotonic()
                return t
        """
        assert findings_for(src, "scheduler.py") == []

    def test_out_of_scope_paths_unflagged(self):
        src = """
        from kube_batch_tpu_torch.utils import telemetry

        def f(tracer):
            with tracer.span("a"):
                return telemetry.perf_counter()
        """
        assert findings_for(src, "analysis/x.py") == []

    def test_annotation_suppresses(self):
        src = """
        from kube_batch_tpu_torch.utils import telemetry

        def f(tracer):
            with tracer.span("a"):
                # kbt: allow[KBT014] migration shim measured both ways
                return telemetry.perf_counter()
        """
        assert findings_for(src, "actions/x.py") == []
