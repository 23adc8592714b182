"""CLI for the virtual-time cluster simulator.

    python -m kube_batch_tpu_torch.sim --seed 7 --preset smoke
    python -m kube_batch_tpu_torch.sim --preset fault --trace /tmp/fault.jsonl
    python -m kube_batch_tpu_torch.sim --preset bind-storm        # chaos: binder flaps under a gang burst
    python -m kube_batch_tpu_torch.sim --preset brownout          # chaos: apiserver egress window outage
    python -m kube_batch_tpu_torch.sim --preset leader-failover   # chaos: warm-standby takeover mid-run

Emits a single JSON report (`metric`/`value`/`unit` plus the longitudinal
detail) on stdout. Same seed ⇒ byte-identical trace (`trace_sha256` in the
report is the determinism receipt).

Mirrors ``kube_batch_tpu/sim/__main__.py``: the same flags, output and exit
codes.  The scheduler runs on the card; the device is a keyword of
:func:`main`, not a flag (``main(argv, device="cpu")`` runs on the CPU,
and ``None`` means CUDA and raises without a card).
"""

from __future__ import annotations

import argparse
import json
import sys

from kube_batch_tpu_torch.sim.runner import run_preset


def passed(report) -> bool:
    """The exit criteria of a preset run: no invariant errors, recovered
    faults, no duplicate binds, and on a corruption run the guard plane's
    invariants (zero bad binds, demotion engaged, re-promotion, bundle
    written)."""
    errs = report.get("invariants", {}).get("errors", [])
    recovered = report.get("fault_recovery", {}).get("recovered", True)
    duplicates = report.get("bind_integrity", {}).get("duplicate_binds", 0)
    guard_ok = report.get("guard", {}).get("chaos_ok", True)
    return not errs and recovered and not duplicates and guard_ok


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="smoke",
                    help="scenario: smoke | fault | churn | brownout | "
                         "bind-storm | leader-failover | corruption "
                         "(default smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cycles", type=int, default=None,
                    help="override the preset's virtual-cycle budget")
    ap.add_argument("--trace", default=None,
                    help="write the JSONL event trace to this path")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="export the cycle span trees (the flight-recorder "
                         "ring) as Chrome trace-event JSON for "
                         "chrome://tracing / Perfetto")
    ap.add_argument("--report", default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--no-fairness-series", action="store_true",
                    help="omit the per-cycle fairness series (compact)")
    ap.add_argument("--pipelined", action="store_true",
                    help="event-driven pipelined cycles: wake at arrivals "
                         "(floored by the preset's min_period) instead of "
                         "the fixed tick; staged close + writeback worker")
    ap.add_argument("--warm-ab", action="store_true",
                    help="KB_WARM A/B: run the preset twice — carried "
                         "candidate table (KB_WARM default) vs the cold "
                         "per-solve build (KB_WARM=0) — and exit nonzero "
                         "unless every acked bind is identical "
                         "(bind_digest equality; the warm leg must also "
                         "actually engage the carry)")
    ap.add_argument("--replay-bundle", default=None, metavar="DIR",
                    help="replay a guard-plane diagnostics bundle instead "
                         "of running a preset: re-run the condemned solve "
                         "and its oracle on the captured snapshot, "
                         "sentinel-fused both ways (exit 0 iff the "
                         "integrity failure reproduces)")
    args = ap.parse_args(argv)

    if args.replay_bundle:
        from kube_batch_tpu_torch.guard.bundle import replay_bundle

        report = replay_bundle(args.replay_bundle, device)
        out = json.dumps(report, indent=2, sort_keys=True)
        if args.report:
            with open(args.report, "w") as f:
                f.write(out + "\n")
        print(out, flush=True)
        return 0 if report.get("reproduced") else 1

    if args.warm_ab:
        # the warm-carry decision-equality leg: same preset, same seed,
        # KB_WARM on vs off — bit-identical binds required.
        # Runs in-process back to back; the runner is seed-deterministic
        # and each run builds a fresh cache, so the only varying input is
        # the knob under test.
        import os

        saved = os.environ.get("KB_WARM")
        try:
            os.environ.pop("KB_WARM", None)
            warm = run_preset(args.preset, seed=args.seed,
                              cycles=args.cycles, pipelined=args.pipelined,
                              device=device)
            os.environ["KB_WARM"] = "0"
            cold = run_preset(args.preset, seed=args.seed,
                              cycles=args.cycles, pipelined=args.pipelined,
                              device=device)
        finally:
            if saved is None:
                os.environ.pop("KB_WARM", None)
            else:
                os.environ["KB_WARM"] = saved
        match = warm.get("bind_digest") == cold.get("bind_digest")
        # "engaged" = the CARRY actually served (merge cycles, not cold
        # rebuilds — a regression that escalates every plan to cold would
        # trivially match the oracle while the feature is dead)
        wrep = warm.get("warm", {})
        engaged = (
            wrep.get("warm_cycles", 0) - wrep.get("cold_builds", 0) > 0
        )
        out = json.dumps({
            "preset": args.preset, "seed": args.seed,
            "binds_match": match, "warm_engaged": engaged,
            "warm": warm.get("warm"),
            "acked_binds_warm": warm.get("bind_integrity", {}).get(
                "acked_binds"),
            "acked_binds_cold": cold.get("bind_integrity", {}).get(
                "acked_binds"),
        }, indent=2, sort_keys=True)
        if args.report:
            with open(args.report, "w") as f:
                f.write(out + "\n")
        print(out, flush=True)
        return 0 if match and engaged else 1

    report = run_preset(args.preset, seed=args.seed, cycles=args.cycles,
                        trace_path=args.trace, pipelined=args.pipelined,
                        chrome_trace_path=args.chrome_trace, device=device)
    if args.no_fairness_series:
        report.pop("fairness_series", None)
    out = json.dumps(report, indent=2, sort_keys=True)
    if args.report:
        with open(args.report, "w") as f:
            f.write(out + "\n")
    print(out, flush=True)
    return 0 if passed(report) else 1


if __name__ == "__main__":
    sys.exit(main())
