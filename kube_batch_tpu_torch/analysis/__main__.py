"""``python -m kube_batch_tpu_torch.analysis`` — the device-program audits.

``--programs`` runs tier B (KBT101–104) at the audit point; ``--memory``
runs tier C (KBT201–204) at the points the device reaches; both share one
recorded call per program and point.  ``--device`` is ``cuda`` (the
default; raises without a card) or ``cpu``.  ``--select`` keeps a rule
subset (KBT10x ids imply ``--programs``, KBT20x ids ``--memory``),
``--jsonl`` prints one JSON object per finding, ``--seed`` draws the
points' data.

Exit status: 0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from kube_batch_tpu_torch.analysis import memory_audit, program_audit

    parser = argparse.ArgumentParser(
        prog="python -m kube_batch_tpu_torch.analysis",
        description="device-program audits of kube_batch_tpu_torch "
                    "(rule catalog: the package docstring)")
    parser.add_argument("--programs", action="store_true", help="tier B: KBT101-104")
    parser.add_argument("--memory", action="store_true", help="tier C: KBT201-204")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--select", metavar="RULES", help="comma-separated rule ids")
    parser.add_argument("--jsonl", action="store_true", help="one JSON object per finding")
    parser.add_argument("--seed", type=int, default=0, help="seed of the points' data")
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0

    if args.list_rules:
        for rid, title in program_audit.AUDIT_RULES.items():
            print(f"{rid}  {title}  [programs]")
        for rid, title in memory_audit.HBM_RULES.items():
            print(f"{rid}  {title}  [memory]")
        return 0

    b_select = c_select = None
    if args.select:
        ids = [r.strip() for r in args.select.split(",") if r.strip()]
        unknown = [r for r in ids
                   if r not in program_audit.AUDIT_RULES and r not in memory_audit.HBM_RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
        b_select = [r for r in ids if r in program_audit.AUDIT_RULES]
        c_select = [r for r in ids if r in memory_audit.HBM_RULES]
        args.programs, args.memory = bool(b_select), bool(c_select)
    if not (args.programs or args.memory):
        print("nothing to run: pass --programs, --memory or --select", file=sys.stderr)
        return 2

    program_audit.SEED = args.seed
    registry = program_audit.default_registry(args.device)
    runs: dict = {}
    findings = []
    if args.programs:
        findings += program_audit.run_audit(registry, args.device, b_select, runs=runs)
    if args.memory:
        findings += memory_audit.run_memory_audit(registry, device=args.device,
                                                  select=c_select, runs=runs)

    for f in findings:
        print(json.dumps(f.to_dict(), sort_keys=True) if args.jsonl else f.render())
    if not args.jsonl:
        n = len(findings)
        print(f"kbt-audit: {n} finding{'s' if n != 1 else ''}" if n else "kbt-audit: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
