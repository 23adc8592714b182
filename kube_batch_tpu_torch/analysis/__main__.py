"""``python -m kube_batch_tpu_torch.analysis`` — the port's analyzer.

Tier A (``--static``, or any ``paths`` given alone): the AST and flow
rules (KBT001–005, 008–011, 013, 014) over the package tree or ``paths``.
Tier D (``--races``): the thread/lock-domain race rules (KBT301–304) —
added to tier A; ``--races-only`` runs just that tier, and ``--domains``
prints the inferred per-class lock-domain map instead of findings.
Tier B (``--programs``) runs KBT101–104 at the audit point; tier C
(``--memory``) runs KBT201–204 at the points the device reaches; both
share one recorded call per program and point, on ``--device`` (``cuda``,
the default, raises without a card; or ``cpu``).  ``--select`` keeps a
rule subset across all four tiers and implies each tier it names
(``KBT012`` is an alias for ``KBT302``); ``--jsonl`` prints one JSON
object per finding, ``--seed`` draws the points' data.

Exit status: 0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys

from kube_batch_tpu_torch.analysis.engine import RULE_ALIASES, run_paths
from kube_batch_tpu_torch.analysis.races import (
    RACE_RULES, RACE_RULES_BY_ID, domains_report,
)
from kube_batch_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_ID


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kube_batch_tpu_torch.analysis",
        description="the analyzer of kube_batch_tpu_torch "
                    "(rule catalog: --list-rules)")
    parser.add_argument("paths", nargs="*",
                        help="files/directories for tiers A and D (default: the "
                             "kube_batch_tpu_torch package tree)")
    parser.add_argument("--static", action="store_true", help="tier A: the AST/flow rules")
    parser.add_argument("--races", action="store_true",
                        help="tier D with tier A: KBT301-304")
    parser.add_argument("--races-only", action="store_true", help="tier D alone")
    parser.add_argument("--domains", action="store_true",
                        help="print tier D's inferred lock-domain map and exit 0")
    parser.add_argument("--programs", action="store_true", help="tier B: KBT101-104")
    parser.add_argument("--memory", action="store_true", help="tier C: KBT201-204")
    parser.add_argument("--device", default="cuda", help="tiers B and C: cuda (default) or cpu")
    parser.add_argument("--select", metavar="RULES", help="comma-separated rule ids")
    parser.add_argument("--jsonl", action="store_true", help="one JSON object per finding")
    parser.add_argument("--seed", type=int, default=0, help="seed of the points' data")
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0

    def device_tiers():
        from kube_batch_tpu_torch.analysis import memory_audit, program_audit

        return program_audit, memory_audit

    if args.list_rules:
        program_audit, memory_audit = device_tiers()
        for rule in ALL_RULES:
            scope = ", ".join(rule.scope) if rule.scope else "package-wide"
            print(f"{rule.id}  {rule.title}  [{scope}]")
        for rid, title in program_audit.AUDIT_RULES.items():
            print(f"{rid}  {title}  [programs]")
        for rid, title in memory_audit.HBM_RULES.items():
            print(f"{rid}  {title}  [memory]")
        for rule in RACE_RULES:
            print(f"{rule.id}  {rule.title}  [race analysis]")
        for alias, target in sorted(RULE_ALIASES.items()):
            print(f"{alias}  alias for {target}")
        return 0

    if args.domains:
        print(domains_report(args.paths))
        return 0

    static_rules = race_rules = b_select = c_select = None
    if args.select:
        program_audit, memory_audit = device_tiers()
        ids = [RULE_ALIASES.get(r.strip(), r.strip())
               for r in args.select.split(",") if r.strip()]
        unknown = [r for r in ids
                   if r not in RULES_BY_ID and r not in RACE_RULES_BY_ID
                   and r not in program_audit.AUDIT_RULES
                   and r not in memory_audit.HBM_RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
        # each tier runs exactly its selected rules, and only when it has any
        static_rules = [RULES_BY_ID[r] for r in ids if r in RULES_BY_ID]
        race_rules = [RACE_RULES_BY_ID[r] for r in ids if r in RACE_RULES_BY_ID]
        b_select = [r for r in ids if r in program_audit.AUDIT_RULES]
        c_select = [r for r in ids if r in memory_audit.HBM_RULES]
        run_static, run_races = bool(static_rules), bool(race_rules)
        args.programs, args.memory = bool(b_select), bool(c_select)
    else:
        run_races = args.races or args.races_only
        run_static = (args.static or (args.races and not args.races_only)
                      or (bool(args.paths) and not (run_races or args.programs
                                                    or args.memory)))
    if not (run_static or run_races or args.programs or args.memory):
        print("nothing to run: pass --static, --races, --programs, --memory or "
              "--select", file=sys.stderr)
        return 2

    findings = []
    if run_static:
        findings += run_paths(args.paths, rules=static_rules or list(ALL_RULES))
    if run_races:
        findings += run_paths(args.paths, rules=race_rules or list(RACE_RULES))
    if args.programs or args.memory:
        program_audit, memory_audit = device_tiers()
        program_audit.SEED = args.seed
        registry = program_audit.default_registry(args.device)
        runs: dict = {}
        if args.programs:
            findings += program_audit.run_audit(registry, args.device, b_select, runs=runs)
        if args.memory:
            findings += memory_audit.run_memory_audit(registry, device=args.device,
                                                      select=c_select, runs=runs)

    # tiers A and D both flow through run_paths, so an engine-level KBT000
    # (a bad suppression, a missing path) would repeat once per tier
    seen, deduped = set(), []
    for f in findings:
        key = (f.rule, f.path, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            deduped.append(f)
    for f in deduped:
        print(json.dumps(f.to_dict(), sort_keys=True) if args.jsonl else f.render())
    if not args.jsonl:
        n = len(deduped)
        tool = "kbt-audit" if (args.programs or args.memory) else "kbt-check"
        print(f"{tool}: {n} finding{'s' if n != 1 else ''}" if n else f"{tool}: clean")
    return 1 if deduped else 0


if __name__ == "__main__":
    sys.exit(main())
