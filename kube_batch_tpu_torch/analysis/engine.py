"""Lint engine of tiers A and D: file walking, suppression parsing, rule
dispatch (the JAX package's ``analysis/engine.py``, kept as the port's own
copy).

A rule sees one parsed module at a time plus its package-relative path
(e.g. ``actions/allocate.py``) — scoping is by path prefix, so the same
rule objects run identically over the installed package and over the
fixture snippets in tests.

The engine is flow-aware: for each module it builds ONE
:class:`~kube_batch_tpu_torch.analysis.dataflow.ModuleContext` — resolved
imports, module symbol table, function index — and hands it to every rule
through ``check_ctx``.  Line-local rules keep their ``check(tree, relpath)``
signature (the base class adapts); flow rules (flowrules.py) override
``check_ctx`` and additionally get intra-procedural def-use tracking from
``dataflow.walk_function``.

Suppression contract: ``# kbt: allow[KBT001] reason`` on the finding's
line or the line directly above suppresses that rule there. The reason
text is mandatory; an allow with no reason suppresses nothing and instead
raises a KBT000 finding, so unexplained escapes can't accumulate.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from kube_batch_tpu_torch.analysis.findings import Finding

#: package whose source tree is the default analysis target
PACKAGE_NAME = "kube_batch_tpu_torch"

_ALLOW_RE = re.compile(r"kbt:\s*allow\[([A-Za-z0-9_,\s]+)\]\s*(.*)")

#: rule-id aliases, honored by `--select` AND by allow comments: when a
#: rule migrates tiers its old id keeps meaning (KBT012 — the pipelined
#: writeback handoff check — is a tier-D KBT302 instance).  Lives here
#: (not races.py) so Suppressions can resolve without an engine→races
#: import cycle; races re-exports it for the CLI.
RULE_ALIASES = {"KBT012": "KBT302"}


class Suppressions:
    """Per-line ``kbt: allow[...]`` map for one source file."""

    def __init__(self) -> None:
        self.by_line: Dict[int, Set[str]] = {}
        # allow comments missing the mandatory reason: (line, rules)
        self.missing_reason: List[Tuple[int, str]] = []

    @classmethod
    def parse(cls, source: str) -> "Suppressions":
        """An allow comment covers its own line (inline trailing form) and —
        when it's a comment-only line — the next code line, with any
        intervening comment/blank lines bridged (so a multi-line annotation
        block covers the statement it introduces)."""
        sup = cls()
        lines = source.splitlines()

        def _code_line_after(ln: int) -> int:
            i = ln  # 1-based comment line; scan forward
            while i < len(lines):
                stripped = lines[i].strip()
                if stripped and not stripped.startswith("#"):
                    return i + 1
                i += 1
            return ln

        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _ALLOW_RE.search(tok.string)
                if m is None:
                    continue
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                if not m.group(2).strip():
                    sup.missing_reason.append((tok.start[0], ",".join(sorted(rules))))
                    continue
                ln = tok.start[0]
                sup.by_line.setdefault(ln, set()).update(rules)
                comment_only = lines[ln - 1].strip().startswith("#")
                if comment_only:
                    sup.by_line.setdefault(_code_line_after(ln), set()).update(rules)
        except tokenize.TokenError:
            pass  # a finding-bearing parse already failed upstream
        return sup

    def covers(self, rule: str, line: int) -> bool:
        allowed = self.by_line.get(line, set())
        if rule in allowed:
            return True
        # honor aliased ids: allow[KBT012] keeps suppressing the rule it
        # migrated into (KBT302)
        return any(RULE_ALIASES.get(a) == rule for a in allowed)


class Rule:
    """Base rule: subclasses set ``id``/``title``/``scope`` and implement
    ``check``. ``scope`` is a tuple of package-relative path prefixes; empty
    means package-wide."""

    id: str = "KBT000"
    title: str = ""
    scope: Tuple[str, ...] = ()

    def applies_to(self, relpath: str) -> bool:
        if not self.scope:
            return True
        # prefix match for package-relative paths; segment match so files
        # addressed by absolute/external paths (CLI on a checkout, test
        # fixtures) still land in the right scope
        return any(
            relpath.startswith(p) or f"/{p}" in f"/{relpath}"
            for p in self.scope
        )

    def check(self, tree: ast.Module, relpath: str) -> Iterable[Tuple[int, int, str]]:
        raise NotImplementedError

    def check_ctx(self, ctx) -> Iterable[Tuple[int, int, str]]:
        """Flow-aware entry point: receives the shared ModuleContext.  The
        default adapts line-local rules; flow rules override this."""
        return self.check(ctx.tree, ctx.relpath)


def check_source(
    source: str,
    relpath: str,
    rules: Optional[Sequence[Rule]] = None,
    display_path: Optional[str] = None,
) -> List[Finding]:
    """Run ``rules`` over one module's source. ``relpath`` is the
    package-relative posix path used for rule scoping; ``display_path`` is
    what findings print (defaults to ``relpath``)."""
    from kube_batch_tpu_torch.analysis.rules import ALL_RULES

    if rules is None:
        rules = ALL_RULES
    display = display_path or relpath
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("KBT000", display, e.lineno or 0, e.offset or 0,
                        f"syntax error: {e.msg}")]
    from kube_batch_tpu_torch.analysis.dataflow import ModuleContext

    ctx = ModuleContext(tree, relpath)  # built once, shared by every rule
    sup = Suppressions.parse(source)
    findings: List[Finding] = []
    for line, rules_txt in sup.missing_reason:
        findings.append(Finding(
            "KBT000", display, line, 0,
            f"allow[{rules_txt}] has no reason — suppression ignored; "
            "write `# kbt: allow[RULE] why it is safe`",
        ))
    for rule in rules:
        if not rule.applies_to(relpath):
            continue
        for line, col, message in rule.check_ctx(ctx):
            if sup.covers(rule.id, line):
                continue
            findings.append(Finding(rule.id, display, line, col, message))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _package_relpath(path: Path) -> str:
    """Path → package-relative posix path for scoping: everything after the
    last ``kube_batch_tpu_torch`` component, else the whole path."""
    parts = path.as_posix().split("/")
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE_NAME:
            return "/".join(parts[i + 1:])
    # outside the package: keep the full path so directory-segment scoping
    # (applies_to) still sees ops/, actions/, ... components
    return path.as_posix().lstrip("/")


def iter_python_files(paths: Sequence[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def run_paths(
    paths: Optional[Sequence[str]] = None,
    rules: Optional[Sequence[Rule]] = None,
) -> List[Finding]:
    """Analyze files/directories (default: the installed package tree)."""
    if not paths:
        roots = [Path(__file__).resolve().parent.parent]
    else:
        roots = [Path(p) for p in paths]
    findings: List[Finding] = []
    for r in roots:
        # a missing path must NOT read as "clean": a typo'd/renamed CI
        # argument would silently stop checking anything while staying green
        if not r.exists():
            findings.append(Finding(
                "KBT000", str(r), 0, 0, "path does not exist"))
    for f in iter_python_files(roots):
        try:
            source = f.read_text()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding("KBT000", str(f), 0, 0, f"unreadable: {e}"))
            continue
        findings.extend(check_source(
            source, _package_relpath(f), rules=rules, display_path=str(f)
        ))
    return findings
