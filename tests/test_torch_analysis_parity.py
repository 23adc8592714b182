"""Tiers A and D of the port's analyzer against the JAX package's, on one
corpus, on the CPU.

For every rule that names no JAX idiom — KBT001–004, 008, 009, 011, 013,
014 and 301–304 — the two engines must report the same (rule, line,
column) on:

- the snippet corpus: every multi-line string of the two packages' tier-A
  and tier-D test files that parses as Python, each read as a module at
  each of a set of package paths (the rules are scoped by path);
- both source trees with their ``# kbt: allow[...]`` annotations
  disarmed (same lines, no suppression), so every raw finding of either
  tree is compared.

And with every rule of each engine and the annotations armed, both report
clean over both trees.  KBT005 and KBT010 read torch in the port and JAX
in the JAX package; KBT006/007 exist only in the JAX package."""

from __future__ import annotations

import ast
import re
import textwrap
from pathlib import Path

import pytest

from kube_batch_tpu.analysis import engine as jax_engine
from kube_batch_tpu.analysis import races as jax_races
from kube_batch_tpu.analysis import rules as jax_rules
from kube_batch_tpu_torch.analysis import engine, races, rules
from test_torch_jax_caches import fresh_jax_caches  # noqa: F401 — clears the JAX caches around the module
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
SHARED = ("KBT001", "KBT002", "KBT003", "KBT004", "KBT008", "KBT009", "KBT011",
          "KBT013", "KBT014", "KBT301", "KBT302", "KBT303", "KBT304")
#: the paths a snippet is read at: one per rule scope
RELPATHS = ("scheduler.py", "actions/x.py", "cache/cache.py", "framework/x.py",
            "k8s/translate.py", "k8s/x.py", "cmd/x.py", "serve/x.py", "sim/x.py",
            "ops/x.py", "testing/x.py")
CORPUS_FILES = ("test_analysis.py", "test_races.py", "test_torch_analysis.py",
                "test_torch_races.py")
_ALLOW = re.compile(r"kbt:(\s*)allow\[")


def _port_rules():
    by_id = {**rules.RULES_BY_ID, **races.RACE_RULES_BY_ID}
    return [by_id[r] for r in SHARED]


def _jax_rules():
    by_id = {**jax_rules.RULES_BY_ID, **jax_races.RACE_RULES_BY_ID}
    return [by_id[r] for r in SHARED]


def _snippets():
    out = []
    for name in CORPUS_FILES:
        for node in ast.walk(ast.parse((TESTS / name).read_text())):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and node.value.count("\n") >= 2):
                src = textwrap.dedent(node.value)
                try:
                    ast.parse(src)
                except SyntaxError:
                    continue
                out.append(src)
    return sorted(set(out))


def _keys(findings, rule_ids):
    return sorted((f.rule, f.line, f.col) for f in findings if f.rule in rule_ids)


@pytest.fixture(scope="module")
def compared():
    """{rule: [(where, jax keys, port keys)]} over the whole corpus."""
    pr, jr = _port_rules(), _jax_rules()
    out = {r: [] for r in SHARED}

    def both(src, relpath, where):
        pk = _keys(engine.check_source(src, relpath, rules=pr), SHARED)
        jk = _keys(jax_engine.check_source(src, relpath, rules=jr), SHARED)
        for r in SHARED:
            out[r].append((where, [k for k in jk if k[0] == r], [k for k in pk if k[0] == r]))

    snippets = _snippets()
    for i, src in enumerate(snippets):
        for relpath in RELPATHS:
            both(src, relpath, f"snippet {i} at {relpath}")
    for pkg in ("kube_batch_tpu", "kube_batch_tpu_torch"):
        for path in sorted((ROOT / pkg).rglob("*.py")):
            rel = path.relative_to(ROOT / pkg).as_posix()
            both(_ALLOW.sub(r"kbt:\1disarmed[", path.read_text()), rel, f"{pkg}/{rel}")
    return out, len(snippets)


def test_the_corpus_is_real(compared):
    out, n_snippets = compared
    assert n_snippets > 100
    # every shared rule fires somewhere in the corpus, in both engines
    for r in SHARED:
        assert any(jk for _w, jk, _pk in out[r]), r
        assert any(pk for _w, _jk, pk in out[r]), r


@pytest.mark.parametrize("rule", SHARED)
def test_same_findings_as_the_jax_engine(compared, rule):
    out, _ = compared
    diff = [(w, jk, pk) for w, jk, pk in out[rule] if jk != pk]
    assert diff == [], diff[:5]


@pytest.mark.parametrize("pkg", ["kube_batch_tpu", "kube_batch_tpu_torch"])
def test_both_engines_clean_over_both_trees(pkg):
    tree = [str(ROOT / pkg)]
    port = engine.run_paths(tree, rules=list(rules.ALL_RULES) + list(races.RACE_RULES))
    jax = jax_engine.run_paths(tree, rules=list(jax_rules.ALL_RULES) + list(jax_races.RACE_RULES))
    assert port == [], "\n".join(f.render() for f in port[:10])
    assert jax == [], "\n".join(f.render() for f in jax[:10])
