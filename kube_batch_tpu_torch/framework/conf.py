"""Scheduler behaviour configuration (conf/scheduler_conf.go:20-56,
pkg/scheduler/util.go:31-70), mirroring ``kube_batch_tpu/framework/conf.py``.

The conf text has the reference's shape:

    actions: "allocate"
    tiers:
    - plugins:
      - name: priority
      - name: gang
    - plugins:
      - name: nodeorder
        arguments:
          leastrequested.weight: 2

Each plugin option carries nine enable switches (all default true) and an
Arguments string map.  The port reads this text without PyYAML: a small
block-YAML reader (``_load_yaml``) covers the mappings, sequences and
scalars such confs use and resolves scalars as YAML 1.1 does (so an
argument ``true`` becomes the string ``"True"``, as through
``yaml.safe_load``).  ``parse_scheduler_conf`` also takes the parsed dict.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import List, Optional, Tuple

from kube_batch_tpu_torch.framework.arguments import Arguments

ENABLE_FIELDS = (
    "enabledJobOrder",
    "enabledJobReady",
    "enabledJobPipelined",
    "enabledTaskOrder",
    "enabledPreemptable",
    "enabledReclaimable",
    "enabledQueueOrder",
    "enabledPredicate",
    "enabledNodeOrder",
)


@dataclasses.dataclass
class PluginOption:
    name: str
    enabled_job_order: bool = True
    enabled_job_ready: bool = True
    enabled_job_pipelined: bool = True
    enabled_task_order: bool = True
    enabled_preemptable: bool = True
    enabled_reclaimable: bool = True
    enabled_queue_order: bool = True
    enabled_predicate: bool = True
    enabled_node_order: bool = True
    arguments: Arguments = dataclasses.field(default_factory=Arguments)


@dataclasses.dataclass
class Tier:
    plugins: List[PluginOption] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SchedulerConfiguration:
    actions: List[str] = dataclasses.field(default_factory=list)
    tiers: List[Tier] = dataclasses.field(default_factory=list)


def _snake(field: str) -> str:
    """enabledJobOrder → enabled_job_order"""
    return re.sub(r"([A-Z])", lambda m: "_" + m.group(1).lower(), field)


# ---------------------------------------------------------------------------
# a block-YAML reader for scheduler confs
# ---------------------------------------------------------------------------

_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _scalar(text: str):
    """A plain or quoted scalar, resolved like PyYAML's safe loader for the
    forms a conf uses: null, bool, int, float, flow sequences and maps of
    scalars, strings."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return json.loads(t)
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_scalar(x) for x in inner.split(",")] if inner else []
    if t.startswith("{") and t.endswith("}"):
        inner = t[1:-1].strip()
        out = {}
        for item in inner.split(",") if inner else ():
            k, _, v = item.partition(":")
            out[_scalar(k)] = _scalar(v)
        return out
    if t in _NULLS:
        return None
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t) and any(c.isdigit() for c in t):
        return float(t.replace("_", ""))
    return t


def _strip_comment(line: str) -> str:
    """The line without a trailing ``# comment`` outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """(key, rest) of a ``key: value`` / ``key:`` line, None for a scalar."""
    m = re.match(r"^(\"[^\"]*\"|'[^']*'|[^:#\[\]{}]+?)\s*:(\s+(.*))?$", text)
    if m is None:
        return None
    return str(_scalar(m.group(1))), (m.group(3) or "").strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines, i: int, indent: int):
    """Parse the block node whose first line is ``lines[i]`` at ``indent``;
    returns (value, next line index)."""
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            rest = lines[i][1][1:].lstrip()
            if not rest:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    value, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    value, i = None, i + 1
            else:
                # the item's content starts a node at its own column
                col = indent + len(lines[i][1]) - len(rest)
                lines[i] = (col, rest)
                value, i = _block(lines, i, col)
            out.append(value)
        return out, i
    kv = _split_key(lines[i][1])
    if kv is None:
        return _scalar(lines[i][1]), i + 1
    out = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"conf line {lines[i][1]!r}: expected 'key: value'")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent
                                 or (lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def _load_yaml(text: str):
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip() and line.strip() != "---":
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"conf line {lines[i][1]!r}: unexpected indentation")
    return value


def parse_scheduler_conf(text_or_dict) -> SchedulerConfiguration:
    """The conf from its YAML text (or the dict it parses to).  Action names
    are resolved later, against the action registry, at Scheduler
    construction (util.go:63-70)."""
    data = (text_or_dict if isinstance(text_or_dict, dict)
            else _load_yaml(text_or_dict)) or {}
    actions = [a.strip() for a in str(data.get("actions", "")).split(",") if a.strip()]
    tiers: List[Tier] = []
    for tier_data in data.get("tiers") or []:
        plugins = []
        for p in tier_data.get("plugins") or []:
            opt = PluginOption(name=p["name"])
            for field in ENABLE_FIELDS:
                if field in p:
                    setattr(opt, _snake(field), bool(p[field]))
            if p.get("arguments"):
                opt.arguments = Arguments(
                    {str(k): str(v) for k, v in p["arguments"].items()})
            plugins.append(opt)
        tiers.append(Tier(plugins=plugins))
    return SchedulerConfiguration(actions=actions, tiers=tiers)


#: the built-in fallback conf, the JAX package's (pkg/scheduler/util.go:31-42)
DEFAULT_CONF = """
actions: "allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def default_configuration() -> SchedulerConfiguration:
    return parse_scheduler_conf(DEFAULT_CONF)


def shipped_conf_path() -> str:
    """Absolute path of the shipped five-action conf
    (``config/kube-batch-tpu-conf.yaml`` at the repository root)."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "config", "kube-batch-tpu-conf.yaml")


def load_scheduler_conf(path: Optional[str]) -> SchedulerConfiguration:
    """The conf from a file, or the default when ``path`` is None."""
    if not path:
        return default_configuration()
    with open(path) as f:
        return parse_scheduler_conf(f.read())
