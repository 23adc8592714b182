"""Action / Plugin interfaces and the port's registries
(framework/interface.go:20-41, framework/plugins.go:24-72), mirroring
``kube_batch_tpu/framework/interface.py``.

Both registries hold builders and are filled once, when
``kube_batch_tpu_torch.plugins`` and ``kube_batch_tpu_torch.actions`` are
imported.  ``get_action`` builds a fresh action, so two schedulers in one
process never share an action's per-cycle state.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from kube_batch_tpu_torch.framework.arguments import Arguments


class Plugin:
    """A scheduling policy: registers callbacks into the Session on open
    (interface.go:35-41)."""

    name: str = "plugin"

    def __init__(self, arguments: Optional[Arguments] = None):
        self.arguments = arguments or Arguments()

    def on_session_open(self, session) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def on_session_close(self, session) -> None:
        pass


class Action:
    """A scheduling pass over the session (interface.go:20-32)."""

    name: str = "action"

    def execute(self, session) -> None:  # pragma: no cover - interface
        raise NotImplementedError


# kbt: allow[KBT003] import-time registry: filled once by module import
# (plugins/__init__, actions/__init__), read-only at scheduling time
_plugin_builders: Dict[str, Callable[[Arguments], Plugin]] = {}
# kbt: allow[KBT003] import-time registry, same contract as _plugin_builders
_action_builders: Dict[str, Callable[[], Action]] = {}


def register_plugin_builder(name: str, builder: Callable[[Arguments], Plugin]) -> None:
    _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Callable[[Arguments], Plugin]:
    if name not in _plugin_builders:
        raise KeyError(f"unknown plugin {name!r}")
    return _plugin_builders[name]


def register_action(name: str, builder: Callable[[], Action]) -> None:
    _action_builders[name] = builder


def get_action(name: str) -> Action:
    """A new instance of the named action; unknown names raise KeyError
    (util.go:63-70)."""
    if name not in _action_builders:
        raise KeyError(f"unknown action {name!r} (util.go:63-70)")
    return _action_builders[name]()
