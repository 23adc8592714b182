"""The port's lock checker for its test modules: a module fixture, not a
conftest plugin.

Every ``tests/test_torch_*.py`` module takes :func:`port_lockdep`
(``from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep``),
as it takes ``fresh_jax_caches``.  At module start it installs the port's
checker (``analysis/lockdep.py``) and the guarded-access corroborator over
``HOT_STRUCTURES``; at module end it uninstalls both and fails the module
when the module added a violation.  The acquisition graph persists across
the modules one process runs, as the JAX package's session graph does: an
inversion between an edge seen in one module and its reverse in another
still reports.

``KBT_LOCKDEP=0`` turns the fixture off, as it turns off the JAX
package's session checker.
"""

from __future__ import annotations

import os

import pytest

from kube_batch_tpu_torch.analysis import lockdep

#: the instrumented hot shared structures: (module, class, attr), their
#: domain locks resolved from the port's own tier D
HOT_STRUCTURES = lockdep.HOT_STRUCTURES

#: the process's acquisition graph and resolved specs, kept across modules
_session = {"state": None, "specs": None}


def guarded_specs():
    """``HOT_STRUCTURES`` with their tier-D domain locks (resolved once)."""
    if _session["specs"] is None:
        from kube_batch_tpu_torch.analysis import races

        _session["specs"] = races.runtime_domain_specs(HOT_STRUCTURES)
    return _session["specs"]


@pytest.fixture(scope="module", autouse=True)
def port_lockdep():
    """Run the module under the port's lock checker (module docstring)."""
    if os.environ.get("KBT_LOCKDEP", "1").lower() in ("0", "false", "no"):
        yield None
        return
    if _session["state"] is None:
        _session["state"] = lockdep.LockdepState()
    state = lockdep.install(state=_session["state"])
    guarded = lockdep.install_guarded_access(guarded_specs(), state=state)
    n0 = len(state.violations)
    try:
        yield state
    finally:
        guarded.uninstall()
        lockdep.uninstall()
    new = state.violations[n0:]
    if new:
        pytest.fail("port lockdep: this module added "
                    f"{len(new)} violation(s)\n"
                    + "\n".join(v.render() for v in new), pytrace=False)
