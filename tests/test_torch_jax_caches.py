"""The JAX package's compiled executables, cleared around every port test
module that uses the JAX package.

Each executable XLA compiles on the CPU keeps memory maps, and an xdist
worker keeps every module's executables until it exits: a worker whose
files compile enough passes the kernel's map limit (65 530), and the next
compile fails or crashes the worker (a JAX-package test in
``tests/test_warm.py`` failed and a worker died this way with 65 099 maps).
So every port test module that imports ``jax`` or the JAX package takes
:func:`fresh_jax_caches` (``from test_torch_jax_caches import
fresh_jax_caches``, or a fixture of its own by that name), which clears the
caches before and after the module."""

from __future__ import annotations

import ast
import gc
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
from kube_batch_tpu_torch.analysis.pytest_plugin import port_lockdep  # noqa: F401 — runs the module under the port's lock checker

TESTS = Path(__file__).resolve().parent


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """Clear the JAX package's compiled executables before and after the
    module (module docstring)."""
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()


def _uses_jax(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        else:
            continue
        if any(n.split(".")[0] in ("jax", "jaxlib", "kube_batch_tpu") for n in names):
            return True
    return False


def test_every_jax_using_port_module_clears_the_jax_caches():
    missing = []
    for path in sorted(TESTS.glob("test_torch_*.py")):
        source = path.read_text()
        if _uses_jax(ast.parse(source)) and "fresh_jax_caches" not in source:
            missing.append(path.name)
    assert missing == []


def _maps() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


def test_clearing_the_caches_gives_the_maps_back():
    """Compiled executables hold memory maps until the caches let them go."""
    before = _maps()
    for k in range(40):
        jax.jit(lambda x, k=k: jnp.sin(x) * k + jnp.cos(x))(jnp.ones(k + 1)).block_until_ready()
    grown = _maps()
    jax.clear_caches()
    gc.collect()
    assert grown > before and _maps() < grown
