"""The cluster's fixed resource axis and the host ``Resource`` arithmetic.

Mirrors ``kube_batch_tpu/api/resources.py`` (the reference's
resource_info.go): a resource amount is a dense float64 vector over a
cluster-wide ``ResourceSpec`` axis (cpu in milli-cores, memory in bytes,
pods, then scalars in milli units), compared with the reference's
epsilon-tolerant ``LessEqual`` (resource_info.go:66-72, 269-284).  Only
the numpy path is ported; the JAX package's optional C fast path has the
same semantics.

"pods" is an ordinary dimension with a per-task request of 1, so the
max-pods predicate falls out of the resource fit; it is capacity-only and
every semantic comparison (Less / IsEmpty / Share) masks it out
(``PODS_INDEX``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from kube_batch_tpu_torch.utils.assertions import graft_assert

_F64 = np.dtype(np.float64)

MIN_MILLI_CPU = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024  # 10 MiB
MIN_MILLI_SCALAR = 10.0
MIN_PODS = 0.1  # pods are integral; anything below one pod is "empty"

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
GPU = "nvidia.com/gpu"

#: the one capacity-only dimension, excluded from fairness comparisons
PODS_INDEX = 2


class ResourceSpec:
    """The resource axis shared by every [., R] array of one cluster."""

    def __init__(self, scalar_names: Sequence[str] = (GPU,)):
        names = [CPU, MEMORY, PODS]
        for s in scalar_names:
            if s in names:
                raise ValueError(f"duplicate resource name {s!r}")
            names.append(s)
        self.names: Tuple[str, ...] = tuple(names)
        self._index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}
        quanta = [MIN_MILLI_CPU, MIN_MEMORY, MIN_PODS]
        quanta += [MIN_MILLI_SCALAR] * len(scalar_names)
        self.quanta: np.ndarray = np.asarray(quanta, dtype=np.float64)
        self.semantic_mask: np.ndarray = np.ones(len(names), dtype=bool)
        self.semantic_mask[PODS_INDEX] = False

    @property
    def n(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        return self._index[name]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __eq__(self, other) -> bool:
        return isinstance(other, ResourceSpec) and self.names == other.names

    def __hash__(self) -> int:
        return hash(self.names)

    def __repr__(self) -> str:
        return f"ResourceSpec({self.names})"

    # -- constructors -----------------------------------------------------
    def empty(self) -> "Resource":
        return _raw_resource(np.zeros(self.n), self)

    def from_vec(self, vec: np.ndarray) -> "Resource":
        return Resource(np.asarray(vec, dtype=np.float64).copy(), self)

    def wrap_vec(self, vec: np.ndarray) -> "Resource":
        """A Resource over ``vec`` without copying — for rows the caller owns
        (segment sums, ledger matrix rows)."""
        if vec.dtype == _F64 and vec.flags.c_contiguous:
            return _raw_resource(vec, self)
        return Resource(vec, self)


def _raw_resource(vec: np.ndarray, spec: ResourceSpec) -> "Resource":
    """A Resource over an already-contiguous float64 buffer, skipping the
    setter's normalisation."""
    r = Resource.__new__(Resource)
    r._vec = vec
    r.spec = spec
    return r


DEFAULT_SPEC = ResourceSpec()


class Resource:
    """A point on the resource axis; arithmetic mirrors resource_info.go.

    Operators return new Resources; the in-place mutators (``add_``,
    ``sub_``, ``set_max_``) are used only by the ledger algebra of
    ``NodeInfo``/``JobInfo``.  A ledger Resource may be a view of a
    ``ColumnStore`` matrix row, so in-place writes go to the column."""

    __slots__ = ("_vec", "spec")

    def __init__(self, vec: np.ndarray, spec: ResourceSpec):
        self.vec = vec
        self.spec = spec

    @property
    def vec(self) -> np.ndarray:
        return self._vec

    @vec.setter
    def vec(self, value) -> None:
        self._vec = np.ascontiguousarray(value, dtype=np.float64)

    @property
    def pods(self) -> float:
        return float(self._vec[PODS_INDEX])

    def clone(self) -> "Resource":
        return _raw_resource(self._vec.copy(), self.spec)

    # -- predicates (resource_info.go:134-160) ----------------------------
    def is_empty(self) -> bool:
        """Every semantic dimension below its quantum."""
        m = self.spec.semantic_mask
        return bool(np.all(self._vec[m] < self.spec.quanta[m]))

    # -- arithmetic -------------------------------------------------------
    def _check(self, other: "Resource") -> None:
        if self.spec is not other.spec:
            graft_assert(self.spec == other.spec, "resource spec mismatch")

    def add(self, other: "Resource") -> "Resource":
        self._check(other)
        return Resource(self._vec + other._vec, self.spec)

    def add_(self, other: "Resource") -> "Resource":
        self._check(other)
        np.add(self._vec, other._vec, out=self._vec)
        return self

    def sub(self, other: "Resource") -> "Resource":
        """Subtract, asserting no dimension underflows
        (resource_info.go:180-190)."""
        return self.clone().sub_(other)

    def sub_(self, other: "Resource") -> "Resource":
        self._check(other)
        if not other.less_equal(self):
            graft_assert(False, f"resource underflow: {other} not <= {self}")
        np.subtract(self._vec, other._vec, out=self._vec)
        np.maximum(self._vec, 0.0, out=self._vec)
        return self

    def multi(self, ratio: float) -> "Resource":
        """Every dimension scaled by ``ratio`` (resource_info.go:193-202)."""
        return Resource(self._vec * ratio, self.spec)

    def set_max_(self, other: "Resource") -> "Resource":
        """Elementwise max in place (resource_info.go:205-221)."""
        self._check(other)
        np.maximum(self._vec, other._vec, out=self._vec)
        return self

    def fit_delta(self, other: "Resource") -> "Resource":
        """Per-dimension shortfall of self (request) against other (idle):
        request − idle + quantum where the request does not fit
        (resource_info.go:224-250 FitDelta)."""
        self._check(other)
        short = np.where(
            (self._vec > 0) & (self._vec > other._vec),
            self._vec - other._vec + self.spec.quanta,
            0.0,
        )
        return Resource(short, self.spec)

    # -- comparisons (epsilon-tolerant, resource_info.go:253-297) ---------
    def less_equal(self, other: "Resource") -> bool:
        """<= in every dimension, tolerating sub-quantum excess."""
        self._check(other)
        return bool(np.all((self._vec <= other._vec)
                           | (self._vec - other._vec < self.spec.quanta)))

    def less_equal_semantic(self, other: "Resource") -> bool:
        """LessEqual over cpu/memory/scalars only (no pods)."""
        self._check(other)
        m = self.spec.semantic_mask
        d, o = self._vec[m], other._vec[m]
        return bool(np.all((d <= o) | (d - o < self.spec.quanta[m])))

    def share(self, total: "Resource") -> float:
        """Dominant share: max over semantic dimensions of self/total,
        ignoring empty totals (helpers.go:28-60 GetShare)."""
        self._check(total)
        m = self.spec.semantic_mask
        with np.errstate(divide="ignore", invalid="ignore"):
            ratios = np.where(total._vec[m] > 0,
                              self._vec[m] / total._vec[m], 0.0)
        return float(np.max(ratios)) if ratios.size else 0.0

    def __eq__(self, other) -> bool:
        return (isinstance(other, Resource) and self.spec == other.spec
                and bool(np.all(np.abs(self._vec - other._vec) < 1e-9)))

    def __hash__(self):
        raise TypeError("Resource is not hashable")

    def __repr__(self) -> str:
        parts = [f"{n}={self._vec[i]:g}" for i, n in enumerate(self.spec.names)
                 if self._vec[i] != 0]
        return f"Resource({', '.join(parts) or 'empty'})"
