"""The recorder: what one call of a device program did, op by op.

A ``TorchDispatchMode`` sees every aten op the call dispatches, on any
device, with its tensor arguments and outputs.  From them it keeps what
the audits judge:

- **outputs** on the program's device type: op, dtype and shape, counted
  (KBT101's float64, KBT202's task × node planes);
- **host syncs**: every scalar read (``aten._local_scalar_dense``: each
  ``bool(t)``, ``int(t)``, ``.item()``) of a tensor on the program's
  device type; every op whose output shape depends on the data
  (``nonzero``, ``masked_select``, ``unique``, ``bincount``, indexing with a
  boolean mask), which reads a count back first; and every blocking copy
  between the host and a card;
- **transfers**: every copy whose source and destination devices differ
  (``_to_copy``, ``copy_``), every tensor made from host data on a card
  (``lift_fresh`` of a card tensor: ``torch.tensor(..., device=...)``,
  indexing with a Python list), and every op that mixes a host tensor of
  one element or more into a card op (the card copies it over first);
- **live bytes**: each new storage on the program's device type adds its
  ``nbytes`` until a weakref finalizer sees it freed, with a running
  peak; the call's inputs are charged at the start.

The kernel wrappers (``utils/seams.opaque``: K1, K2, the enqueue gate)
are one call each, as ``pallas_call`` is one equation to the JAX walk:
their outputs are charged and what their plain versions do inside on a
CPU tensor is not, so the CPU audit judges the program the card runs.
``utils/seams.round_end`` marks each bidding round's readback, so the
counts can be read per call and per round.

On the CPU no copy to or from a card exists, and ``.cpu()`` of a CPU
tensor dispatches nothing: there the syncs are the scalar reads and the
data-dependent shapes, and the only transfer a program can make is to
another device type (a planted copy to ``meta`` shows it).  On a card
every kind is seen.
"""

from __future__ import annotations

import collections
import weakref
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from kube_batch_tpu_torch.utils import seams

#: ops whose output size is data-dependent: a count read back first
DYNAMIC_SHAPE_OPS = frozenset((
    "nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive", "bincount",
))
#: indexing ops that turn a boolean mask into indices (a ``nonzero``)
_MASK_INDEX_OPS = frozenset(("index", "index_put", "index_put_", "_index_put_impl_"))
_LIFT_OPS = frozenset(("lift_fresh", "lift_fresh_copy"))
_WIDE_FLOATS = (torch.float64, torch.complex128)


class Event(NamedTuple):
    """One sync or transfer: its kind, the op, the round it fell in (the
    number of rounds ended before it), and for a copy the source and
    destination device types."""

    kind: str
    op: str
    round: int
    src: str = ""
    dst: str = ""


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors in an argument: nested tuples, lists, dicts and
    NamedTuples, and a placed snapshot's shards."""
    shards = getattr(obj, "shards", None)
    if shards is not None and not isinstance(obj, torch.Tensor):
        obj = [s for s in shards if s is not None]
    return [t for t in tree_leaves(obj) if isinstance(t, torch.Tensor)]


class Recorder(TorchDispatchMode):
    """Record one call on ``device`` (see the module docstring).  Use as a
    context manager around the call; :meth:`charge` the inputs first."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.outputs: Dict[Tuple[str, str, Tuple[int, ...]], int] = collections.Counter()
        self.syncs: List[Event] = []
        self.transfers: List[Event] = []
        self.opaque: Dict[str, int] = collections.Counter()
        self.rounds = 0
        self.live = 0
        self.peak = 0
        self.input_bytes = 0
        #: the nbytes of each storage the call allocated, in order
        self.allocations: List[int] = []
        self._storages: Dict[int, int] = {}
        self._finalizers: List[weakref.finalize] = []
        self._depth = 0
        self._open = False

    # ---- the context ----------------------------------------------------
    def __enter__(self):
        self._open = True
        seams.install(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            seams.install(None)
            self._open = False
            for f in self._finalizers:
                f.detach()
            self._finalizers.clear()

    # ---- live bytes -----------------------------------------------------
    def _on_program_device(self, t: torch.Tensor) -> bool:
        return t.device.type == self.device.type

    def _track(self, t: torch.Tensor, allocation: bool) -> None:
        if not self._on_program_device(t):
            return
        st = _storage(t)
        if st is None:
            return
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self._finalizers.append(weakref.finalize(st, self._free, key))
        self.live += n
        self.peak = max(self.peak, self.live)
        if allocation:
            self.allocations.append(n)

    def _free(self, key: int) -> None:
        n = self._storages.pop(key, 0)
        if self._open:
            self.live -= n

    def charge(self, *args) -> None:
        """Count the call's inputs as live from the start."""
        before = self.live
        for t in _tensors(args):
            self._track(t, allocation=False)
        self.input_bytes += self.live - before

    # ---- the seams ------------------------------------------------------
    def round_end(self) -> None:
        self.rounds += 1

    def opaque_call(self, name: str, fn, args, kwargs):
        self.opaque[name] += 1
        self._depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        self._note_outputs(f"{name}(kernel)", _tensors(out))
        return out

    # ---- the ops --------------------------------------------------------
    def _note_outputs(self, op: str, outs: List[torch.Tensor],
                      ins: List[torch.Tensor] = ()) -> None:
        """Count the outputs; a storage none of ``ins`` shares (a view or an
        in-place result shares its input's) is an allocation."""
        held = {id(_storage(t)) for t in ins if self._on_program_device(t)}
        for t in outs:
            if self._on_program_device(t):
                self.outputs[(op, str(t.dtype).replace("torch.", ""), tuple(t.shape))] += 1
                self._track(t, allocation=id(_storage(t)) not in held)
            elif t.dtype in _WIDE_FLOATS:
                self.outputs[(op, str(t.dtype).replace("torch.", ""), tuple(t.shape))] += 1

    def _sync(self, kind: str, op: str, src: str = "", dst: str = "") -> None:
        self.syncs.append(Event(kind, op, self.rounds, src, dst))

    def _transfer(self, op: str, src: torch.device, dst: torch.device, blocking: bool) -> None:
        kind = ("device_to_host" if dst.type == "cpu" else
                "host_to_device" if src.type == "cpu" else "device_to_device")
        self.transfers.append(Event(kind, op, self.rounds, src.type, dst.type))
        if blocking and {src.type, dst.type} == {"cpu", "cuda"}:
            self._sync(kind, op, src.type, dst.type)

    def _classify(self, packet: str, op: str, args, kwargs, ins: List[torch.Tensor]) -> None:
        if packet == "_local_scalar_dense":
            if self._on_program_device(ins[0]):
                self._sync("scalar_read", op)
            return
        if packet in DYNAMIC_SHAPE_OPS or (
                packet == "repeat_interleave" and kwargs.get("output_size") is None):
            if any(self._on_program_device(t) for t in ins):
                self._sync("dynamic_shape", op)
            return
        if packet in _MASK_INDEX_OPS:
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                   for i in idx) and self._on_program_device(ins[0]):
                self._sync("dynamic_shape", op)
        if packet == "_to_copy":
            src = ins[0].device
            dst = torch.device(kwargs.get("device") or src)
            if not _same_device(src, dst):
                self._transfer(op, src, dst, not kwargs.get("non_blocking", False))
            return
        if packet == "copy_":
            dst, src = args[0].device, args[1].device
            non_blocking = args[2] if len(args) > 2 else kwargs.get("non_blocking", False)
            if not _same_device(src, dst):
                self._transfer(op, src, dst, not non_blocking)
            return
        if packet in _LIFT_OPS:
            if ins[0].device.type != "cpu":
                self._transfer(op, torch.device("cpu"), ins[0].device, True)
            return
        # a host tensor of one element or more in a card op is copied over
        # first, blocking (a 0-d host tensor is read as a scalar)
        if any(t.device.type == "cuda" for t in ins):
            for t in ins:
                if t.device.type == "cpu" and t.dim() > 0:
                    self._transfer(op, t.device, next(u.device for u in ins
                                                      if u.device.type == "cuda"), True)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._depth:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = str(func.overloadpacket.__name__)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if ins:
            self._classify(packet, str(func), args, kwargs, ins)
        self._note_outputs(packet, [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)],
                           ins)
        return out

    # ---- reading --------------------------------------------------------
    def wide_floats(self) -> List[str]:
        return sorted({op for (op, dt, _s) in self.outputs if dt in ("float64", "complex128")})
