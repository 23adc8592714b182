"""State carried between the JAX package and the port, as numpy arrays.

``snapshot_from_numpy`` takes a ``DeviceSnapshot`` of numpy arrays (the JAX
package's, as a NamedTuple or a mapping) and returns the port's snapshot of
tensors; ``config_from_fields`` does the same for the solve configuration,
``result_to_numpy`` brings a result back.  These are what make "both
packages compute the same thing" testable field by field.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from kube_batch_tpu_torch.api.snapshot import BITSET_FIELDS, DeviceSnapshot
from kube_batch_tpu_torch.device import resolve_device


def _as_mapping(fields: Any) -> Mapping[str, Any]:
    return fields._asdict() if hasattr(fields, "_asdict") else fields


def snapshot_from_numpy(fields, device=None) -> DeviceSnapshot:
    """The port's :class:`DeviceSnapshot` on ``device`` from numpy arrays.

    u32 bitsets travel as int32 views (bit-identical); bools stay bool and
    every other dtype is kept."""
    dev = resolve_device(device)
    src = _as_mapping(fields)
    return DeviceSnapshot(**{
        name: torch.from_numpy(host_field(name, src[name])).to(dev)
        for name in DeviceSnapshot._fields})


def host_field(name: str, value) -> np.ndarray:
    """One snapshot field as the contiguous numpy array its tensor is made
    from: u32 bitsets as int32 views, every other dtype kept."""
    arr = np.asarray(value)
    if name in BITSET_FIELDS:
        if arr.dtype not in (np.uint32, np.int32):
            raise TypeError(f"{name}: expected u32 bitsets, got {arr.dtype}")
        arr = arr.view(np.int32)
    return np.ascontiguousarray(arr)


def snapshot_to_numpy(snap: DeviceSnapshot) -> DeviceSnapshot:
    """The inverse of :func:`snapshot_from_numpy`: numpy arrays, with the
    bitsets as u32 again."""
    out = {}
    for name, t in snap._asdict().items():
        arr = t.detach().cpu().numpy()
        out[name] = arr.view(np.uint32) if name in BITSET_FIELDS else arr
    return DeviceSnapshot(**out)


def config_from_fields(fields):
    """The port's ``AllocateConfig`` from the JAX one (or a mapping of its
    fields).  ``use_pallas`` has no counterpart — the tensors' device picks
    kernel or plain version — and is dropped."""
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig
    from kube_batch_tpu_torch.ops.scoring import ScoreWeights

    src = dict(_as_mapping(fields))
    src.pop("use_pallas", None)
    weights = src.pop("weights", None)
    if weights is not None:
        src["weights"] = ScoreWeights(**dict(_as_mapping(weights)))
    return AllocateConfig(**src)


def result_to_numpy(res):
    """An ``AllocateResult`` of numpy arrays (0-d for the scalars)."""
    return type(res)(*(t.detach().cpu().numpy() for t in res))


#: byte alignment of each tensor in ``read_back``'s buffer (the widest dtype)
_PACK_ALIGN = 8


def read_back(tensors) -> list:
    """Tensors of one device as numpy arrays, in ONE blocking copy: the
    bytes of each (any dtype, 0-d included) are laid end to end in one
    uint8 buffer on its device, each at an 8-byte offset, with one
    concatenation; the buffer crosses once, and every array is a view of
    it in its tensor's shape and dtype.  Nothing is widened, so the copy
    moves each tensor's own bytes.  A ``.cpu()`` per tensor would wait on
    the device once per tensor; this is the JAX package's one
    ``device_get`` of a tuple."""
    tensors = list(tensors)
    parts, offsets, o = [], [], 0
    for t in tensors:
        b = t.detach().reshape(-1).contiguous().view(torch.uint8)
        parts.append(b)
        offsets.append(o)
        o += b.numel()
        pad = -b.numel() % _PACK_ALIGN
        if pad:
            # never read: uninitialized, so it costs no fill
            parts.append(torch.empty(pad, dtype=torch.uint8, device=b.device))
            o += pad
    flat = torch.cat(parts).cpu().numpy()
    out = []
    for t, a in zip(tensors, offsets):
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(flat[a:a + t.numel() * dtype.itemsize].view(dtype).reshape(tuple(t.shape)))
    return out
