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
