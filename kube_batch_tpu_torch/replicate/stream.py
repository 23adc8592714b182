"""KBR1: the replication stream's wire format.

Mirrors ``kube_batch_tpu/replicate/stream.py``; the frames are the
contract between the two packages, so for the same record both write the
same bytes, and each decodes the other's.  One frame per record:

    b"KBR1" | u32 header length (big-endian) | UTF-8 JSON header | payload

The header carries the record's identity (seq, version, the chain's
predecessor, the leader's head when it was sent), the decode tables
(``SnapshotMeta``'s name lists and bit maps: whole in a ``full`` record,
a patch in a ``delta``), the lease's extras a follower needs to rebuild
its ``SnapshotLease`` (configs, probe rows, queue rows, unmodeled gates,
the resource axis's scalar names) and a directory of the payload's
arrays: name, dtype, shape, byte offset and size.

A field arrives whole (``f:<field>``) or as a row scatter
(``d:<field>:rows`` int32 and ``d:<field>:vals``); a clean field is
absent.  Record kinds: ``full`` (every field whole: the first record, and
what a follower whose ``since`` fell off the ring gets), ``delta`` (the
changed rows only; ``prev_seq`` / ``prev_version`` name the state it
applies to) and ``heartbeat`` (no payload; the leader's head, so an idle
follower still reports fresh staleness).

Configurations cross as tagged dicts through a closed registry
(``AllocateConfig``, ``EvictConfig``, ``ScoreWeights``).  The JAX
package's ``AllocateConfig`` has a ``use_pallas`` field the port's does
not (the tensors' device picks kernel or plain version): the port writes
it as ``false`` in its JAX place, as the JAX leader always does, and drops
it on read.  ``ScoreWeights.extra_rows`` holds host callables and is
emptied by the publisher before encode.  Framing is numpy and json only:
the frame is a wire format, not a device program.
"""

from __future__ import annotations

import itertools
import json
import operator
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

MAGIC = b"KBR1"

#: record kinds (the header's ``kind``)
FULL, DELTA, HEARTBEAT = "full", "delta", "heartbeat"


class ReplicationRecord(NamedTuple):
    """One decoded frame: the publisher builds these, the follower
    applies them."""

    kind: str           # "full" | "delta" | "heartbeat"
    seq: int            # this record's sequence number
    version: int        # the dirty tracker's version token at this record
    prev_seq: int       # the chain's predecessor (-1 for full / heartbeat)
    prev_version: int
    head_seq: int       # the leader's head when sent (staleness)
    head_version: int
    full: Dict[str, np.ndarray]                       # field → whole array
    delta: Dict[str, Tuple[np.ndarray, np.ndarray]]   # field → (rows, vals)
    meta: dict          # decode tables (full) or their patch (delta)
    lease: dict         # configs, probe rows, queue rows, gates, scalar names


# ---- configuration wire ----------------------------------------------------

#: fields of the JAX package's wire that the port's configurations lack:
#: type name → ((field, the value written, the field it follows), ...)
WIRE_ONLY_FIELDS = {"AllocateConfig": (("use_pallas", False, "proportion"),)}


def _config_registry():
    """The closed set of configuration types that may cross the wire."""
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig
    from kube_batch_tpu_torch.ops.eviction import EvictConfig
    from kube_batch_tpu_torch.ops.scoring import ScoreWeights

    return {t.__name__: t for t in (AllocateConfig, EvictConfig, ScoreWeights)}


def config_to_wire(cfg):
    """The tagged dict of a registered configuration (recursing into nested
    members), fields in the JAX package's order; scalars pass through."""
    reg = _config_registry()
    name = type(cfg).__name__
    if name in reg and isinstance(cfg, tuple):
        extra = WIRE_ONLY_FIELDS.get(name, ())
        fields = {}
        for field, val in zip(cfg._fields, cfg):
            fields[field] = config_to_wire(val)
            for wire_field, wire_val, after in extra:
                if after == field:
                    fields[wire_field] = wire_val
        return {"__cfg__": name, "fields": fields}
    if isinstance(cfg, tuple):
        return {"__tuple__": [config_to_wire(v) for v in cfg]}
    if isinstance(cfg, (bool, int, float, str)) or cfg is None:
        return cfg
    raise TypeError(f"config value {cfg!r} is not wire-serializable")


def config_from_wire(obj):
    """The inverse of :func:`config_to_wire`; the JAX-only fields are
    dropped."""
    if isinstance(obj, dict) and "__cfg__" in obj:
        name = obj["__cfg__"]
        cls = _config_registry()[name]
        drop = {f for f, _v, _a in WIRE_ONLY_FIELDS.get(name, ())}
        kwargs = {k: config_from_wire(v) for k, v in obj["fields"].items()
                  if k not in drop}
        return cls(**kwargs)
    if isinstance(obj, dict) and "__tuple__" in obj:
        return tuple(config_from_wire(v) for v in obj["__tuple__"])
    return obj


# ---- frame encode / decode -------------------------------------------------

def encode_record(rec: ReplicationRecord) -> bytes:
    """One KBR1 frame for ``rec``."""
    arrays: List[dict] = []
    buffers: List[bytes] = []
    offset = 0

    def add(name: str, arr: np.ndarray) -> None:
        nonlocal offset
        a = np.ascontiguousarray(arr)
        buf = a.tobytes()
        arrays.append({"name": name, "dtype": a.dtype.str,
                       "shape": list(a.shape), "offset": offset,
                       "nbytes": len(buf)})
        buffers.append(buf)
        offset += len(buf)

    for field in sorted(rec.full):
        add(f"f:{field}", rec.full[field])
    for field in sorted(rec.delta):
        rows, vals = rec.delta[field]
        add(f"d:{field}:rows", np.asarray(rows, np.int32))
        add(f"d:{field}:vals", vals)

    header = {
        "kind": rec.kind, "seq": rec.seq, "version": rec.version,
        "prev_seq": rec.prev_seq, "prev_version": rec.prev_version,
        "head_seq": rec.head_seq, "head_version": rec.head_version,
        "meta": rec.meta, "lease": rec.lease, "arrays": arrays,
    }
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    return b"".join([MAGIC, len(hbytes).to_bytes(4, "big"), hbytes, *buffers])


def decode_record(buf: bytes) -> ReplicationRecord:
    """Parse one KBR1 frame.  The arrays are fresh writable copies: the
    follower scatters in place into the whole fields it adopted, so views
    of the network buffer would be a trap."""
    if len(buf) < 8 or buf[:4] != MAGIC:
        raise ValueError("not a KBR1 replication frame")
    hlen = int.from_bytes(buf[4:8], "big")
    if len(buf) < 8 + hlen:
        raise ValueError("truncated KBR1 header")
    header = json.loads(buf[8:8 + hlen].decode())
    payload = buf[8 + hlen:]

    decoded: Dict[str, np.ndarray] = {}
    for ent in header["arrays"]:
        start, n = ent["offset"], ent["nbytes"]
        if start + n > len(payload):
            raise ValueError(f"truncated KBR1 payload at {ent['name']}")
        arr = np.frombuffer(payload[start:start + n], dtype=np.dtype(ent["dtype"]))
        decoded[ent["name"]] = arr.reshape(ent["shape"]).copy()

    full: Dict[str, np.ndarray] = {}
    delta: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for name, arr in decoded.items():
        if name.startswith("f:"):
            full[name[2:]] = arr
        elif name.startswith("d:") and name.endswith(":rows"):
            field = name[2:-5]
            delta[field] = (arr, decoded[f"d:{field}:vals"])

    return ReplicationRecord(
        kind=header["kind"], seq=header["seq"], version=header["version"],
        prev_seq=header["prev_seq"], prev_version=header["prev_version"],
        head_seq=header["head_seq"], head_version=header["head_version"],
        full=full, delta=delta, meta=header["meta"], lease=header["lease"],
    )


# ---- meta tables -----------------------------------------------------------

_NAME_LISTS = ("task_keys", "node_names", "job_uids", "queue_names")


def meta_tables(meta) -> dict:
    """``SnapshotMeta`` → the JSON-clean decode tables a follower rebuilds
    it from (no object references, no host caches).  New lists and maps:
    several of ``meta``'s are the column store's live ones."""
    return {
        "task_keys": list(meta.task_keys),
        "node_names": list(meta.node_names),
        "job_uids": list(meta.job_uids),
        "queue_names": list(meta.queue_names),
        "label_pair_bit": [[k, v, b] for (k, v), b in sorted(meta.label_pair_bit.items())],
        "taint_bit": [[k, v, e, b] for (k, v, e), b in sorted(meta.taint_bit.items())],
        "counts": [meta.n_tasks, meta.n_nodes, meta.n_jobs, meta.n_queues],
    }


def meta_patch(prev: dict, cur: dict) -> dict:
    """A delta record's table patch from ``prev`` to ``cur``: each name
    list ships its changed entries and its new length; a bit map ships
    whole whenever it changed (a bit reused after a churn-out would
    otherwise decode selectors wrongly, and the maps are small)."""
    patch: dict = {"counts": cur["counts"]}
    for key in _NAME_LISTS:
        p, c = prev[key], cur[key]
        # the entry-by-entry compare runs in C (map, compress): at 57 344
        # task keys a Python loop costs the encode worker ~15 ms a record
        rows = itertools.compress(itertools.count(), map(operator.ne, p, c))
        changed = {str(i): c[i] for i in rows}
        changed.update((str(i), c[i]) for i in range(len(p), len(c)))
        patch[key] = {"len": len(c), "set": changed}
    for key in ("label_pair_bit", "taint_bit"):
        if prev[key] != cur[key]:
            patch[key] = cur[key]
    return patch


def apply_meta_patch(tables: dict, patch: dict) -> dict:
    """A follower's tables after a :func:`meta_patch`."""
    out = dict(tables)
    out["counts"] = patch["counts"]
    for key in _NAME_LISTS:
        ent = patch[key]
        lst = list(out[key])[:ent["len"]]
        lst.extend([""] * (ent["len"] - len(lst)))
        for i, v in ent["set"].items():
            lst[int(i)] = v
        out[key] = lst
    for key in ("label_pair_bit", "taint_bit"):
        if key in patch:
            out[key] = patch[key]
    return out


def build_snapshot_meta(tables: dict, spec):
    """A follower's ``SnapshotMeta`` from the wire tables: the decode tables
    only.  The host objects (``task_objs``, ``job_objs``, ``node_objs``),
    the 64-bit shadows and ``live_nodes`` stay empty; the probe and its
    decode read none of them."""
    from kube_batch_tpu_torch.api.snapshot import SnapshotMeta

    n_tasks, n_nodes, n_jobs, n_queues = tables["counts"]
    return SnapshotMeta(
        spec=spec,
        task_keys=list(tables["task_keys"]),
        node_names=list(tables["node_names"]),
        job_uids=list(tables["job_uids"]),
        queue_names=list(tables["queue_names"]),
        label_pair_bit={(k, v): b for k, v, b in tables["label_pair_bit"]},
        taint_bit={(k, v, e): b for k, v, e, b in tables["taint_bit"]},
        n_tasks=n_tasks, n_nodes=n_nodes, n_jobs=n_jobs, n_queues=n_queues,
    )
