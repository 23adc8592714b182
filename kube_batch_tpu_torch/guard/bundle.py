"""Guard diagnostics bundles — self-contained captures of a condemned solve
for offline fast-against-oracle triage.

Mirrors ``kube_batch_tpu/guard/bundle.py``, in the same layout:
``<dir>/meta.json`` (config, knobs, violation report, invariant names) and
``<dir>/arrays.npz`` (every DeviceSnapshot field as the JAX package keeps
it — bitsets as u32 — plus ``pend_rows`` when the compacted path ran).
On a trip the dispatching action dumps the exact device snapshot the
solve consumed (read back here, on the trip path only: a corrupted
resident word is captured corrupted).  The bundle is built in a temporary
sibling directory and renamed into place, so a crash mid-dump leaves no
half bundle.  :func:`replay_bundle` re-runs the condemned program and its
oracle on the device the caller names.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger("kube_batch_tpu_torch")

_KNOBS = (
    "KB_TOPK", "KB_WARM", "KB_GUARD", "KB_AUDIT_EVERY", "KB_GUARD_COOLDOWN",
    "KB_DEVICE_CACHE", "KB_SNAPSHOT_DELTA", "KB_DELTA_CLOSE",
)


def bundle_dir() -> str:
    return os.environ.get("KB_GUARD_DIR", "").strip() or "guard-bundles"


def _config_dict(config) -> Dict:
    d = config._asdict()
    w = d.pop("weights", None)
    if w is not None:
        wd = w._asdict()
        extra = wd.pop("extra_rows", ()) or ()
        wd["extra_row_names"] = [name for (name, _fn, _w) in extra]
        d["weights"] = wd
    return d


def dump_bundle(action: str, snap, config, report: Dict,
                pend_rows: Optional[np.ndarray] = None,
                directory: Optional[str] = None) -> str:
    """Write one bundle and return its path.  ``snap`` is the DeviceSnapshot
    the condemned solve consumed (tensors on any device)."""
    from kube_batch_tpu_torch.api.convert import snapshot_to_numpy
    from kube_batch_tpu_torch.ops.invariants import INVARIANT_NAMES

    root = directory or bundle_dir()
    os.makedirs(root, exist_ok=True)
    if hasattr(snap, "gathered"):
        snap = snap.gathered()  # a ShardedSnapshot: the whole snapshot
    host = snapshot_to_numpy(snap)
    arrays = {f: np.asarray(getattr(host, f)) for f in host._fields}
    if pend_rows is not None:
        arrays["pend_rows"] = np.asarray(pend_rows)
    meta = {
        "schema": 1,
        "action": action,
        "config": _config_dict(config),
        "config_kind": type(config).__name__,
        "report": report,
        "invariant_names": list(INVARIANT_NAMES),
        "knobs": {k: os.environ.get(k, "") for k in _KNOBS},
        "has_pend_rows": pend_rows is not None,
    }
    tmp = tempfile.mkdtemp(dir=root, prefix=".tmp-bundle-")
    try:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        serial = 0
        while True:
            final = os.path.join(root, f"trip-{action}-{serial:04d}")
            if not os.path.exists(final):
                try:
                    os.replace(tmp, final)
                    break
                except OSError:
                    pass  # lost the race to a concurrent dump: next serial
            serial += 1
            if serial > 9999:
                raise OSError("guard bundle directory full")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    logger.warning("guard diagnostics bundle written: %s", final)
    return final


def load_bundle(path: str):
    """(DeviceSnapshot of numpy arrays, meta dict, pend_rows or None)."""
    from kube_batch_tpu_torch.api.snapshot import DeviceSnapshot

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    pend_rows = arrays.pop("pend_rows", None)
    snap = DeviceSnapshot(**{f: arrays[f] for f in DeviceSnapshot._fields})
    return snap, meta, pend_rows


def _rebuild_config(meta: Dict):
    """(config, names of dropped custom score rows) from a bundle's meta;
    a JAX package bundle's ``use_pallas`` has no counterpart and is
    dropped."""
    from kube_batch_tpu_torch.ops.assignment import AllocateConfig
    from kube_batch_tpu_torch.ops.eviction import EvictConfig
    from kube_batch_tpu_torch.ops.scoring import ScoreWeights

    d = dict(meta["config"])
    d.pop("use_pallas", None)
    w = d.pop("weights", None)
    dropped = []
    if w is not None:
        w = dict(w)
        dropped = w.pop("extra_row_names", [])
        d["weights"] = ScoreWeights(**w)
    cls = AllocateConfig if meta["config_kind"] == "AllocateConfig" else EvictConfig
    return cls(**d), dropped


def replay_bundle(path: str, device=None) -> Dict:
    """Re-run a bundle's condemned program and its oracle, sentinel
    checked both ways, on the captured snapshot on ``device`` (None: CUDA).
    Returns a JSON-shaped report; ``reproduced`` is True when the replay
    re-derives an integrity failure (a nonzero verdict of the fast
    program, a fast-against-oracle mismatch, or a device checksum that
    differs from the host's recorded one)."""
    import torch

    from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
    from kube_batch_tpu_torch.ops.invariants import (
        INVARIANT_NAMES,
        allocate_sentinel_solve,
        allocate_topk_sentinel_solve,
        eligibility_checksum,
        evict_sentinel_solve,
    )

    snap_host, meta, pend_rows = load_bundle(path)
    config, dropped_rows = _rebuild_config(meta)
    snap = snapshot_from_numpy(snap_host, device)
    out: Dict = {"bundle": path, "action": meta["action"],
                 "original_report": meta["report"],
                 "weights_extra_rows_dropped": dropped_rows,
                 "device": str(snap.task_req.device)}
    host_ck = meta["report"].get("host_checksum")
    ck_mismatch = False
    if host_ck is not None:
        dev_ck = int(eligibility_checksum(snap)) & 0xFFFFFFFF
        ck_mismatch = dev_ck != (int(host_ck) & 0xFFFFFFFF)
        out["host_checksum_mismatch"] = ck_mismatch

    def _hist(h):
        return {name: int(c) for name, c in zip(INVARIANT_NAMES, h.tolist()) if c}

    if meta["config_kind"] == "EvictConfig":
        res, _rounds, v, h, _e = evict_sentinel_solve(snap, config)
        out.update(fast_verdict=int(v), fast_violations=_hist(h.cpu()),
                   claims=int((res.claim_node >= 0).sum()),
                   victims=int(res.evicted.sum()),
                   reproduced=bool(int(v) != 0 or ck_mismatch))
        return out

    if pend_rows is not None and config.topk > 0:
        rows = torch.from_numpy(np.asarray(pend_rows, np.int32)).to(snap.task_req.device)
        fast, fv, fh, _e = allocate_topk_sentinel_solve(snap, rows, config)
        fast_name = f"topk[K={config.topk}]"
    else:
        fast, fv, fh, _e = allocate_sentinel_solve(snap, config)
        fast_name = "full"
    orc, ov, oh, _oe = allocate_sentinel_solve(snap, config._replace(topk=0))
    mismatch_rows = torch.nonzero((fast.assigned != orc.assigned)
                                  | (fast.pipelined != orc.pipelined)).flatten().cpu()
    out.update(
        fast_program=fast_name,
        fast_verdict=int(fv), fast_violations=_hist(fh.cpu()),
        oracle_verdict=int(ov), oracle_violations=_hist(oh.cpu()),
        oracle_placed=int((orc.assigned >= 0).sum()),
        fast_vs_oracle_mismatch_rows=mismatch_rows[:64].tolist(),
        fast_vs_oracle_mismatches=int(mismatch_rows.numel()),
        reproduced=bool(int(fv) != 0 or mismatch_rows.numel() or ck_mismatch),
    )
    return out
