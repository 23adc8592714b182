"""The repo's two TPU kernels, written by hand in CUDA for Hopper, and the
launch bookkeeping every kernel wrapper of the port shares.

Both replace Pallas kernels of ``kube_batch_tpu/ops/pallas_kernels.py``:

  K1 ``masked_best_node_raw`` (csrc/best_node.cu) — the fused round head:
     per task row, the feasible-masked two-key argmax over nodes;
  K2 ``masked_topk_blocks`` (csrc/topk_blocks.cu) — the fused
     candidate-table build: the masked sort-key plane plus per-64-column
     winner triples.

Each wrapper takes its plain PyTorch version (``*_plain``, beside it) for a
tensor on the CPU, and only then; for a CUDA tensor it launches the kernel
or raises.  Each launch adds one to ``launches[name]`` (the enqueue gate,
``ops/admission.py``, counts here too).  Each wrapper is
``utils/seams.opaque``: the device-program audit records it as one call.
The tie hash and the f32 sort key live here, where both the kernels' plain
versions and the solve (``ops/assignment.py``) read them.
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.ops.feasibility import fits
from kube_batch_tpu_torch.utils.seams import opaque

NEG = -3.0e38
#: node-block width of K2's winner triples (the JAX package's TOPK_BLOCK)
TOPK_BLOCK = 64
#: widest resource axis the kernels keep in registers (csrc MAX_R)
MAX_R = 8

# the multiplicative hash constants as wrapped int32 (two's complement)
_H1 = 0x9E3779B1 - (1 << 32)
_H2 = 0x85EBCA77 - (1 << 32)
_H3 = 0xCA87C3EB - (1 << 32)

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"masked_best_node_raw": 0, "masked_topk_blocks": 0,
            "enqueue_gate": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def tie_break_hash_rows(ti: torch.Tensor, ni: torch.Tensor) -> torch.Tensor:
    """[len(ti), len(ni)] i32 per-(task, node) hash in [0, 65535] at GLOBAL
    indices.  int32 multiplies wrap as the JAX package's do; torch's ``>>``
    on int32 is arithmetic, so each shift is masked to make it logical."""
    ti = ti.to(torch.int32)
    ni = ni.to(torch.int32)
    h = ti[:, None] * _H1 + ni[None, :] * _H2
    h = (h ^ ((h >> 15) & 0x1FFFF)) * _H3
    return (h >> 16) & 0xFFFF


def f32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 → i32 map: integer compare of the keys equals
    float compare of the values.  ``x + 0.0`` canonicalises -0.0 first."""
    b = (x + 0.0).view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _tie_break_hash(T: int, N: int, t0: int = 0, n0: int = 0,
                    device=None) -> torch.Tensor:
    """[T, N] i32 tie hash of a block at global origin (t0, n0)."""
    return tie_break_hash_rows(
        torch.arange(T, dtype=torch.int32, device=device) + t0,
        torch.arange(N, dtype=torch.int32, device=device) + n0,
    )


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def masked_best_node_raw_plain(score, static_ok, task_req, idle, releasing,
                               pending, quanta, t0: int = 0, n0: int = 0,
                               rows=None):
    """K1 in tensor ops: (best [T] i32, val [T] f32, hash [T] f32,
    chose_idle [T] bool).  ``rows`` [T] i32, when given, are the global task
    rows the tie hash is taken at (in place of ``t0 + arange(T)``)."""
    T, N = score.shape
    fit_idle = fits(task_req, idle, quanta)
    feas = static_ok & pending[:, None] & (fit_idle | fits(task_req, releasing, quanta))
    masked = torch.where(feas, score, NEG)
    val = masked.amax(dim=1)
    if rows is None:
        rows = torch.arange(T, dtype=torch.int32, device=score.device) + t0
    hashes = tie_break_hash_rows(
        rows, torch.arange(N, dtype=torch.int32, device=score.device) + n0)
    hm = torch.where(masked >= val[:, None], hashes, -1)
    best = hm.argmax(dim=1)  # first index among full ties
    chose = fit_idle.gather(1, best[:, None])[:, 0]
    return (best.to(torch.int32), val, hm.amax(dim=1).to(torch.float32),
            chose)


def masked_topk_blocks_plain(score_static, task_req, idle, releasing, rows,
                             quanta, n0: int = 0):
    """K2 in tensor ops: (skey [P, N] i32, bval/bhash/bcol [P, N // 64]
    i32).  A trailing partial node block has keys but no triple."""
    P, N = score_static.shape
    feas = fits(task_req, idle, quanta) | fits(task_req, releasing, quanta)
    skey = f32_sort_key(torch.where(feas, score_static, NEG))
    NB = N // TOPK_BLOCK
    cols = torch.arange(N, dtype=torch.int32, device=score_static.device) + n0
    hashes = tie_break_hash_rows(rows, cols)
    s3 = skey[:, :NB * TOPK_BLOCK].reshape(P, NB, TOPK_BLOCK)
    h3 = hashes[:, :NB * TOPK_BLOCK].reshape(P, NB, TOPK_BLOCK)
    bval = s3.amax(dim=-1)
    hm = torch.where(s3 >= bval[..., None], h3, -2)
    return (skey, bval, hm.amax(dim=-1),
            hm.argmax(dim=-1).to(torch.int32))


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _kernel_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.kbt_error_string(rc).decode()} ({rc})"
        )


@opaque
def masked_best_node_raw(score, static_ok, task_req, idle, releasing,
                         pending, quanta, t0: int = 0, n0: int = 0, rows=None):
    """K1, the fused round head: (best [T] i32, val [T] f32, hash [T] f32,
    chose_idle [T] bool) over a [T, N] block whose global origin is
    (``t0``, ``n0``); ``best`` is block-local.  ``rows`` [T] i32, when
    given, are the global task rows of the block's rows for the tie hash
    (the what-if probe's, which need not be contiguous); ``t0`` is then
    unused.  See csrc/best_node.cu."""
    if not _kernel_device(score):
        return masked_best_node_raw_plain(score, static_ok, task_req, idle,
                                          releasing, pending, quanta, t0, n0,
                                          rows)
    from kube_batch_tpu_torch.ops._build import load_library

    dev = score.device
    T, N = score.shape
    R = task_req.shape[1]
    if N == 0 or not 0 < R <= MAX_R:
        raise ValueError(f"masked_best_node_raw: N={N}, R={R} (1..{MAX_R})")
    f32 = torch.float32
    _check("score", score, f32, (T, N), dev)
    _check("static_ok", static_ok, torch.bool, (T, N), dev)
    _check("task_req", task_req, f32, (T, R), dev)
    _check("idle", idle, f32, (N, R), dev)
    _check("releasing", releasing, f32, (N, R), dev)
    _check("pending", pending, torch.bool, (T,), dev)
    _check("quanta", quanta, f32, (R,), dev)
    if rows is not None:
        _check("rows", rows, torch.int32, (T,), dev)
    best = torch.empty(T, dtype=torch.int32, device=dev)
    val = torch.empty(T, dtype=f32, device=dev)
    hsh = torch.empty(T, dtype=f32, device=dev)
    chose = torch.empty(T, dtype=torch.bool, device=dev)
    if T == 0:
        return best, val, hsh, chose
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.kbt_masked_best_node(
            score.data_ptr(), static_ok.data_ptr(), task_req.data_ptr(),
            idle.data_ptr(), releasing.data_ptr(), pending.data_ptr(),
            quanta.data_ptr(), None if rows is None else rows.data_ptr(),
            # kbt: allow[KBT005] t0 and n0 are Python ints (the block
            # origin); int() types them for ctypes, no tensor is read
            T, N, R, int(t0), int(n0), best.data_ptr(),
            val.data_ptr(), hsh.data_ptr(), chose.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, rc, "masked_best_node_raw")
    launches["masked_best_node_raw"] += 1
    return best, val, hsh, chose


@opaque
def masked_topk_blocks(score_static, task_req, idle, releasing, rows,
                       quanta, n0: int = 0):
    """K2, the fused candidate-table build: (skey [P, N] i32, bval, bhash,
    bcol [P, N // 64] i32) for bucket rows at GLOBAL task rows ``rows``
    and node origin ``n0``.  See csrc/topk_blocks.cu."""
    if not _kernel_device(score_static):
        return masked_topk_blocks_plain(score_static, task_req, idle,
                                        releasing, rows, quanta, n0)
    from kube_batch_tpu_torch.ops._build import load_library

    dev = score_static.device
    P, N = score_static.shape
    R = task_req.shape[1]
    if N == 0 or not 0 < R <= MAX_R:
        raise ValueError(f"masked_topk_blocks: N={N}, R={R} (1..{MAX_R})")
    f32, i32 = torch.float32, torch.int32
    _check("score_static", score_static, f32, (P, N), dev)
    _check("task_req", task_req, f32, (P, R), dev)
    _check("idle", idle, f32, (N, R), dev)
    _check("releasing", releasing, f32, (N, R), dev)
    _check("rows", rows, i32, (P,), dev)
    _check("quanta", quanta, f32, (R,), dev)
    NB = N // TOPK_BLOCK
    skey = torch.empty((P, N), dtype=i32, device=dev)
    bval = torch.empty((P, NB), dtype=i32, device=dev)
    bhash = torch.empty((P, NB), dtype=i32, device=dev)
    bcol = torch.empty((P, NB), dtype=i32, device=dev)
    if P == 0:
        return skey, bval, bhash, bcol
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.kbt_masked_topk_blocks(
            score_static.data_ptr(), task_req.data_ptr(), idle.data_ptr(),
            releasing.data_ptr(), rows.data_ptr(), quanta.data_ptr(),
            # kbt: allow[KBT005] n0 is a Python int (see K1's call above)
            P, N, R, int(n0), skey.data_ptr(), bval.data_ptr(),
            bhash.data_ptr(), bcol.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, rc, "masked_topk_blocks")
    launches["masked_topk_blocks"] += 1
    return skey, bval, bhash, bcol
