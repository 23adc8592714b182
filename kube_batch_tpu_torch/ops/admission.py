"""The enqueue admission gate — the sequential admission over job rows.

Mirrors ``kube_batch_tpu/ops/admission.py``.  The reference's enqueue
action (enqueue.go:102-117) walks Pending PodGroups in (queue, job) order
and admits each whose MinResources fit the remaining overcommitted idle,
deducting on admission.  Each admission shrinks the budget the next
candidate sees, so the walk is one sequential scan over the candidate rows
the host has put in admission order (``actions/enqueue.py``): per row,
``ok = cand & (min ≤ idle, tolerating sub-quantum excess)``, and on
admission ``idle -= min`` clamped at zero.

The budget is carried in float32 as a Kahan-compensated (idle, comp) pair:
the bits each subtraction would round away are carried forward, so the
accumulated error stays about one ulp whatever the number of admissions
(the JAX package's docstring has the derivation).  The port repeats XLA's
f32 operation order exactly, so its verdicts are bit-identical.

``gate_scan`` is the plain version (a loop over the rows); ``enqueue_gate``
takes it for CPU tensors and launches the CUDA kernel
(``csrc/enqueue_gate.cu``) for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from kube_batch_tpu_torch.ops import kernels
from kube_batch_tpu_torch.utils.seams import opaque


def gate_scan(min_res, cand, idle0, quanta, n_rows: Optional[int] = None):
    """Admitted mask [capJ] bool for candidates in scan order:
    ``min_res`` [capJ, R] f32 (MinResources rows), ``cand`` [capJ] bool
    (candidate and statically enqueueable), ``idle0`` [R] f32 (the
    overcommitted idle), ``quanta`` [R] f32.  Rows from ``n_rows`` on
    (default: all) are not walked and come back False; the caller passes
    at least the last candidate's row + 1, since a row that is not a
    candidate still folds the compensation into idle."""
    n = min_res.shape[0] if n_rows is None else n_rows
    admitted = torch.zeros(min_res.shape[0], dtype=torch.bool, device=min_res.device)
    idle = idle0.clone()
    comp = torch.zeros_like(idle0)
    zero = torch.zeros((), dtype=idle0.dtype, device=idle0.device)
    # kbt: allow[KBT005] the plain gate: the kernel's row-by-row reference scan;
    # the main path runs it only on the CPU (on a card enqueue_gate launches
    # the kernel)
    for i in range(n):
        m = min_res[i]
        eff = idle + comp
        ok = cand[i] & ((m <= eff) | (m - eff < quanta)).all()
        y = torch.where(ok, comp - m, comp)
        t = idle + y
        comp = (idle - t) + y
        idle = torch.maximum(t, zero)
        comp = torch.where(idle > 0.0, comp, zero)
        admitted[i] = ok
    return admitted


@opaque
def enqueue_gate(min_res, cand, idle0, quanta, n_rows: Optional[int] = None):
    """:func:`gate_scan` on the device of ``min_res``: the plain version for
    a CPU tensor, the CUDA kernel for a CUDA tensor (one CTA, one warp
    walking the rows; see csrc/enqueue_gate.cu)."""
    if not kernels._kernel_device(min_res):
        return gate_scan(min_res, cand, idle0, quanta, n_rows)
    from kube_batch_tpu_torch.ops._build import load_library

    dev = min_res.device
    J, R = min_res.shape
    n = J if n_rows is None else n_rows
    if not 0 < R <= kernels.MAX_R or not 0 <= n <= J:
        raise ValueError(f"enqueue_gate: R={R} (1..{kernels.MAX_R}), "
                         f"n_rows={n} (0..{J})")
    kernels._check("min_res", min_res, torch.float32, (J, R), dev)
    kernels._check("cand", cand, torch.bool, (J,), dev)
    kernels._check("idle0", idle0, torch.float32, (R,), dev)
    kernels._check("quanta", quanta, torch.float32, (R,), dev)
    admitted = torch.zeros(J, dtype=torch.bool, device=dev)
    if n == 0:
        return admitted
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.kbt_enqueue_gate(
            min_res.data_ptr(), cand.data_ptr(), idle0.data_ptr(),
            quanta.data_ptr(), n, R, admitted.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels._raise_on(lib, rc, "enqueue_gate")
    kernels.launches["enqueue_gate"] += 1
    return admitted
