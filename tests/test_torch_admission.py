"""The enqueue gate: the port's plain ``gate_scan`` against the JAX
package's ``enqueue_gate_solve`` (the jitted ``lax.scan``), bit-exact on the
admitted mask, on the main path's inputs (12 500 MinResources rows at
capJ 16 384) and on the corners — rows within one quantum of the budget's
edge, every row rejected, non-candidate rows between candidates while the
compensation is live, and thousands of admissions where the Kahan carry
decides the last verdicts.  The CUDA kernel against the plain version is
the ``cuda`` test at the end (and ``chip_smoke.py``'s ``enqueue_gate``
phase)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kube_batch_tpu.ops.admission import enqueue_gate_solve
from kube_batch_tpu_torch.ops import kernels
from kube_batch_tpu_torch.ops.admission import enqueue_gate, gate_scan
from kube_batch_tpu_torch.testing.kernel_bench import (
    gate_bound,
    gate_case,
    gate_corners,
    gate_tensors,
)

CASES = dict(gate_corners(), main=gate_case())


@pytest.mark.parametrize("name", sorted(CASES))
def test_gate_scan_matches_jax(name):
    c = CASES[name]
    want = np.asarray(enqueue_gate_solve(c["min_res"], c["cand"], c["idle0"], c["quanta"]))
    got = gate_scan(**gate_tensors(c, "cpu")).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_cases_admit_and_reject():
    """Each case decides what it is for."""
    verdicts = {name: gate_scan(**gate_tensors(c, "cpu")).numpy()
                for name, c in CASES.items()}
    assert verdicts["edge"][:6].tolist() == [True, False, True, True, False, True]
    assert not verdicts["all_rejected"].any()
    assert not verdicts["inf_budget"].any()
    assert CASES["inf_budget"]["cand"][16:24].all()  # empty rows, candidates
    for name in ("fold", "many_admissions", "main"):
        cand = CASES[name]["cand"]
        admitted = verdicts[name]
        assert admitted.sum() > 1000 or name == "fold"
        assert 0 < admitted.sum() < cand.sum(), name  # the budget runs short
        assert not (admitted & ~cand).any(), name
    # the fold case interleaves rows that are not candidates
    assert (~CASES["fold"]["cand"][:CASES["fold"]["n_rows"]]).sum() > 100


def test_rows_past_n_rows_are_not_walked():
    c = CASES["main"]
    got = gate_scan(**gate_tensors(c, "cpu")).numpy()
    assert not got[c["n_rows"]:].any()


def test_gate_on_the_cpu_takes_the_plain_version():
    kernels.reset_launches()
    c = gate_tensors(CASES["edge"], "cpu")
    np.testing.assert_array_equal(enqueue_gate(**c).numpy(), gate_scan(**c).numpy())
    assert kernels.launches["enqueue_gate"] == 0


def test_gate_bound_is_the_dependence_chain():
    b_ms, by = gate_bound(CASES["main"], clock_hz=1.98e9)
    assert by == "operations"
    assert b_ms == pytest.approx(12_500 * 24 / 1.98e9 * 1e3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_gate_kernel_matches_plain(cuda_device, name):
    c = gate_tensors(CASES[name], cuda_device)
    kernels.reset_launches()
    got = enqueue_gate(**c)
    torch.cuda.synchronize()
    assert kernels.launches["enqueue_gate"] == 1
    want = gate_scan(**gate_tensors(CASES[name], "cpu"))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_ptxas_summary_names_the_gate_kernel():
    from kube_batch_tpu_torch.ops._build import ptxas_summary

    out = ("ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__ab669374_15_"
           "enqueue_gate_cu_f402d93519enqueue_gate_kernelEPKfPKhS1_S1_iiPh' for 'sm_90a'\n"
           "ptxas info    : Used 35 registers, used 1 barriers, 33792 bytes smem\n")
    assert ptxas_summary(out) == [
        "enqueue_gate_kernel: Used 35 registers, used 1 barriers, 33792 bytes smem"]
