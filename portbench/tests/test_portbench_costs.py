"""The roofline's counts read the work from the data, whatever layout the
path takes: the CSR the gather rungs read, the ELL layout, and the plan of
the streaming kernel (K2) count alike."""

import numpy as np

from basic_sparse_matrix_tpu_torch import CSR
from basic_sparse_matrix_tpu_torch.ops.ell import csr_to_ell
from basic_sparse_matrix_tpu_torch.ops.pallas.stream_kernel import \
    stream_plan_from_ell
from conftest import small
from portbench import costs, hpcg, manifest


def test_same_count_on_every_path():
    config = small(manifest.data("configs", "hpcg-104"))
    indptr, indices, values = hpcg.csr(config)
    n = indptr.shape[0] - 1
    a = CSR.from_host(indptr, indices, values, (n, n), device="cpu")
    ell = csr_to_ell(a)
    plan = stream_plan_from_ell(ell, 256)
    assert plan.n_kt == 1
    for width in (64, 256):
        csr = costs.spmm(n, indices, values, width)
        padded = costs.spmm(n, ell.cols.numpy(), ell.vals.numpy(), width)
        k2 = costs.spmm(n, plan.kk.numpy(), plan.vv.numpy(), width)
        assert csr == padded == k2
        nnz = indices.size
        assert csr["flops"] == 2 * nnz * width
        assert csr["bytes"] == 8 * nnz + 4 * (n + 1) + 2 * 4 * n * width


def test_bound_and_peaks():
    peak = costs.peaks("NVIDIA H100 80GB HBM3")
    cost = {"flops": 2 * 29_791_000 * 256.0, "bytes": 2.54e9}
    assert abs(costs.bound_s(cost, peak) - 2.54e9 / 3.35e12) < 1e-12
    assert costs.peaks("cpu") is None


def test_held_columns_only():
    cost = costs.spmm(4, np.array([0, 0, 2, 0]), np.array([1.0, 2, 3, 0]), 8)
    assert cost["flops"] == 2 * 3 * 8
    assert cost["bytes"] == 3 * 8 + 5 * 4 + 2 * 8 * 4 + 4 * 8 * 4
