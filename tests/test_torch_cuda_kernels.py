"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small and ragged shapes (unaligned rows, columns and RHS
widths, thin and fat BSR tiles, both vector widths and several column
slices of the streaming kernel).

These need a CUDA device and nvcc; without a device every test skips. On a
GPU machine: ``python -m pytest tests/test_torch_cuda_kernels.py -q
--noconftest`` (``tests/conftest.py`` sets up jax, which these tests do not
use).
Tolerance: float32 summed in another order, ``rtol=1e-4`` and ``atol=1e-4``
times the largest reference magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

from basic_sparse_matrix_tpu_torch import CSR, mul_dense
from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as k1
from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2
from basic_sparse_matrix_tpu_torch.utils import config as cfgmod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(out, ref):
    scale = float(ref.abs().max()) if ref.numel() else 1.0
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * max(scale, 1))


def _sparse(rng, rows, cols, density):
    return ((rng.random((rows, cols)) < density)
            * rng.standard_normal((rows, cols))).astype(np.float32)


@pytest.mark.parametrize(
    "rows,cols,density,n_rhs,tiles",
    [
        (128, 256, 0.05, 128, None),      # (256, 512) tiles, one block row
        (100, 200, 0.1, 64, None),        # unaligned everything
        (1000, 1000, 0.01, 10, None),     # (64, 256) tiles
        (300, 2000, 0.001, 130, None),    # (8, 128) thin tiles
        (64, 64, 0.0, 32, None),          # empty matrix, seeded blocks only
        (130, 1000, 0.2, 70, (100, 96)),  # tiles that are no multiple of 8
    ],
)
def test_spmm_bsr_kernel_matches_plain(cuda, rows, cols, density, n_rhs,
                                       tiles):
    rng = np.random.default_rng(42)
    a = CSR.from_dense(_sparse(rng, rows, cols, density), device=cuda)
    bsr = k1.csr_to_bsr(a, *(tiles or (None, None)))
    b = torch.as_tensor(rng.standard_normal((cols, n_rhs)).astype(np.float32),
                        device=cuda)
    before = k1.LAUNCHES
    out = k1.spmm_bsr(bsr, b)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    _close(out, k1.spmm_bsr_reference(bsr, b))


@pytest.mark.parametrize(
    "rows,cols,nnz,n_rhs,tile_m,tile_k",
    [
        (200, 300, 1500, 24, 64, 32),       # the JAX test's tiles
        (200, 300, 1500, 128, 16, 300),     # one k tile
        (1000, 5000, 20000, 512, 16, 5000),  # the main path's slice width
        (513, 77, 3000, 130, 8, 16),        # n % 4 != 0: scalar columns
        (100, 100, 500, 1000, 16, 100),     # two column slices
        (2000, 300, 8000, 128, 512, 300),   # tile over 48 KB: opt-in smem
    ],
)
def test_spmm_stream_kernel_matches_plain(cuda, rows, cols, nnz, n_rhs,
                                          tile_m, tile_k):
    rng = np.random.default_rng(7)
    ri = rng.integers(0, rows, nnz)
    ci = rng.integers(0, cols, nnz)
    v = rng.standard_normal(nnz).astype(np.float32)
    v[::17] = 0.0
    plan = k2.build_stream_plan(ri, ci, v, rows, cols, tile_m=tile_m,
                                tile_k=tile_k, device=cuda)
    b = torch.as_tensor(rng.standard_normal((cols, n_rhs)).astype(np.float32),
                        device=cuda)
    before = k2.LAUNCHES
    out = k2.spmm_stream(plan, b)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    _close(out, k2.spmm_stream_reference(plan, b))
    dense = np.zeros((rows, cols), np.float64)
    np.add.at(dense, (ri, ci), v)
    _close(out, torch.as_tensor(dense @ b.cpu().numpy().astype(np.float64),
                                device=cuda).float())


def test_mul_dense_reaches_each_kernel(cuda):
    rng = np.random.default_rng(3)
    # Block-dense 2048x2048 at 1% density: no dense rung under a lowered
    # byte cap, BSR fill 1.0.
    n, bm, bk = 2048, 64, 256
    d = np.zeros((n, n), np.float32)
    for t in rng.choice((n // bm) * (n // bk), 2, replace=False):
        r, c = divmod(int(t), n // bk)
        d[r * bm:(r + 1) * bm, c * bk:(c + 1) * bk] = rng.standard_normal(
            (bm, bk))
    a_bsr = CSR.from_dense(d, device=cuda)
    rows = 20000
    a_st = CSR.from_coo_arrays(
        (rows, rows), np.repeat(np.arange(rows), 16),
        rng.integers(0, rows, rows * 16),
        rng.standard_normal(rows * 16).astype(np.float32), device=cuda)
    old = cfgmod.get_config()
    cfgmod.set_config(dataclasses.replace(old, dense_dispatch_max_bytes=1))
    try:
        for a, kernel in ((a_bsr, k1), (a_st, k2)):
            b = torch.randn((a.cols, 128), device=cuda)
            before = kernel.LAUNCHES
            out = mul_dense(a, b)
            torch.cuda.synchronize()
            assert kernel.LAUNCHES == before + 1
            ref = torch.zeros_like(out).index_add_(
                0, a.row_ids(),
                b.index_select(0, a.indices) * a.values.unsqueeze(1))
            _close(out, ref)
    finally:
        cfgmod.set_config(old)


def test_integer_operands_take_plain_rungs(cuda):
    rng = np.random.default_rng(5)
    n = 3000
    a = CSR.from_coo_arrays((n, n), rng.integers(0, n, 400000),
                            rng.integers(0, n, 400000),
                            rng.integers(0, 10, 400000).astype(np.int32),
                            device=cuda)
    b = rng.integers(0, 16, (n, 128)).astype(np.int32)
    dense = np.zeros((n, n), np.int64)
    np.add.at(dense, (a.row_ids().cpu().numpy(), a.indices.cpu().numpy()),
              a.values.cpu().numpy())
    before = (k1.LAUNCHES, k2.LAUNCHES)
    old = cfgmod.get_config()
    cfgmod.set_config(dataclasses.replace(old, dense_dispatch_max_bytes=1))
    try:
        out = mul_dense(a, torch.as_tensor(b, device=cuda))
    finally:
        cfgmod.set_config(old)
    assert (k1.LAUNCHES, k2.LAUNCHES) == before
    assert out.dtype == torch.int32
    assert np.array_equal(out.cpu().numpy().astype(np.int64), dense @ b)


def test_kernels_reject_what_they_do_not_take(cuda):
    rng = np.random.default_rng(9)
    a = CSR.from_dense(_sparse(rng, 64, 128, 0.2), device=cuda)
    bsr = k1.csr_to_bsr(a)
    with pytest.raises(TypeError):
        k1.spmm_bsr(bsr, torch.zeros((128, 8), dtype=torch.float64,
                                     device=cuda))
    with pytest.raises(ValueError):
        k1.spmm_bsr(bsr, torch.zeros((100, 8), device=cuda))
    r, c = np.nonzero(_sparse(rng, 64, 128, 0.2))
    plan = k2.build_stream_plan(r, c, np.ones(r.size, np.float32), 64, 128,
                                tile_m=16, tile_k=128, device=cuda)
    with pytest.raises(ValueError):
        k2.spmm_stream(plan, torch.zeros((128, 8), device=cuda),
                       layout="diag")
    with pytest.raises(TypeError):
        k2.spmm_stream(plan, torch.zeros((128, 8), dtype=torch.float16,
                                         device=cuda))
