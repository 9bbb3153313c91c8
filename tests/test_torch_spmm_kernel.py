"""BSR SpMM (K1) parity of the PyTorch port against the JAX package on the
CPU: the host layout ``csr_to_bsr`` must equal the JAX one exactly (blocks,
block coordinates, seeded zero blocks), and the plain version
``spmm_bsr_reference`` must match the JAX Pallas kernel in interpret mode
to ``rtol=atol=1e-4`` (the JAX kernel test's own bound). The CUDA kernel
itself is tested on the card (``test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.ops.pallas import spmm_kernel as jk
from basic_sparse_matrix_tpu_torch.ops import interop as pi
from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as pk

torch.set_num_threads(1)

CASES = [
    (128, 256, 0.05, 128),   # tile-aligned
    (100, 200, 0.1, 64),     # unaligned everything
    (8, 128, 1.0, 128),      # single dense block
    (1000, 1000, 0.01, 10),  # reference bench shape
    (64, 64, 0.0, 32),       # empty matrix
]


def _case(rows, cols, density, n_rhs, seed=42):
    rng = np.random.default_rng(seed)
    d = ((rng.random((rows, cols)) < density)
         * rng.standard_normal((rows, cols))).astype(np.float32)
    b = rng.standard_normal((cols, n_rhs)).astype(np.float32)
    return d, b


def _assert_same_bsr(p, j):
    assert (p.rows, p.cols, p.bm, p.bk) == (j.rows, j.cols, j.bm, j.bk)
    assert np.array_equal(p.blocks.numpy(), np.asarray(j.blocks))
    assert np.array_equal(p.block_rows.numpy(), np.asarray(j.block_rows))
    assert np.array_equal(p.block_cols.numpy(), np.asarray(j.block_cols))


@pytest.mark.parametrize("rows,cols,density,n_rhs", CASES)
def test_csr_to_bsr_equals_jax(rows, cols, density, n_rhs):
    d, _ = _case(rows, cols, density, n_rhs)
    _assert_same_bsr(pk.csr_to_bsr(P.CSR.from_dense(d)),
                     jk.csr_to_bsr(J.CSR.from_dense(d)))


@pytest.mark.parametrize("bm,bk", [(8, 128), (64, 256), (256, 512),
                                   (16, 32)])
def test_csr_to_bsr_explicit_tiles_equal_jax(bm, bk):
    d, _ = _case(300, 700, 0.02, 8, seed=3)
    _assert_same_bsr(pk.csr_to_bsr(P.CSR.from_dense(d), bm, bk),
                     jk.csr_to_bsr(J.CSR.from_dense(d), bm, bk))


def test_bsr_structure_seeded_blocks_and_row_pointer():
    d = np.zeros((16, 256), dtype=np.float32)
    d[0, 0] = 1.0       # block (0, 0)
    d[9, 130] = 2.0     # block (1, 1)
    d[15, 255] = 3.0    # block (1, 1)
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    _assert_same_bsr(bsr, jk.csr_to_bsr(J.CSR.from_dense(d)))
    assert bsr.block_rows.tolist() == [0, 1, 1]
    assert bsr.block_cols.tolist() == [0, 0, 1]
    assert bsr.brow_ptr.tolist() == [0, 1, 3]
    assert torch.all(bsr.blocks[1] == 0)


@pytest.mark.parametrize("rows,cols,density,n_rhs", CASES)
def test_spmm_bsr_reference_matches_jax_kernel(rows, cols, density, n_rhs):
    d, b = _case(rows, cols, density, n_rhs)
    jout = np.asarray(jk.spmm_bsr(jk.csr_to_bsr(J.CSR.from_dense(d)),
                                  jnp.asarray(b)))
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    out = pk.spmm_bsr_reference(bsr, torch.from_numpy(b))
    assert tuple(out.shape) == (rows, n_rhs)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows,cols,density,n_rhs", CASES[:4])
def test_bsr_from_numpy_carries_jax_layout(rows, cols, density, n_rhs):
    d, b = _case(rows, cols, density, n_rhs, seed=5)
    jb = jk.csr_to_bsr(J.CSR.from_dense(d))
    pb = pi.bsr_from_numpy(jb.blocks, jb.block_rows, jb.block_cols,
                           jb.rows, jb.cols)
    _assert_same_bsr(pb, jb)
    np.testing.assert_allclose(
        pk.spmm_bsr(pb, torch.from_numpy(b)).numpy(),
        np.asarray(jk.spmm_bsr(jb, jnp.asarray(b))), rtol=1e-4, atol=1e-4)


def test_make_bsr_rejects_bad_layouts():
    blocks = np.zeros((2, 8, 128), np.float32)
    with pytest.raises(ValueError):
        pk.make_bsr(blocks, [1, 0], [0, 0], 16, 128)   # unsorted rows
    with pytest.raises(ValueError):
        pk.make_bsr(blocks, [0, 1], [0, 1], 16, 128)   # column out of range
    with pytest.raises(ValueError):
        pk.make_bsr(blocks, [0], [0], 16, 128)         # shape mismatch


def test_spmm_bsr_on_cpu_runs_plain_version_without_launch():
    d, b = _case(64, 128, 0.2, 128, seed=1)
    a = P.CSR.from_dense(d)
    before = pk.LAUNCHES
    out1 = pk.spmm_bsr_from_csr(a, torch.from_numpy(b))
    assert a._bsr_cache is not None
    cached = a._bsr_cache
    out2 = pk.spmm_bsr_from_csr(a, torch.from_numpy(b))
    assert a._bsr_cache is cached and pk.LAUNCHES == before
    assert torch.equal(out1, out2)
    np.testing.assert_allclose(out1.numpy(), d @ b, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        pk.spmm_bsr(cached, torch.zeros((127, 4)))


@pytest.mark.parametrize("density", [0.9, 0.05, 0.01, 0.001])
def test_bsr_profitable_cpu_gate_and_fill_logic(density):
    d, b = _case(256, 512, density, 128, seed=2)
    p, j = P.CSR.from_dense(d), J.CSR.from_dense(d)
    bt = torch.from_numpy(b)
    # CPU tensors never dispatch to the kernel ...
    assert pk.bsr_profitable(p, bt) is False
    # ... and the fill logic agrees with the JAX package's.
    assert pk.bsr_profitable(p, bt, force=True) == \
        jk.bsr_profitable(j, 128, force=True)
    assert pk.bsr_profitable(p, bt, force=True) == \
        pk.bsr_profitable(p, bt, force=True)  # memoised fill
    pk.cached_bsr(p)
    jk.spmm_bsr_from_csr(j, jnp.asarray(b))
    assert pk.bsr_profitable(p, bt, force=True) == \
        jk.bsr_profitable(j, 128, force=True)
    assert pk.bsr_profitable(p, bt[:, :32], force=True) is False


@pytest.mark.parametrize("rows,cols,nnz", [(10, 10, 100), (1000, 1000, 5000),
                                           (1000, 1000, 50000),
                                           (100, 100, 0)])
def test_pick_tiles_matches_jax(rows, cols, nnz):
    assert pk.pick_tiles(rows, cols, nnz) == jk.pick_tiles(rows, cols, nnz)
