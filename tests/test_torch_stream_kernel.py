"""Streaming SpMM (K2) parity of the PyTorch port against the JAX package on
the CPU: ``build_stream_plan`` must give the JAX package's arrays exactly
for the same tiles, and the plain version ``spmm_stream_reference`` must
match the JAX Pallas kernel in interpret mode (``tile_m=64``, ``tile_k=32``,
explicit zeros dropped) for ``layout`` row and vreg, to abs 1e-4. The CUDA
kernel itself is tested on the card (``test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.ops import ell as je
from basic_sparse_matrix_tpu.ops.pallas import stream_kernel as jk
from basic_sparse_matrix_tpu_torch.ops import ell as pe
from basic_sparse_matrix_tpu_torch.ops import interop as pi
from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as pk

torch.set_num_threads(1)


def _entries(seed=7, rows=200, cols=300, nnz=1500):
    rng = np.random.default_rng(seed)
    ri = rng.integers(0, rows, nnz)
    ci = rng.integers(0, cols, nnz)
    v = rng.standard_normal(nnz).astype(np.float32)
    v[::17] = 0.0  # explicit zeros are dropped like ELL padding
    return ri, ci, v, rows, cols


def _assert_same_plan(p, j):
    for name in ("rows", "cols", "tile_m", "tile_k", "n_rt", "n_kt", "nnz",
                 "cellmax"):
        assert getattr(p, name) == getattr(j, name), name
    for name in ("ii", "kk", "vv"):
        assert np.array_equal(getattr(p, name).numpy(),
                              np.asarray(getattr(j, name))), name
    assert p.pad_factor == pytest.approx(j.pad_factor)


@pytest.mark.parametrize("tile_m,tile_k", [(64, 32), (16, 300), (8, 8),
                                           (4096, 2048), (1, 1000)])
def test_build_stream_plan_equals_jax(tile_m, tile_k):
    ri, ci, v, rows, cols = _entries()
    _assert_same_plan(
        pk.build_stream_plan(ri, ci, v, rows, cols, tile_m=tile_m,
                             tile_k=tile_k),
        jk.build_stream_plan(ri, ci, v, rows, cols, tile_m=tile_m,
                             tile_k=tile_k))


@pytest.mark.parametrize("layout", ["row", "vreg"])
def test_spmm_stream_reference_matches_jax_kernel(layout):
    ri, ci, v, rows, cols = _entries()
    b = np.random.default_rng(8).standard_normal((cols, 24)).astype(
        np.float32)
    jplan = jk.build_stream_plan(ri, ci, v, rows, cols, tile_m=64, tile_k=32)
    jout = np.asarray(jk.spmm_stream(jplan, jnp.asarray(b), layout=layout))
    pplan = pi.stream_plan_from_numpy(
        jplan.ii, jplan.kk, jplan.vv, rows=rows, cols=cols, tile_m=64,
        tile_k=32, nnz=jplan.nnz)
    _assert_same_plan(pplan, jplan)
    out = pk.spmm_stream_reference(pplan, torch.from_numpy(b))
    assert tuple(out.shape) == (rows, 24)
    assert np.abs(out.numpy() - jout).max() < 1e-4
    dense = np.zeros((rows, cols), np.float64)
    np.add.at(dense, (ri, ci), v)
    assert np.abs(out.numpy() - dense @ b).max() < 1e-4


@pytest.mark.parametrize("layout", ["row", "vreg", "vregp"])
def test_spmm_stream_on_cpu_is_the_plain_version(layout):
    ri, ci, v, rows, cols = _entries(seed=3)
    plan = pk.build_stream_plan(ri, ci, v, rows, cols, tile_m=16,
                                tile_k=cols)
    b = torch.randn((cols, 9), generator=torch.Generator().manual_seed(0))
    before = pk.LAUNCHES
    out = pk.spmm_stream(plan, b, layout=layout)
    assert pk.LAUNCHES == before
    assert torch.equal(out, pk.spmm_stream_reference(plan, b))


def test_spmm_stream_rejects_bad_arguments():
    ri, ci, v, rows, cols = _entries(seed=4)
    plan = pk.build_stream_plan(ri, ci, v, rows, cols, tile_m=16, tile_k=64)
    with pytest.raises(ValueError):
        pk.spmm_stream(plan, torch.zeros((cols, 4)), layout="diag")
    with pytest.raises(ValueError):
        pk.spmm_stream(plan, torch.zeros((cols + 1, 4)))


def test_reference_chunks_agree(monkeypatch):
    ri, ci, v, rows, cols = _entries(seed=5)
    plan = pk.build_stream_plan(ri, ci, v, rows, cols, tile_m=8, tile_k=50)
    b = torch.randn((cols, 12), generator=torch.Generator().manual_seed(1))
    whole = pk.spmm_stream_reference(plan, b)
    monkeypatch.setattr(pk, "REFERENCE_BUDGET_BYTES", 1)  # one cell a chunk
    np.testing.assert_allclose(pk.spmm_stream_reference(plan, b).numpy(),
                               whole.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["ii", "kk", "row_past_end",
                                 "col_past_end", "shape"])
def test_plan_validation_rejects_out_of_range(bad):
    ri, ci, v, rows, cols = _entries(seed=6)
    j = jk.build_stream_plan(ri, ci, v, rows, cols, tile_m=64, tile_k=32)
    ii, kk, vv = (np.array(x) for x in (j.ii, j.kk, j.vv))
    if bad == "ii":
        ii[-1, 0, 0] = 64          # not < tile_m
    elif bad == "kk":
        kk[0, 0, 0] = -1
    elif bad == "row_past_end":
        ii[-1, 0, 0] = 10          # row tile 3 starts at 192: row 202 >= 200
    elif bad == "col_past_end":
        kk[9, 0, 0] = 20           # k tile 9 starts at 288: col 308 >= 300
    else:
        ii, kk, vv = ii[:, :, :8], kk[:, :, :8], vv[:, :, :8]
    with pytest.raises(ValueError):
        pi.stream_plan_from_numpy(ii, kk, vv, rows=rows, cols=cols,
                                  tile_m=64, tile_k=32, nnz=j.nnz)


@pytest.mark.parametrize("rows,n_rhs", [(1_000_000, 512), (1_000_000, 128),
                                        (100_000, 2048), (1000, 24),
                                        (5, 512)])
def test_pick_tile_m_fits_hopper_shared_memory(rows, n_rhs):
    tm = pk.pick_tile_m(rows, n_rhs)
    assert tm & (tm - 1) == 0
    slice_cols = min(512, -(-n_rhs // 128) * 128)
    assert tm * slice_cols * 4 <= pk.SMEM_TILE_BYTES
    assert tm < 2 * max(rows, 1)


def test_stream_plan_from_ell_memoised_and_cuda_tiles():
    rng = np.random.default_rng(3)
    d = ((rng.random((100, 100)) < 0.05)
         * rng.standard_normal((100, 100))).astype(np.float32)
    pell = pe.csr_to_ell(P.CSR.from_dense(d))
    p1 = pk.stream_plan_from_ell(pell)
    assert p1 is pk.stream_plan_from_ell(pell)
    assert p1.nnz == int((d != 0).sum())
    assert (p1.tile_m, p1.tile_k) == (pk.pick_tile_m(100, 512), 100)
    jell = je.csr_to_ell(J.CSR.from_dense(d))
    _assert_same_plan(p1, jk.build_stream_plan(
        np.repeat(np.arange(100), jell.width), np.asarray(jell.cols).ravel(),
        np.asarray(jell.vals).ravel(), 100, 100, tile_m=p1.tile_m,
        tile_k=p1.tile_k))
