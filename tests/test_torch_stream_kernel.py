"""Streaming SpMM (K2) parity of the PyTorch port against the JAX package on
the CPU: ``build_stream_plan`` must give the JAX package's arrays exactly
for the same tiles, and the plain version ``spmm_stream_reference`` must
match the JAX Pallas kernel in interpret mode (``tile_m=64``, ``tile_k=32``,
explicit zeros dropped) for ``layout`` row and vreg, to abs 1e-4. For the
sliced kernel: the per-cell row pointers equal a numpy walk of ``ii``, a
pure-torch model of its arithmetic (slice-major pack, per-row sums, unpack)
equals the plain version and the JAX kernel to rtol 1e-5, and the dispatch
between the two kernels is a pure function of the shape. The CUDA kernels
themselves are tested on the card (``test_torch_cuda_kernels.py``).
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


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


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


# ---- the sliced kernel: row pointers, arithmetic model, dispatch ---------- #
def _row_ordered_entries(**kw):
    """``_entries`` in row order, as ``stream_plan_from_ell`` hands them to
    ``build_stream_plan`` (stable: the column order inside a row stays)."""
    ri, ci, v, rows, cols = _entries(**kw)
    order = np.argsort(ri, kind="stable")
    return ri[order], ci[order], v[order], rows, cols


def _walk_row_pointers(ii, vv, tile_m):
    """Row pointers of every cell by a plain walk of its slots."""
    ncells, _, cellmax = ii.shape
    ptr = np.zeros((ncells, tile_m + 1), np.int32)
    longest = 0
    for c in range(ncells):
        counts = np.zeros(tile_m, np.int64)
        for s in range(cellmax):
            if vv[c, 0, s] != 0:
                counts[ii[c, 0, s]] += 1
        ptr[c, 1:] = np.cumsum(counts)
        longest = max(longest, int(counts.max()))
    return ptr, longest


@pytest.mark.parametrize("tile_m,tile_k", [(64, 32), (16, 300), (8, 8),
                                           (4096, 2048), (1, 1000)])
def test_cell_row_pointers_equal_a_numpy_walk(tile_m, tile_k):
    ri, ci, v, rows, cols = _row_ordered_entries()
    plan = pk.build_stream_plan(ri, ci, v, rows, cols, tile_m=tile_m,
                                tile_k=tile_k)
    # the row-ordered plan still equals the JAX package's entry for entry
    _assert_same_plan(plan, jk.build_stream_plan(ri, ci, v, rows, cols,
                                                 tile_m=tile_m,
                                                 tile_k=tile_k))
    ptr, longest = pk.cell_row_pointers(plan)
    want, want_longest = _walk_row_pointers(plan.ii.numpy(), plan.vv.numpy(),
                                            tile_m)
    assert ptr.dtype == torch.int32 and ptr.device == plan.ii.device
    assert np.array_equal(ptr.numpy(), want)
    assert longest == want_longest
    assert pk.cell_row_pointers(plan)[0] is ptr          # memoised
    # the pointers address the slots of each row, in slot order
    ii = plan.ii.numpy()
    for c in range(0, ii.shape[0], max(ii.shape[0] // 7, 1)):
        for i in range(tile_m if tile_m < 70 else 3):
            assert (ii[c, 0, want[c, i]: want[c, i + 1]] == i).all()


@pytest.mark.parametrize("tile_m,tile_k", [(64, 32), (16, 300)])
def test_cells_out_of_row_order_have_no_row_pointers(tile_m, tile_k):
    """Entries in no row order leave a cell's slots unsorted (as in the JAX
    package): the longest row is still counted, but there are no pointers,
    and the sliced model refuses the plan."""
    ri, ci, v, rows, cols = _entries()
    plan = pk.build_stream_plan(ri, ci, v, rows, cols, tile_m=tile_m,
                                tile_k=tile_k)
    ptr, longest = pk.cell_row_pointers(plan)
    assert ptr is None
    assert longest == _walk_row_pointers(plan.ii.numpy(), plan.vv.numpy(),
                                         tile_m)[1]
    with pytest.raises(ValueError):
        pk.spmm_stream_sliced_model(plan, torch.zeros((cols, 8)), 8)


@pytest.mark.parametrize("w", [4, 8, 16, 32])
@pytest.mark.parametrize("n_rhs", [24, 20, 64])
def test_sliced_model_matches_plain_and_jax_kernel(w, n_rhs):
    """Tolerance rtol 1e-5 (atol 1e-5 of the largest magnitude): float32
    sums of the same products, taken row by row instead of by
    ``index_add_``."""
    ri, ci, v, rows, cols = _row_ordered_entries()
    b = np.random.default_rng(8).standard_normal((cols, n_rhs)).astype(
        np.float32)
    plan = pk.build_stream_plan(ri, ci, v, rows, cols, tile_m=16,
                                tile_k=cols)
    out = pk.spmm_stream_sliced_model(plan, torch.from_numpy(b), w)
    assert tuple(out.shape) == (rows, n_rhs) and out.dtype == torch.float32
    ref = pk.spmm_stream_reference(plan, torch.from_numpy(b)).numpy()
    atol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=atol)
    jplan = jk.build_stream_plan(ri, ci, v, rows, cols, tile_m=16,
                                 tile_k=cols)
    jout = np.asarray(jk.spmm_stream(jplan, jnp.asarray(b), layout="vreg"))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("tile_m,tile_k", [(64, 32), (8, 100), (16, 299)])
def test_sliced_kernel_refuses_several_k_tiles(tile_m, tile_k):
    """The sliced kernel and its model take plans with one k tile only; the
    dispatch sends the others to the tile kernel."""
    ri, ci, v, rows, cols = _row_ordered_entries(seed=9)
    plan = pk.build_stream_plan(ri, ci, v, rows, cols, tile_m=tile_m,
                                tile_k=tile_k)
    assert plan.n_kt > 1 and pk.cell_row_pointers(plan)[0] is not None
    with pytest.raises(ValueError, match="one k tile"):
        pk.spmm_stream_sliced_model(plan, torch.zeros((cols, 12)), 8)
    assert pk.pick_stream_kernel(1 << 20, 1 << 20, 512, plan.n_kt, 1) == (
        "tile", 0)


@pytest.mark.parametrize("k,n,w", [(10, 8, 4), (7, 20, 8), (5, 64, 32),
                                   (3, 36, 16)])
def test_pack_slices_is_slice_major_and_zero_padded(k, n, w):
    b = torch.arange(k * n, dtype=torch.float32).view(k, n)
    packed = pk.pack_slices(b, w)
    n_slices = -(-n // w)
    assert tuple(packed.shape) == (n_slices, k, w) and packed.is_contiguous()
    for s in range(n_slices):
        width = min(w, n - s * w)
        assert torch.equal(packed[s, :, :width], b[:, s * w: s * w + width])
        assert not packed[s, :, width:].any()


@pytest.mark.parametrize("rows,k,n,n_kt,longest,want", [
    (1_000_000, 1_000_000, 512, 1, 32, ("sliced", 32)),  # main shape: B 2 GB
    (200_000, 200_000, 512, 1, 32, ("sliced", 32)),   # a slice that fits L2
    (4096, 4096, 512, 1, 32, ("tile", 0)),         # B (8 MiB) fits the budget
    (16384, 16384, 512, 1, 32, ("tile", 0)),       # B exactly the budget
    (16385, 16385, 512, 1, 32, ("sliced", 32)),
    (1_000_000, 1_000_000, 512, 61, 32, ("tile", 0)),    # several k tiles
    (1_000_000, 1_000_000, 510, 1, 32, ("tile", 0)),     # N % 4 != 0
    (200_000, 200_000, 512, 1, 3200, ("tile", 0)),   # a row 100x the average
    (1_000_000, 1_000_000, 512, 1, 5208, ("sliced", 32)),  # longest allowed
    (1_000_000, 1_000_000, 512, 1, 5209, ("tile", 0)),
    (50_000, 1_000_000, 512, 1, 512, ("tile", 0)),   # by the rows, not by K
    (50_000, 50_000, 512, 1, 256, ("sliced", 32)),
])
def test_pick_stream_kernel_is_a_function_of_the_shape(rows, k, n, n_kt,
                                                       longest, want):
    assert pk.pick_stream_kernel(rows, k, n, n_kt, longest) == want
    fits = n_kt == 1 and n % 4 == 0 and k * n * 4 > pk.L2_SLICE_BUDGET_BYTES
    assert pk.slice_width(k, n, n_kt) == (32 if fits else 0)
    assert (want[0] == "sliced") == (fits
                                     and longest * pk.LONG_ROW_ROWS <= rows)
    assert pk.L2_SLICE_BUDGET_BYTES == 32 << 20
    assert pk.LONG_ROW_ROWS == 192


def test_kernel_launchers_refuse_cpu_tensors():
    ri, ci, v, rows, cols = _row_ordered_entries(seed=3)
    plan = pk.build_stream_plan(ri, ci, v, rows, cols, tile_m=16,
                                tile_k=cols)
    b = torch.zeros((cols, 8))
    before = (pk.LAUNCHES, dict(pk.LAUNCHES_BY_KERNEL))
    for launch in (lambda: pk.spmm_stream_tile(plan, b),
                   lambda: pk.spmm_stream_sliced(plan, b, 8),
                   lambda: pk.pack_slices_cuda(b, 8)):
        with pytest.raises(ValueError):
            launch()
    assert (pk.LAUNCHES, pk.LAUNCHES_BY_KERNEL) == before
