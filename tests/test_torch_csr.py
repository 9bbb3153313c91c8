"""Storage parity of the PyTorch port against the JAX package: CSR/COO
construction (duplicate summing, zero dropping, dtypes), densify, row ids,
host views, the error types, Dense, and the interop bridge.

Inputs are made with numpy from a seed and handed to both packages.
Integer arrays must match exactly; float32 values to ``rtol=1e-5``.
"""

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.ops import interop as pi

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _triples(a):
    return tuple(np.asarray(x) for x in a.numpy())


def _assert_same_csr(p, j, exact=False):
    assert p.shape == j.shape
    pi_, px, pv = (t.numpy() for t in (p.indptr, p.indices, p.values))
    assert np.array_equal(pi_, np.asarray(j.indptr))
    assert np.array_equal(px, np.asarray(j.indices))
    jv = np.asarray(j.values)
    assert pv.dtype == jv.dtype
    if exact:
        assert np.array_equal(pv, jv)
    else:
        np.testing.assert_allclose(pv, jv, rtol=1e-5)


def _coo(seed, rows, cols, nnz, dtype):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, nnz)
    c = rng.integers(0, cols, nnz)
    if np.dtype(dtype).kind == "f":
        v = rng.standard_normal(nnz).astype(dtype)
        v[::7] = 0.0
    else:
        v = rng.integers(0, 5, nnz).astype(dtype)  # includes zeros
    return r, c, v


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.uint32])
@pytest.mark.parametrize("sum_duplicates,drop_zeros",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_from_coo_arrays_matches_jax(dtype, sum_duplicates, drop_zeros):
    r, c, v = _coo(1, 30, 40, 500, dtype)
    kw = dict(sum_duplicates=sum_duplicates, drop_zeros=drop_zeros)
    p = P.CSR.from_coo_arrays((30, 40), r, c, v, **kw)
    j = J.CSR.from_coo_arrays((30, 40), r, c, v, **kw)
    _assert_same_csr(p, j, exact=np.dtype(dtype).kind != "f")
    assert p.stored == j.stored and p.get_nnz() == j.get_nnz()
    assert p.get_density() == pytest.approx(j.get_density())


def test_duplicates_sum_and_zeros_drop():
    # (0,1) appears twice and sums to 5; (2,2) cancels to 0 and is dropped.
    p = P.CSR.from_coo_arrays((3, 3), [0, 2, 0, 2, 1], [1, 2, 1, 2, 0],
                              np.array([2.0, 1.5, 3.0, -1.5, 4.0],
                                       np.float32))
    assert p.indptr.tolist() == [0, 1, 2, 2]
    assert p.indices.tolist() == [1, 0]
    assert p.values.tolist() == [5.0, 4.0]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape,density", [((17, 33), 0.2), ((64, 8), 0.5),
                                           ((5, 5), 0.0)])
def test_from_dense_todense_row_ids(seed, shape, density):
    rng = np.random.default_rng(seed)
    d = ((rng.random(shape) < density)
         * rng.standard_normal(shape)).astype(np.float32)
    p, j = P.CSR.from_dense(d), J.CSR.from_dense(d)
    _assert_same_csr(p, j, exact=True)
    assert np.array_equal(p.todense().numpy(), np.asarray(j.todense()))
    assert np.array_equal(p.row_ids().numpy(), np.asarray(j.row_ids()))
    for hp, hj in zip(p.numpy(), _triples(j)):
        assert np.array_equal(hp, hj)


def test_todense_sums_duplicates_kept_by_from_coo():
    p = P.CSR.from_coo_arrays((2, 2), [0, 0, 1], [1, 1, 0],
                              np.array([1, 2, 3], np.int32),
                              sum_duplicates=False)
    j = J.CSR.from_coo_arrays((2, 2), [0, 0, 1], [1, 1, 0],
                              np.array([1, 2, 3], np.int32),
                              sum_duplicates=False)
    assert p.stored == 3
    assert np.array_equal(p.todense().numpy(), np.asarray(j.todense()))


def test_compacted_matches_jax():
    r, c, v = _coo(4, 20, 20, 200, np.float32)
    p = P.CSR.from_coo_arrays((20, 20), r, c, v, sum_duplicates=False,
                              drop_zeros=False).compacted()
    j = J.CSR.from_coo_arrays((20, 20), r, c, v, sum_duplicates=False,
                              drop_zeros=False).compacted()
    _assert_same_csr(p, j)


@pytest.mark.parametrize("n,value", [(1, 1.0), (6, 2.5), (0, 1.0)])
def test_eye_matches_jax(n, value):
    p, j = P.CSR.eye((n, n), value), J.CSR.eye((n, n), value)
    _assert_same_csr(p, j, exact=True)


def test_empty_matches_jax():
    p, j = P.CSR.empty((4, 7)), J.CSR.empty((4, 7))
    _assert_same_csr(p, j, exact=True)
    assert np.array_equal(p.todense().numpy(), np.asarray(j.todense()))


@pytest.mark.parametrize("rows,cols", [(-1, 0), (3, 0), (0, 4), (0, -2)])
def test_out_of_bounds_coo_raises(rows, cols):
    for pkg in (P, J):
        with pytest.raises(pkg.OutOfBounds):
            pkg.CSR.from_coo_arrays((3, 4), [0, rows], [1, cols],
                                    np.ones(2, np.float32))


def test_coo_builder_matches_jax_and_raises():
    from basic_sparse_matrix_tpu.ops import COO as JCOO

    rng = np.random.default_rng(5)
    pc, jc = P.COO((10, 12)), JCOO((10, 12))
    for r, c, v in zip(rng.integers(0, 10, 30), rng.integers(0, 12, 30),
                       rng.standard_normal(30)):
        pc.insert((int(r), int(c), float(v)))
        jc.insert((int(r), int(c), float(v)))
    rows, cols = rng.integers(0, 10, 50), rng.integers(0, 12, 50)
    vals = rng.standard_normal(50)
    pc.insert_many(rows, cols, vals)
    jc.insert_many(rows, cols, vals)
    assert len(pc) == len(jc) == 80
    _assert_same_csr(pc.to_csr(), jc.to_csr())
    with pytest.raises(P.OutOfBounds):
        pc.insert((10, 0, 1.0))
    with pytest.raises(P.OutOfBounds):
        pc.insert_many([0], [12], [1.0])


def test_incorrect_dimensions_raise():
    with pytest.raises(P.IncorrectDimensions):
        P.CSR.from_dense(np.zeros(4, np.float32))
    with pytest.raises(P.IncorrectDimensions):
        P.CSR.eye((2, 3))
    with pytest.raises(P.IncorrectDimensions):
        P.CSR.empty((1 << 16, 1 << 16)).todense()
    with pytest.raises(P.IncorrectDimensions):
        P.Dense(np.zeros(3))


def test_error_family_names_match_jax():
    from basic_sparse_matrix_tpu.utils import errors as je
    from basic_sparse_matrix_tpu_torch.utils import errors as pe

    names = ["MatErr", "MatrixFinalised", "MatrixNotFinalised",
             "NonSquareMatrix", "IncorrectDimensions",
             "PaddingSizeSmallerThanOriginal", "OutOfBounds"]
    for name in names:
        assert hasattr(je, name) and issubclass(getattr(pe, name), pe.MatErr)
    with pytest.raises(pe.NonSquareMatrix, match="why"):
        pe.check(False, pe.NonSquareMatrix, "why")


def test_matdim_matches_jax():
    from basic_sparse_matrix_tpu.utils import MatDim as JM

    d = P.MatDim.of((3, 5))
    assert d.as_tuple() == JM.of((3, 5)).as_tuple()
    assert str(d) == str(JM.of((3, 5)))
    assert d.transpose() == P.MatDim(5, 3) and d.size == 15


def test_dense_from_data_column_convention():
    from basic_sparse_matrix_tpu.ops import Dense as JDense

    cols = [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]
    p, j = P.Dense.from_data(cols), JDense.from_data(cols)
    assert np.array_equal(p.array.numpy(), np.asarray(j.array))
    assert p.dims == P.MatDim(3, 2)
    assert p == np.asarray(j.array)
    assert p.set_col(0, [0.0, 0.0, 0.0]).get_col(0).tolist() == [0, 0, 0]
    assert p.get_col(0).tolist() == [1.0, 2.0, 3.0]
    z = P.Dense.new_default_with_dims(2, 3)
    assert tuple(z.array.shape) == (3, 2) and P.DenseS is P.Dense


def test_csr_from_numpy_carries_jax_state():
    r, c, v = _coo(6, 25, 25, 120, np.float32)
    j = J.CSR.from_coo_arrays((25, 25), r, c, v)
    p = pi.csr_from_numpy(*j.numpy(), j.shape)
    _assert_same_csr(p, j, exact=True)
    with pytest.raises(P.IncorrectDimensions):
        pi.csr_from_numpy(*j.numpy(), (24, 25))


def test_scipy_roundtrip():
    pytest.importorskip("scipy")
    r, c, v = _coo(7, 15, 9, 60, np.float32)
    p = P.CSR.from_coo_arrays((15, 9), r, c, v)
    back = pi.from_scipy(pi.to_scipy(p))
    _assert_same_csr(back, J.CSR.from_coo_arrays((15, 9), r, c, v),
                     exact=True)


def test_matmul_operator_matches_jax():
    # The JAX package's ``CSR.__matmul__`` reaches ``ops.spmm`` through the
    # package attribute, which ``ops/__init__`` rebinds to the function, so
    # ``j @ b`` raises there; the port is held to the functions it names.
    from basic_sparse_matrix_tpu.ops.spmm import spmm as jspmm, spmv as jspmv

    rng = np.random.default_rng(8)
    d = ((rng.random((12, 10)) < 0.3) * rng.standard_normal((12, 10))
         ).astype(np.float32)
    b = rng.standard_normal((10, 3)).astype(np.float32)
    p, j = P.CSR.from_dense(d), J.CSR.from_dense(d)
    np.testing.assert_allclose((p @ torch.from_numpy(b)).numpy(),
                               np.asarray(jspmm(j, b)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((p @ b[:, 0]).numpy(),
                               np.asarray(jspmv(j, b[:, 0])), rtol=1e-5,
                               atol=1e-6)


def test_host_mirror_is_not_aliased():
    p = P.CSR.from_dense(np.eye(3, dtype=np.float32))
    p.values.mul_(2.0)
    assert p.numpy()[2].tolist() == [1.0, 1.0, 1.0]
