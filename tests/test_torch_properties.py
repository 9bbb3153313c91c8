"""Property tests of the PyTorch port, the counterpart of
``tests/test_properties.py``: the same six tests on the same ``CASES``
(random matrices across shapes and densities from ``scipy.sparse.random``),
each result held against the scipy/numpy oracle with that file's
tolerances and against the JAX package on the same matrices (float32 on
both sides: ``rtol=1e-5``, ``atol=1e-5``; exact for patterns and counts).
"""

import numpy as np
import pytest
import torch

scipy_sparse = pytest.importorskip("scipy.sparse")

import basic_sparse_matrix_tpu.ops as J
import basic_sparse_matrix_tpu_torch.ops as P
from basic_sparse_matrix_tpu.ops.interop import from_scipy as j_from_scipy
from basic_sparse_matrix_tpu_torch.ops.interop import from_scipy as p_from_scipy
from basic_sparse_matrix_tpu_torch.utils.config import use_device

torch.set_num_threads(1)

CASES = [
    # (seed, rows, cols, density)
    (0, 1, 1, 1.0),
    (1, 1, 17, 0.4),
    (2, 23, 1, 0.4),
    (3, 40, 40, 0.05),
    (4, 64, 32, 0.2),
    (5, 13, 57, 0.5),
    (6, 100, 100, 0.01),
    (7, 9, 9, 0.0),
]


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    with use_device("cpu"):
        yield


def _rand(seed, rows, cols, density):
    """The same scipy matrix in both packages: (port, JAX, scipy)."""
    s = scipy_sparse.random(rows, cols, density=density, format="csr",
                            random_state=seed, dtype=np.float64)
    s = s.astype(np.float32)
    return p_from_scipy(s), j_from_scipy(s), s


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _agree(port, jax_value):
    np.testing.assert_allclose(_np(port), _np(jax_value), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed,rows,cols,density", CASES)
def test_roundtrip_and_transpose(seed, rows, cols, density):
    a, ja, s = _rand(seed, rows, cols, density)
    assert np.allclose(_np(a.todense()), s.toarray(), rtol=1e-6)
    t = P.transpose(a)
    assert np.allclose(_np(t.todense()), s.T.toarray(), rtol=1e-6)
    _agree(t.todense(), J.transpose(ja).todense())


@pytest.mark.parametrize("seed,rows,cols,density", CASES)
def test_add_sub_scalar(seed, rows, cols, density):
    a, ja, s1 = _rand(seed, rows, cols, density)
    b, jb, s2 = _rand(seed + 100, rows, cols, density)
    for fn, want in (("add_sparse", s1 + s2), ("sub_sparse", s1 - s2)):
        got = getattr(P, fn)(a, b).todense()
        assert np.allclose(_np(got), want.toarray(), rtol=1e-5, atol=1e-6)
        _agree(got, getattr(J, fn)(ja, jb).todense())
    got = P.mul_scalar(a, 2.5).todense()
    assert np.allclose(_np(got), (s1 * 2.5).toarray(), rtol=1e-6)
    _agree(got, J.mul_scalar(ja, 2.5).todense())
    total = float(P.sum_elements(a))
    assert np.isclose(total, s1.sum(), rtol=1e-4, atol=1e-4)
    assert np.isclose(total, float(J.sum_elements(ja)), rtol=1e-5,
                      atol=1e-5)


@pytest.mark.parametrize("seed,rows,cols,density", CASES)
def test_spmm_spmv(seed, rows, cols, density):
    a, ja, s = _rand(seed, rows, cols, density)
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((cols, 5)).astype(np.float32)
    v = rng.standard_normal(cols).astype(np.float32)
    got = P.mul_dense(a, torch.as_tensor(d))
    assert np.allclose(_np(got), s @ d, rtol=1e-4, atol=1e-4)
    _agree(got, J.mul_dense(ja, d))
    got = P.mul_vector(a, torch.as_tensor(v))
    assert np.allclose(_np(got), s @ v, rtol=1e-4, atol=1e-4)
    _agree(got, J.mul_vector(ja, v))


@pytest.mark.parametrize("seed,rows,cols,density", CASES[:6])
def test_spgemm(seed, rows, cols, density):
    a, ja, s1 = _rand(seed, rows, cols, density)
    b, jb, s2 = _rand(seed + 200, cols, max(rows // 2, 1), density)
    got = P.mul_sparse(a, b).todense()
    assert np.allclose(_np(got), (s1 @ s2).toarray(), rtol=1e-4, atol=1e-4)
    _agree(got, J.mul_sparse(ja, jb).todense())


@pytest.mark.parametrize("seed,rows,cols,density", CASES[3:6])
def test_spmm_to_csr_nnz_semantics(seed, rows, cols, density):
    # reference quirk: CSR-shaped SpMM result drops exact zeros
    a, ja, s = _rand(seed, rows, cols, density)
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 3, (cols, 4)).astype(np.float32)
    out = P.spmm_to_csr(a, torch.as_tensor(d))
    dense = _np(out.todense())
    assert out.get_nnz() == int(np.count_nonzero(dense))
    jout = J.spmm_to_csr(ja, d)
    assert out.get_nnz() == jout.get_nnz()
    _agree(dense, jout.todense())


def test_accessors_match_scipy():
    a, ja, s = _rand(11, 30, 40, 0.2)
    dense = s.toarray()
    for i in (0, 7, 29):
        assert np.allclose(_np(a.get_row_complete(i)), dense[i], rtol=1e-6)
        _agree(a.get_row_complete(i), ja.get_row_complete(i))
    for j in (0, 15, 39):
        assert np.allclose(_np(a.get_col_complete(j)), dense[:, j],
                           rtol=1e-6)
        _agree(a.get_col_complete(j), ja.get_col_complete(j))
    sub = a.take_submatrix((3, 5), (20, 30))
    assert np.allclose(_np(sub.todense()), dense[3:20, 5:30], rtol=1e-6)
    _agree(sub.todense(), ja.take_submatrix((3, 5), (20, 30)).todense())
