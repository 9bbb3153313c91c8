"""The rest of the port's ``CSR`` surface against the JAX ``CSR``: accessors,
row/column views, submatrix, padding, iteration, diagonal construction,
operator sugar, display, and ``allclose``.

The goldens are those of ``test_accessors.py``, ``test_construction.py``,
``test_edge_cases.py`` and ``test_integer_dtypes.py``; on top of them the
same seeded numpy inputs go through both packages. Index arrays, host views
and integer values must match exactly; float32 values to ``rtol=1e-5``
(``allclose``'s default).
"""

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.utils.errors import (
    IncorrectDimensions,
    OutOfBounds,
    PaddingSizeSmallerThanOriginal,
)

torch.set_num_threads(1)

M_6COL = [
    [10, 20, 0, 0, 0, 0],
    [0, 30, 0, 40, 0, 0],
    [0, 0, 50, 60, 70, 0],
    [0, 0, 0, 0, 0, 80],
]
M_5COL = [
    [5, 6, 7, 8, 9],
    [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1],
    [1, 0, 0, 0, 0],
]


def _random_dense(seed, rows, cols, dtype):
    rng = np.random.default_rng(seed)
    mask = rng.random((rows, cols)) < 0.25
    if np.dtype(dtype).kind == "f":
        return (mask * rng.standard_normal((rows, cols))).astype(dtype)
    return (mask * rng.integers(1, 9, (rows, cols))).astype(dtype)


MATRICES = {
    "golden6": np.asarray(M_6COL, dtype=np.float32),
    "golden5": np.asarray(M_5COL, dtype=np.float32),
    "empty": np.zeros((3, 3), dtype=np.float32),
    "one": np.asarray([[3.0]], dtype=np.float32),
    "f32": _random_dense(1, 13, 29, np.float32),
    "i32": _random_dense(2, 17, 11, np.int32),
    "u32": _random_dense(3, 9, 9, np.uint32),
}


def _pair(name):
    d = MATRICES[name]
    return P.CSR.from_dense(d), J.CSR.from_dense(d), d


def _same_csr(p, j, exact):
    assert p.shape == j.shape
    # the JAX arrays as stored on its device (its host mirror may keep a
    # 64-bit dtype that the device array does not)
    ji, jx, jv = (np.asarray(x) for x in (j.indptr, j.indices, j.values))
    pi, px, pv = p.numpy()
    assert np.array_equal(pi, ji) and np.array_equal(px, jx)
    assert np.array_equal(p.indptr.numpy(), ji)
    assert np.array_equal(p.indices.numpy(), jx)
    assert pv.dtype == jv.dtype
    if exact:
        assert np.array_equal(pv, jv)
    else:
        np.testing.assert_allclose(pv, jv, rtol=1e-5)
    assert np.array_equal(p.values.numpy(), pv)


def _entries(es):
    return [(e.v.item(), type(e.v), e.row_index, e.col_index) for e in es]


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_row_and_column_views_match_jax(name):
    p, j, d = _pair(name)
    for r in range(d.shape[0]):
        assert _entries(p.get_row_compact(r)) == _entries(j.get_row_compact(r))
        pr, jr = p.get_row_complete(r), j.get_row_complete(r)
        assert pr.dtype == jr.dtype and np.array_equal(pr, jr)
        assert np.array_equal(pr, d[r])
    for c in range(d.shape[1]):
        assert _entries(p.get_col_compact(c)) == _entries(j.get_col_compact(c))
        pc, jc = p.get_col_complete(c), j.get_col_complete(c)
        assert pc.dtype == jc.dtype and np.array_equal(pc, jc)
        _same_csr(p.get_col(c), j.get_col(c), exact=True)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_get_val_at_iteration_and_counts_match_jax(name):
    p, j, d = _pair(name)
    for r in range(d.shape[0]):
        for c in range(d.shape[1]):
            pv, jv = p.get_val_at((r, c)), j.get_val_at((r, c))
            assert (pv is None) == (jv is None) == (d[r, c] == 0)
            if pv is not None:
                assert pv == jv == d[r, c] and type(pv) is type(jv)
    assert _entries(p) == _entries(j)
    assert isinstance(next(iter(p), P.CsrEntry(0, 0, 0)), P.CsrEntry)
    assert p.count_nonzero() == j.count_nonzero() == np.count_nonzero(d)
    assert p.get_nnz() == j.get_nnz()
    a, at = p.pair_with_transpose()
    ja, jat = j.pair_with_transpose()
    assert a is p
    _same_csr(at, jat, exact=True)


@pytest.mark.parametrize("name", ["golden6", "f32", "i32", "u32"])
def test_with_val_at_matches_jax(name):
    p, j, d = _pair(name)
    rows, cols = d.shape
    hit = tuple(int(x) for x in np.argwhere(d != 0)[len(d) // 2])
    miss = tuple(int(x) for x in np.argwhere(d == 0)[-1])
    for at, val in ((hit, 7), (miss, 5), (hit, 0)):
        _same_csr(p.with_val_at(at, val), j.with_val_at(at, val), exact=True)
    with pytest.raises(OutOfBounds):
        p.with_val_at((rows, 0), 1)
    with pytest.raises(J.OutOfBounds):
        j.with_val_at((rows, 0), 1)


@pytest.mark.parametrize("name,frm,to", [
    ("golden5", (0, 0), (3, 3)),
    ("golden5", (1, 2), (4, 5)),
    ("golden5", (0, 2), (3, 5)),
    ("f32", (2, 3), (11, 20)),
    ("i32", (0, 0), (17, 11)),
    ("u32", (4, 4), (5, 5)),
])
def test_take_submatrix_matches_jax(name, frm, to):
    p, j, d = _pair(name)
    sub = p.take_submatrix(frm, to)
    _same_csr(sub, j.take_submatrix(frm, to), exact=True)
    assert np.array_equal(sub.todense().numpy(),
                          d[frm[0]:to[0], frm[1]:to[1]])


def test_take_submatrix_goldens_and_errors():
    a = P.CSR.from_dense(M_5COL)
    assert a.take_submatrix((0, 0), (3, 3)).allclose(
        P.CSR.from_dense([[5, 6, 7], [0, 0, 0], [0, 0, 0]]))
    assert a.take_submatrix((1, 2), (4, 5)).allclose(
        P.CSR.from_dense([[0, 0, 0], [0, 0, 1], [0, 0, 0]]))
    with pytest.raises(IncorrectDimensions):
        a.take_submatrix((2, 2), (2, 4))
    with pytest.raises(OutOfBounds):
        a.take_submatrix((0, 0), (5, 5))


@pytest.mark.parametrize("name,size,at", [
    ("golden6", (9, 9), (2, 3)),
    ("f32", (13, 29), (0, 0)),
    ("i32", (40, 12), (23, 1)),
    ("u32", (10, 20), (1, 11)),
])
def test_add_padding_matches_jax(name, size, at):
    p, j, d = _pair(name)
    out = p.add_padding(size, at)
    _same_csr(out, j.add_padding(size, at), exact=True)
    ref = np.zeros(size, dtype=d.dtype)
    ref[at[0]:at[0] + d.shape[0], at[1]:at[1] + d.shape[1]] = d
    assert np.array_equal(out.todense().numpy(), ref)


def test_add_padding_golden_and_errors():
    a = P.CSR.from_dense([[1, 1, 1], [1, 0, 0], [1, 0, 0]])
    ref = P.CSR.from_dense([
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 1, 1, 1],
        [0, 0, 1, 0, 0],
        [0, 0, 1, 0, 0],
    ])
    assert a.add_padding((5, 5), (2, 2)).allclose(ref)
    b = P.CSR.from_dense([[1, 1], [1, 1]])
    with pytest.raises(PaddingSizeSmallerThanOriginal):
        b.add_padding((1, 1), (0, 0))
    with pytest.raises(IncorrectDimensions):
        b.add_padding((3, 3), (2, 2))


@pytest.mark.parametrize("contents", [
    [1, 2, 3, 4],
    [0, 1, 0, 2, 0, 3, 0],
    np.asarray([1.5, 0.0, -2.0], dtype=np.float32),
    np.asarray([3, 0, 4], dtype=np.uint32),
])
def test_create_diagonal_matches_jax(contents):
    p, j = P.CSR.create_diagonal(contents), J.CSR.create_diagonal(contents)
    _same_csr(p, j, exact=True)
    assert np.array_equal(p.todense().numpy(), np.diag(np.asarray(contents)))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_display_matches_jax(name):
    p, j, _ = _pair(name)
    assert str(p) == str(j)
    assert p.debug_str() == j.debug_str()
    assert "dtype" in repr(p) and "device" in repr(p)


def test_display_golden():
    m = P.CSR.from_dense([[4.0, 12.0], [12.0, 37.0]])
    assert "12.0" in str(m)
    dbg = m.debug_str()
    assert "col_index" in dbg and "row_index" in dbg


@pytest.mark.parametrize("rtol,atol,scale,want", [
    (1e-5, 1e-6, 1.0 + 1e-6, True),
    (1e-5, 1e-6, 1.0 + 1e-3, False),
    (1e-2, 1e-6, 1.0 + 1e-3, True),
])
def test_allclose_matches_jax(rtol, atol, scale, want):
    d = MATRICES["f32"]
    p, j = P.CSR.from_dense(d), J.CSR.from_dense(d)
    p2, j2 = P.CSR.from_dense(d * np.float32(scale)), J.CSR.from_dense(
        d * np.float32(scale))
    assert p.allclose(p2, rtol=rtol, atol=atol) is want
    assert j.allclose(j2, rtol=rtol, atol=atol) is want
    assert not p.allclose(P.CSR.from_dense(d.T))


@pytest.mark.parametrize("name", ["f32", "i32", "u32"])
def test_operator_sugar_matches_jax(name):
    p, j, d = _pair(name)
    rng = np.random.default_rng(11)
    other = (rng.random(d.shape) < 0.3) * rng.integers(1, 5, d.shape)
    other = other.astype(d.dtype)
    p2, j2 = P.CSR.from_dense(other), J.CSR.from_dense(other)
    exact = d.dtype.kind != "f"
    _same_csr(p + p2, j + j2, exact)
    if name != "u32":
        _same_csr(p - p2, j - j2, exact)
    _same_csr(p * 3, j * 3, exact)
    _same_csr(3 * p, 3 * j, exact)
    ps, js = p.sum_elements(), np.asarray(j.sum_elements())
    assert ps.numpy().dtype == js.dtype
    np.testing.assert_allclose(ps.numpy(), js, rtol=1e-5)
    np.testing.assert_allclose(p.l2_norm().numpy(),
                               np.asarray(j.l2_norm()), rtol=1e-5)
    pt, jt = P.CSR.from_dense(other.T), J.CSR.from_dense(other.T)
    # (the JAX ``CSR @ CSR`` raises AttributeError: ``ops.spgemm`` names the
    # function there, not the module; its ``spgemm`` is what ``@`` means)
    _same_csr(p @ pt, J.spgemm(j, jt), exact)


def test_large_shape_merge_get_val_at():
    # the shape's product exceeds int32 (test_edge_cases' golden)
    n = 200_000
    a = P.CSR.from_coo_arrays((n, n), [0, n - 1], [n - 1, 0], [1.0, 2.0])
    b = P.CSR.from_coo_arrays((n, n), [0, n - 1], [n - 1, 0], [3.0, 4.0])
    c = a + b
    assert c.get_val_at((0, n - 1)) == 4.0
    assert c.get_val_at((n - 1, 0)) == 6.0


def test_public_surface_covers_the_jax_csr():
    """Every public attribute of the JAX ``CSR`` exists on the port's."""
    public = {n for n in dir(J.CSR) if not n.startswith("_")}
    missing = sorted(n for n in public if not hasattr(P.CSR, n))
    assert missing == []
    for dunder in ("__iter__", "__add__", "__sub__", "__mul__", "__rmul__",
                   "__matmul__", "__str__"):
        assert getattr(P.CSR, dunder) is not getattr(object, dunder, None)
