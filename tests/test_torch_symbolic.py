"""Host symbolic analysis, orderings and transpose of the PyTorch port against
the JAX package on the CPU: the same seeded patterns through both, integer
results compared exactly (``np.array_equal``), values of the transpose
exactly (a transpose moves values, it does not compute them). The port's
numpy fallbacks are held against its native library the same way.
"""

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.ops import reorder as jr
from basic_sparse_matrix_tpu.runtime import symbolic as js
from basic_sparse_matrix_tpu_torch.ops import reorder as pr
from basic_sparse_matrix_tpu_torch.runtime import symbolic as ps

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _lap(k, dim):
    """The (2·dim+1)-point Laplacian on a k^dim grid as COO arrays."""
    n = k ** dim
    idx = np.arange(n).reshape((k,) * dim)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 2.0 * dim)]
    for ax in range(dim):
        a = np.take(idx, range(k - 1), axis=ax).ravel()
        b = np.take(idx, range(1, k), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    return (n, np.concatenate(r), np.concatenate(c),
            np.concatenate(v).astype(np.float32))


def _random_spd_pattern(seed, n, per_row):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, n * per_row)
    c = rng.integers(0, n, n * per_row)
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([np.full(2 * r.size, -0.1),
                           np.full(n, float(per_row) + 1)]).astype(np.float32)
    return n, rows, cols, vals


_MATRICES = {
    "lap2d_9": lambda: _lap(9, 2),
    "lap3d_6": lambda: _lap(6, 3),
    "random_300": lambda: _random_spd_pattern(1, 300, 3),
    "random_disconnected": lambda: _random_spd_pattern(2, 200, 0),
}


def _pair(name):
    n, r, c, v = _MATRICES[name]()
    return (J.CSR.from_coo_arrays((n, n), r, c, v),
            P.CSR.from_coo_arrays((n, n), r, c, v))


def _lower(a):
    indptr, indices, _ = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    low = indices < rows
    lp = np.zeros(a.rows + 1, dtype=np.int64)
    np.add.at(lp[1:], rows[low], 1)
    return np.cumsum(lp), indices[low]


def _eq(x, y):
    assert len(x) == len(y)
    for a, b in zip(x, y):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", list(_MATRICES))
def test_symbolic_matches_jax(name):
    ja, pa = _pair(name)
    n = ja.rows
    lp, li = _lower(pa)
    _eq(ps.chol_symbolic(n, lp, li), js.chol_symbolic(n, lp, li))
    _eq(ps.chol_symbolic_csr(pa), js.chol_symbolic_csr(ja))
    parent, l_indptr, l_indices = ps.chol_symbolic(n, lp, li)
    assert np.array_equal(ps.etree(n, lp, li), js.etree(n, lp, li))
    assert np.array_equal(ps.postorder(parent), js.postorder(parent))
    _eq(ps.level_sets(n, l_indptr, l_indices),
        js.level_sets(n, l_indptr, l_indices))
    # CSC pattern and supernodes, relaxed and not, and pattern expansion.
    l_rows = np.repeat(np.arange(n), np.diff(l_indptr))
    order = np.lexsort((l_rows, l_indices))
    col_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(l_indices, minlength=n))])
    csc_rows = l_rows[order]
    for relax in (0, 2, 8):
        sid = ps.supernodes(col_ptr, csc_rows, parent, relax=relax)
        assert np.array_equal(
            sid, js.supernodes(col_ptr, csc_rows, parent, relax=relax))
        nsn = int(sid.max()) + 1
        c0 = np.searchsorted(sid, np.arange(nsn))
        c1 = np.searchsorted(sid, np.arange(nsn), side="right")
        _eq(ps.expand_pattern(n, col_ptr, csc_rows, c0, c1),
            js.expand_pattern(n, col_ptr, csc_rows, c0, c1))
    rows = np.repeat(np.arange(n), np.diff(pa.numpy()[0]))
    _eq(ps.coo_to_csr_perm(n, rows[::-1], pa.numpy()[1][::-1]),
        js.coo_to_csr_perm(n, rows[::-1], pa.numpy()[1][::-1]))
    level = ps.level_sets(n, l_indptr, l_indices)[0]
    nlev = int(level.max()) + 1
    _eq(ps.chol_update_triples(col_ptr, csc_rows, level, nlev),
        js.chol_update_triples(col_ptr, csc_rows, level, nlev))


@pytest.mark.parametrize("name", list(_MATRICES))
def test_orderings_match_jax(name):
    ja, pa = _pair(name)
    _eq(pr._sym_pattern(pa), jr._sym_pattern(ja))
    rcm = pr.rcm_permutation(pa)
    nd = pr.nd_permutation(pa)
    assert np.array_equal(rcm, jr.rcm_permutation(ja))
    assert np.array_equal(nd, jr.nd_permutation(ja))
    assert np.array_equal(pr.nd_permutation(pa, leaf=16),
                          jr.nd_permutation(ja, leaf=16))
    for perm in (None, rcm, nd):
        assert pr.chol_fill(pa, perm) == jr.chol_fill(ja, perm)
    pperm, pname = pr.best_permutation(pa)
    jperm, jname = jr.best_permutation(ja)
    assert pname == jname
    assert (pperm is None and jperm is None) or np.array_equal(pperm, jperm)
    pp, jp = pr.permute_symmetric(pa, nd), jr.permute_symmetric(ja, nd)
    _eq(pp.numpy(), [np.asarray(t) for t in jp.numpy()])
    assert pr.bandwidth(pp) == jr.bandwidth(jp)
    assert pr.bandwidth(pa) == jr.bandwidth(ja)
    x = np.random.default_rng(0).standard_normal((ja.rows, 3)).astype(
        np.float32)
    for inverse in (False, True):
        assert np.array_equal(
            pr.apply_perm(torch.as_tensor(x), nd, inverse=inverse).numpy(),
            np.asarray(jr.apply_perm(x, nd, inverse=inverse)))


@pytest.mark.parametrize("shape,density,seed", [
    ((40, 70), 0.1, 0), ((70, 40), 0.2, 1), ((1, 9), 1.0, 2),
    ((30, 30), 0.0, 3),
])
def test_transpose_matches_jax(shape, density, seed):
    rng = np.random.default_rng(seed)
    d = ((rng.random(shape) < density)
         * rng.standard_normal(shape)).astype(np.float32)
    pt = P.CSR.from_dense(d).transpose()
    jt = J.CSR.from_dense(d).transpose()
    assert (pt.rows, pt.cols) == (jt.rows, jt.cols)
    for p_, j_ in zip((pt.indptr, pt.indices, pt.values),
                      (jt.indptr, jt.indices, jt.values)):
        assert np.array_equal(p_.numpy(), np.asarray(j_))
        assert p_.numpy().dtype == np.asarray(j_).dtype
    assert np.array_equal(P.CSR.from_dense(d).T.todense().numpy(), d.T)
    assert np.array_equal(P.transpose(P.CSR.from_dense(d)).todense().numpy(),
                          d.T)


@pytest.mark.parametrize("name", ["lap2d_9", "random_300"])
def test_numpy_fallbacks_match_native(name, monkeypatch):
    """With the native library absent, every function's numpy fallback
    gives the native result."""
    _, pa = _pair(name)
    assert ps.native_lib() is not None, ps.NATIVE_ERROR
    n = pa.rows
    lp, li = _lower(pa)
    sp, sc = pr._sym_pattern(pa)

    def run():
        parent, l_indptr, l_indices = ps.chol_symbolic(n, lp, li)
        l_rows = np.repeat(np.arange(n), np.diff(l_indptr))
        order = np.lexsort((l_rows, l_indices))
        col_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(l_indices, minlength=n))])
        csc_rows = l_rows[order]
        sid = ps.supernodes(col_ptr, csc_rows, parent, relax=4)
        nsn = int(sid.max()) + 1
        c0 = np.searchsorted(sid, np.arange(nsn))
        c1 = np.searchsorted(sid, np.arange(nsn), side="right")
        return (parent, l_indptr, l_indices, ps.postorder(parent),
                *ps.level_sets(n, l_indptr, l_indices)[:1], sid,
                *ps.expand_pattern(n, col_ptr, csc_rows, c0, c1),
                ps.rcm_ordering(n, sp, sc), ps.nd_ordering(n, sp, sc))

    native = run()
    monkeypatch.setattr(ps, "native_lib", lambda: None)
    fallback = run()
    for a, b in zip(native[:-2], fallback[:-2]):
        assert np.array_equal(a, b)
    # RCM's fallback breaks degree ties its own way (as in the JAX
    # package); both must be permutations. ND's fallback mirrors the
    # native code exactly.
    assert np.array_equal(np.sort(fallback[-2]), np.arange(n))
    assert np.array_equal(native[-1], fallback[-1])


def test_native_library_builds_into_the_build_dir():
    lib = ps.native_lib()
    assert lib is not None, ps.NATIVE_ERROR
    assert ps._library_path().parent == ps.BUILD_DIR
    assert ps._library_path().exists()
