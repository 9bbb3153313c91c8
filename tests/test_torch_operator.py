"""``SparseOperator`` (``models/operator.py``), the serving-path wrapper of
the PyTorch port, against the JAX package on the CPU.

Mirrors ``test_operator.py``: products ``rtol=1e-5`` with
``atol=1e-5·max|ref|`` against the JAX operator (float32 sums in another
order); direct solves ``rtol=1e-4`` with ``atol=1e-5·max|ref|`` (two
float32 factorizations); CG, Chebyshev and Lanczos through the cached
set-ups with the JAX tests' own bounds. ``matmul_sparse`` goes through
``ops/spgemm.py`` and raises ``IncorrectDimensions`` on operands that do not
fit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.utils import config as jcfg
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return (m @ m.T + n * np.eye(n)).astype(np.float32)


def _lap3d(k):
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        a = np.take(idx, range(k - 1), axis=ax).ravel()
        b = np.take(idx, range(1, k), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    return (n, np.concatenate(r), np.concatenate(c),
            np.concatenate(v).astype(np.float32))


def _close(got, want, rtol=1e-5, atol_of_max=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * np.abs(want).max())


@pytest.fixture
def configs():
    jold, pold = jcfg.get_config(), pcfg.get_config()

    def set_both(**kw):
        jcfg.set_config(dataclasses.replace(jold, **kw))
        pcfg.set_config(dataclasses.replace(pold, **kw))
    yield set_both
    jcfg.set_config(jold)
    pcfg.set_config(pold)


def test_operator_matmul_and_solve_reuse():
    a_dense = _spd(24)
    op = P.SparseOperator(P.CSR.from_dense(a_dense))
    jop = J.SparseOperator(J.CSR.from_dense(a_dense))
    rng = np.random.default_rng(1)
    b = rng.standard_normal((24, 3)).astype(np.float32)
    _close(op @ b, jop @ b)
    _close(op.matmul(b), a_dense.astype(np.float64) @ b, rtol=1e-4)
    _close(op.matvec(b[:, 0]), np.asarray(jop.matvec(b[:, 0])))
    x1 = op.solve(b)
    cached = op._direct
    assert cached is not None and cached.kind == jop._ensure_direct().kind
    x2 = op.solve(2 * b)
    assert op._direct is cached
    _close(x1, jop.solve(b), rtol=1e-4)
    oracle = np.linalg.solve(a_dense.astype(np.float64), b)
    _close(x1, oracle, rtol=1e-3, atol_of_max=1e-3)
    _close(x2, 2 * oracle, rtol=1e-3, atol_of_max=1e-3)


def test_operator_solve_flagship_shape_default_config(configs):
    """The 7³ Laplacian under the default ordering ("auto"): both packages
    pick the same permutation and tier and agree on the solution."""
    configs()
    n, r, c, v = _lap3d(7)
    op = P.SparseOperator(P.CSR.from_coo_arrays((n, n), r, c, v))
    jop = J.SparseOperator(J.CSR.from_coo_arrays((n, n), r, c, v))
    b = np.random.default_rng(2).standard_normal((n, 2)).astype(np.float32)
    got = op.solve(b)
    assert op._direct.kind == jop._ensure_direct().kind
    assert np.array_equal(op._direct.perm, jop._direct.perm)
    _close(got, jop.solve(b), rtol=1e-4)


def test_operator_cg():
    a_dense = _spd(30, seed=2)
    op = P.SparseOperator(P.CSR.from_dense(a_dense))
    jop = J.SparseOperator(J.CSR.from_dense(a_dense))
    b = np.random.default_rng(3).standard_normal(30).astype(np.float32)
    x, iters, res = op.solve_cg(b, tol=1e-8)
    jx, jiters, _ = jop.solve_cg(b, tol=1e-8)
    assert res < 1e-6
    assert abs(iters - jiters) <= 1
    np.testing.assert_allclose(a_dense @ x.numpy(), b, rtol=1e-3, atol=1e-3)
    setup = op._pcg
    op.solve_cg(2 * b)
    assert op._pcg is setup


def test_operator_spectral_methods():
    rng = np.random.default_rng(7)
    m = rng.normal(size=(48, 48)).astype(np.float32)
    spd = (m @ m.T + 48 * np.eye(48)).astype(np.float32)
    op = P.SparseOperator(P.CSR.from_dense(spd))
    ritz = op.eigen_values(k=48).numpy()
    true = np.linalg.eigvalsh(spd.astype(np.float64))
    np.testing.assert_allclose(ritz[-1], true[-1], rtol=1e-3)
    np.testing.assert_allclose(ritz, true, rtol=1e-3,
                               atol=1e-4 * true[-1])
    assert op.condition_estimate(k=48) == pytest.approx(np.linalg.cond(spd),
                                                        rel=0.05)
    assert op._lanczos is not None


def test_operator_chebyshev():
    a_dense = _spd(30, seed=5)
    op = P.SparseOperator(P.CSR.from_dense(a_dense))
    b = np.random.default_rng(6).standard_normal(30).astype(np.float32)
    x, res = op.solve_chebyshev(b, iters=200)
    np.testing.assert_allclose(a_dense @ x.numpy(), b, rtol=1e-3, atol=1e-3)
    setup = op._lanczos
    assert setup is not None
    op.solve_chebyshev(2 * b, iters=50)
    assert op._lanczos is setup


def test_operator_matmul_sparse_raises():
    """``matmul_sparse`` has the product (it raised ``NotImplementedError``
    until ``ops/spgemm.py`` was ported); what it raises now is the
    inner-dimension error, as the JAX operator does."""
    a_dense = _spd(8, seed=7)
    op = P.SparseOperator(P.CSR.from_dense(a_dense))
    jop = J.SparseOperator(J.CSR.from_dense(a_dense))
    pc = op.matmul_sparse(P.CSR.from_dense(a_dense))
    jc = jop.matmul_sparse(J.CSR.from_dense(a_dense))
    assert np.array_equal(pc.indptr.numpy(), np.asarray(jc.indptr))
    assert np.array_equal(pc.indices.numpy(), np.asarray(jc.indices))
    np.testing.assert_allclose(pc.values.numpy(), np.asarray(jc.values),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(jc.todense()), a_dense @ a_dense,
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(P.IncorrectDimensions, match="mul_sparse"):
        op.matmul_sparse(P.CSR.from_dense(a_dense[:5]))
    with pytest.raises(J.IncorrectDimensions, match="mul_sparse"):
        jop.matmul_sparse(J.CSR.from_dense(a_dense[:5]))


def test_exports_match_jax():
    """Every name the JAX ``models`` exports, and every ``models`` name the
    JAX package root exports, exists in the port."""
    import basic_sparse_matrix_tpu.models as jm
    import basic_sparse_matrix_tpu_torch.models as pm

    assert set(jm.__all__) <= set(pm.__all__)
    for name in jm.__all__:
        assert hasattr(pm, name), name
        if hasattr(J, name):
            assert hasattr(P, name), name
