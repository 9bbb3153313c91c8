"""QR, TSQR and eigenvalues (``models/qr.py``) of the PyTorch port against
the JAX package on the CPU.

Householder sign conventions may differ between LAPACK drivers, so QR is
compared by what does not depend on them: ``‖A − QR‖/‖A‖`` and
``‖QᵀQ − I‖`` (both ≤ 1e-5 at these sizes, float32), R upper triangular,
and ``|diag R|`` against the JAX package's (``rtol=1e-4``: it passes
through a float32 factorization). ``qr_decomp``'s re-sparsified pattern
may differ at round-off-sized entries, so it is compared densified.
Eigenvalues: the reference goldens (``rtol=1e-3``, the JAX test's bound
after 50 unshifted iterations) and the JAX values (``rtol=1e-4``).
"""

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.models import qr as jqr
from basic_sparse_matrix_tpu_torch.models import qr as pqr

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield

_M = [[12.0, -51.0, 4.0], [6.0, 167.0, -68.0], [-4.0, 24.0, -41.0]]


def _check_qr(q, r, a, tol=1e-5):
    q, r = np.asarray(q, np.float64), np.asarray(r, np.float64)
    a = np.asarray(a, np.float64)
    m, n = a.shape
    assert q.shape == (m, min(m, n)) and r.shape == (min(m, n), n)
    assert np.abs(np.tril(r, -1)).max(initial=0) == 0.0
    assert np.linalg.norm(a - q @ r) / np.linalg.norm(a) <= tol
    assert np.abs(q.T @ q - np.eye(q.shape[1])).max() <= 10 * tol


def test_qr_decomp_reference_golden():
    # sparse.rs:1369-1381: ‖A − QR‖₂ < 0.1 (residual only)
    q, r = P.qr_decomp(P.CSR.from_dense(_M))
    qd, rd = q.todense().numpy(), r.todense().numpy()
    assert np.linalg.norm(np.asarray(_M) - qd @ rd, 2) < 0.1
    _check_qr(qd, rd, _M)
    jq, jr = J.qr_decomp(J.CSR.from_dense(_M))
    np.testing.assert_allclose(np.abs(np.diag(rd)),
                               np.abs(np.diag(np.asarray(jr.todense()))),
                               rtol=1e-4)


@pytest.mark.parametrize("shape,density", [((30, 30), 0.3), ((40, 12), 0.5),
                                           ((12, 20), 0.5)])
def test_qr_dense_matches_jax(shape, density):
    rng = np.random.default_rng(shape[0])
    a = ((rng.random(shape) < density)
         * rng.standard_normal(shape)).astype(np.float32)
    a[np.arange(min(shape)), np.arange(min(shape))] += 3.0
    q, r = pqr.qr_dense(torch.as_tensor(a))
    _check_qr(q.numpy(), r.numpy(), a)
    jq, jr = jqr.qr_dense(a)
    np.testing.assert_allclose(np.abs(np.diag(r.numpy())),
                               np.abs(np.diag(np.asarray(jr))), rtol=1e-4)
    # qr_decomp through CSR: same product, densified
    pq, pr = P.qr_decomp(P.CSR.from_dense(a))
    _check_qr(pq.todense().numpy(), pr.todense().numpy(), a)


@pytest.mark.parametrize("m,n,br", [(1000, 16, 128), (513, 8, 64),
                                    (96, 12, 100), (2048, 64, 256),
                                    (64, 64, 1024)])
def test_tsqr_matches_jax(m, n, br):
    """Block counts 8 (pow2), 9 → 16, 1, 8; and a square single block."""
    a = np.random.default_rng(3 + m).standard_normal((m, n)).astype(
        np.float32)
    q, r = pqr.tsqr(a, block_rows=br)
    _check_qr(q.numpy(), r.numpy(), a)
    jq, jr = jqr.tsqr(a, block_rows=br)
    np.testing.assert_allclose(np.abs(np.diag(r.numpy())),
                               np.abs(np.diag(np.asarray(jr))), rtol=1e-4)


def test_tsqr_input_forms_and_tall_routing(monkeypatch):
    """A CSR, a tensor and numpy go through tsqr alike; rows < cols
    raises; qr_decomp routes an operand with rows >= TSQR_MIN_ASPECT·cols
    through TSQR (threshold lowered here, as both packages read it the same
    way)."""
    rng = np.random.default_rng(4)
    d = ((rng.random((400, 20)) < 0.2)
         * rng.standard_normal((400, 20))).astype(np.float32)
    for x in (P.CSR.from_dense(d), torch.as_tensor(d), d):
        q, r = pqr.tsqr(x, block_rows=64)
        _check_qr(q.numpy(), r.numpy(), d)
    with pytest.raises(P.IncorrectDimensions):
        pqr.tsqr(d.T)
    calls = []
    real = pqr.tsqr_dense
    monkeypatch.setattr(pqr, "TSQR_MIN_ASPECT", 4)
    monkeypatch.setattr(pqr, "tsqr_dense",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q, r = P.qr_decomp(P.CSR.from_dense(d))
    assert calls
    _check_qr(q.todense().numpy(), r.todense().numpy(), d, tol=1e-4)


def test_densify_budget(monkeypatch):
    import dataclasses

    from basic_sparse_matrix_tpu_torch.utils import config as pcfg

    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, dense_dispatch_max_bytes=16))
    try:
        a = P.CSR.from_dense(np.eye(3, dtype=np.float32))
        for f in (P.qr_decomp, P.eigen_values_sym,
                  lambda x: P.eigen_values(x, 2)):
            with pytest.raises(P.IncorrectDimensions):
                f(a)
    finally:
        pcfg.set_config(old)


def test_eigen_values_reference_golden():
    # sparse.rs:1424-1441: [-34.196675, 16.05999094, 156.13668406]
    got = np.sort(P.eigen_values(P.CSR.from_dense(_M), 50).numpy())
    np.testing.assert_allclose(
        got, np.sort([-34.196675, 16.05999094, 156.13668406]), rtol=1e-3)
    want = np.sort(np.asarray(J.eigen_values(J.CSR.from_dense(_M), 50)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    with pytest.raises(P.NonSquareMatrix):
        P.eigen_values(P.CSR.from_dense(np.ones((2, 3), np.float32)), 3)


def test_eigen_values_sym_matches_jax():
    rng = np.random.default_rng(6)
    m = rng.standard_normal((20, 20)).astype(np.float32)
    sym = (m + m.T) / 2
    got = P.eigen_values_sym(P.CSR.from_dense(sym)).numpy()
    want = np.asarray(J.eigen_values_sym(J.CSR.from_dense(sym)))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, np.linalg.eigvalsh(sym.astype(np.float64)),
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())
    # symmetrised input, as jnp.linalg.eigvalsh: an asymmetric matrix
    got = pqr.eigen_values_sym_dense(torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jqr.eigen_values_sym_dense(m)),
                               rtol=1e-4, atol=1e-5 * np.abs(got).max())
