"""The iterative and spectral solvers of the PyTorch port against the JAX
package on the CPU: IC(0)-PCG (``models/pcg.py``), Lanczos
(``models/lanczos.py``) and Chebyshev (``models/chebyshev.py``).

Mirrors ``test_pcg.py``, ``test_lanczos.py`` (the breakdown case
included) and ``test_chebyshev.py`` on the same seeded numpy inputs.
Tolerances:

* PCG: the iteration count equal to the JAX package's or one off (float32
  residuals near ``tol`` may cross it one step apart); iterates
  ``rtol=1e-4`` with ``atol=1e-5·max|ref|`` (two float32 triangular solves
  per step, compounded); the JAX IC(0) factor fed to the port's loop gives
  the same count and iterates within the same bound.
* Lanczos: the JAX package draws its start vector from ``PRNGKey(seed)``,
  which torch cannot reproduce, so both are given the same numpy ``v0``
  (``_ritz_values``); Ritz values ``rtol=1e-4`` with
  ``atol=1e-5·max|λ|`` (k steps of float32 CGS2).
* Chebyshev: iterates ``rtol=1e-4`` with ``atol=1e-5·max|ref|``.
"""

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.models import chebyshev as jch
from basic_sparse_matrix_tpu.models import lanczos as jl
from basic_sparse_matrix_tpu.models import pcg as jpcg
from basic_sparse_matrix_tpu.models import sparse_cholesky as jsc
from basic_sparse_matrix_tpu_torch.models import chebyshev as pch
from basic_sparse_matrix_tpu_torch.models import lanczos as pl
from basic_sparse_matrix_tpu_torch.models import pcg as ppcg
from basic_sparse_matrix_tpu_torch.ops import interop

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _lap2d(k):
    n = k * k
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(k):
        for j in range(k):
            r = i * k + j
            a[r, r] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < k and 0 <= jj < k:
                    a[r, ii * k + jj] = -1.0
    return a


def _close(got, want, rtol=1e-4, atol_of_max=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * np.abs(want).max())


def _both(d):
    return P.CSR.from_dense(d), J.CSR.from_dense(d)


# ---- PCG -------------------------------------------------------------------
@pytest.mark.parametrize("k,tol", [(5, 1e-6), (8, 1e-6), (10, 1e-8)])
def test_pcg_matches_jax(k, tol):
    d = _lap2d(k)
    b = np.random.default_rng(k).standard_normal(k * k).astype(np.float32)
    pa, ja = _both(d)
    x, it, res = ppcg.pcg_solve(pa, b, tol=tol, max_iters=500)
    jx, jit_, jres = jpcg.pcg_solve(ja, b, tol=tol, max_iters=500)
    assert abs(it - jit_) <= 1
    assert it < k * k
    if it == jit_:
        _close(x, jx)
    assert res <= max(tol, 1e-6) * 10
    np.testing.assert_allclose(d @ x.numpy(), b, rtol=1e-3, atol=1e-3)


def test_pcg_with_the_jax_ic0_factor():
    d = _lap2d(8)
    b = np.random.default_rng(2).standard_normal(64).astype(np.float32)
    pa, ja = _both(d)
    js = jsc.analyze(ja, incomplete=True)
    jlf = jsc.csc_to_csr_l(js, np.asarray(jsc.factorize(js, ja.values)))
    setup = interop.pcg_setup_from_numpy(pa, *jlf.numpy())
    own = ppcg.PCGSetup.build(pa)
    r = torch.as_tensor(b)
    _close(setup.apply_m_inv(r), own.apply_m_inv(r), rtol=1e-5)
    x, it, _ = ppcg.pcg_solve(pa, b, setup=setup)
    jx, jit_, _ = jpcg.pcg_solve(ja, b)
    assert abs(it - jit_) <= 1
    if it == jit_:
        _close(x, jx)


def test_pcg_setup_reuse_and_iterations():
    """The set-up is reused; IC(0) beats a diagonal preconditioner."""
    d = _lap2d(10)
    a = P.CSR.from_dense(d)
    setup = ppcg.PCGSetup.build(a)
    assert setup.ell is not None
    rng = np.random.default_rng(1)
    for _ in range(2):
        b = rng.standard_normal(100).astype(np.float32)
        x, _, res = ppcg.pcg_solve(a, b, setup=setup)
        assert res < 1e-5
        np.testing.assert_allclose(d @ x.numpy(), b, rtol=1e-3, atol=1e-3)
    diag = ppcg.PCGSetup.build(P.CSR.from_dense(np.diag(np.diag(d))))
    jacobi = ppcg.PCGSetup(a=a, fwd=diag.fwd, bwd=diag.bwd)
    _, it_ic, _ = ppcg.pcg_solve(a, b, tol=1e-8, max_iters=2000)
    _, it_j, _ = ppcg.pcg_solve(a, b, tol=1e-8, max_iters=2000,
                                setup=jacobi)
    assert it_ic <= it_j


def test_pcg_max_iters_and_non_square():
    d = _lap2d(6)
    b = np.ones(36, np.float32)
    x, it, res = ppcg.pcg_solve(P.CSR.from_dense(d), b, tol=1e-12,
                                max_iters=2)
    jx, jit_, jres = jpcg.pcg_solve(J.CSR.from_dense(d), b, tol=1e-12,
                                    max_iters=2)
    assert it == jit_ == 2
    _close(x, jx)
    np.testing.assert_allclose(res, jres, rtol=1e-4)
    with pytest.raises(P.NonSquareMatrix):
        ppcg.PCGSetup.build(P.CSR.from_dense(np.ones((2, 3), np.float32)))


# ---- Lanczos ---------------------------------------------------------------
@pytest.mark.parametrize("which,k", [("lap", 16), ("sym", 10), ("sym", 24),
                                     ("diag", 4)])
def test_ritz_values_match_jax(which, k):
    """k < n on operands whose leading Ritz values are well separated (a
    grid Laplacian's repeated interior eigenvalues make deeper runs depend
    on round-off), and k = n, the whole spectrum."""
    rng = np.random.default_rng(k)
    if which == "lap":
        d = _lap2d(7)
    elif which == "sym":
        m = rng.normal(size=(24, 24)).astype(np.float32)
        d = (m + m.T) / 2
    else:
        d = np.diag(np.array([1.0, 3.0, 7.0, 10.0], np.float32))
    v0 = rng.standard_normal(d.shape[0]).astype(np.float32)
    pa, ja = _both(d)
    got = pl._ritz_values(pl.LanczosSetup.build(pa), torch.as_tensor(v0), k)
    want = np.asarray(jl._ritz_values(jl.LanczosSetup.build(ja), v0, k))
    _close(got, want)
    if k == d.shape[0]:
        _close(got, np.linalg.eigvalsh(d.astype(np.float64)), rtol=1e-4,
               atol_of_max=5e-4)


def test_lanczos_scan_basis_and_tridiagonal_match_jax():
    d = _lap2d(6)
    v0 = np.random.default_rng(0).standard_normal(36).astype(np.float32)
    pa, ja = _both(d)
    a, b, V = pl._lanczos_scan(pl.LanczosSetup.build(pa),
                               torch.as_tensor(v0), 12)
    ja_, jb_, jV = jl._lanczos_scan(jl.LanczosSetup.build(ja), v0, 12)
    _close(a, ja_)
    _close(b, jb_)
    _close(V, jV, atol_of_max=1e-4)
    vv = V.numpy() @ V.numpy().T
    np.testing.assert_allclose(vv, np.eye(12), atol=1e-5)


def test_breakdown_restart_matches_jax():
    """A start vector on a small invariant subspace (an identity block plus
    9 and 5): Lanczos breaks down, restarts from the deterministic sin
    vector, and resolves the rest; the same as the JAX package."""
    d = np.ones(16, np.float32)
    d[0], d[1] = 9.0, 5.0
    a = np.diag(d)
    v0 = np.random.default_rng(3).standard_normal(16).astype(np.float32)
    pa, ja = _both(a)
    ps = pl.LanczosSetup.build(pa)
    _, betas, _ = pl._lanczos_scan(ps, torch.as_tensor(v0), 8)
    assert (betas.numpy() == 0).any()
    got = pl._ritz_values(ps, torch.as_tensor(v0), 8)
    want = np.asarray(jl._ritz_values(jl.LanczosSetup.build(ja), v0, 8))
    _close(got, want)
    ritz = P.models.eigen_values_lanczos(pa, k=8, seed=3).numpy()
    assert abs(ritz[-1] - 9.0) < 1e-3 and abs(ritz.min() - 1.0) < 1e-3


def test_lanczos_entry_points():
    d = _lap2d(12)
    pa = P.CSR.from_dense(d)
    true = np.linalg.eigvalsh(d.astype(np.float64))
    lo, hi = pl.extremal_eigen_values(pa, k=64)
    assert abs(hi - true[-1]) <= 1e-3 * true[-1]
    assert abs(lo - true[0]) <= 1e-2 * true[0] + 1e-4
    assert pl.condition_estimate(pa, k=96) == pytest.approx(
        true[-1] / true[0], rel=0.05)
    # seeded start vector: the same answer twice, with or without a setup
    setup = pl.LanczosSetup.build(pa)
    r1 = pl.eigen_values_lanczos(pa, k=16, setup=setup, seed=5)
    assert torch.equal(r1, pl.eigen_values_lanczos(pa, k=16, seed=5))
    small = P.CSR.from_dense(np.diag(np.array([2.0, 5.0], np.float32)))
    np.testing.assert_allclose(
        np.sort(pl.eigen_values_lanczos(small, k=50).numpy()), [2.0, 5.0],
        atol=1e-5)
    assert pl.condition_estimate(P.CSR.from_dense(
        np.diag(np.array([-1.0, 2.0, 3.0], np.float32))), k=3) == float("inf")
    with pytest.raises(P.NonSquareMatrix):
        pl.eigen_values_lanczos(P.CSR.from_coo_arrays(
            (2, 3), np.array([0]), np.array([1]), np.array([1.0], np.float32)),
            k=2)


# ---- Chebyshev ---------------------------------------------------------------
@pytest.mark.parametrize("k,iters", [(10, 150), (12, 200)])
def test_chebyshev_matches_jax(k, iters):
    d = _lap2d(k)
    ev = np.linalg.eigvalsh(d.astype(np.float64))
    bounds = (float(ev[0]), float(ev[-1]))
    b = np.random.default_rng(k).standard_normal(k * k).astype(np.float32)
    pa, ja = _both(d)
    x, res = pch.chebyshev_solve(pa, b, iters=iters, bounds=bounds)
    jx, jres = jch.chebyshev_solve(ja, b, iters=iters, bounds=bounds)
    _close(x, jx)
    assert res < 1e-5
    _close(x, np.linalg.solve(d.astype(np.float64), b), rtol=2e-4,
           atol_of_max=2e-4)


def test_chebyshev_lanczos_bounds():
    d = _lap2d(10)
    pa = P.CSR.from_dense(d)
    ev = np.linalg.eigvalsh(d.astype(np.float64))
    lo, hi = pch.spectral_bounds(pa, k=64)
    assert lo <= ev[0] + 1e-5 and hi >= ev[-1] - 1e-5
    b = np.random.default_rng(0).standard_normal(100).astype(np.float32)
    x, res = pch.chebyshev_solve(pa, b, iters=200, lanczos_k=64)
    assert res < 1e-5
    with pytest.raises(ValueError):
        pch.spectral_bounds(P.CSR.from_dense(
            np.diag(np.array([-2.0, 1.0, 3.0], np.float32))), k=3)
