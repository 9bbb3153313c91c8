"""The banded tiers of the PyTorch port against the JAX package on the CPU:
the block-tridiagonal scan (``models/banded.py``) and block cyclic
reduction (``models/bcr.py``).

Mirrors ``test_banded.py`` and ``test_bcr.py`` on the same seeded numpy
inputs, run through both packages. Tolerances:

* blocks (D, E) from ``band_blocks``: exact (host numpy on both sides);
* factors (L, F, every BCR level's stacks): ``rtol=1e-5`` with
  ``atol=1e-5·max|ref|`` (float32, another LAPACK/BLAS call order);
* solutions: ``rtol=1e-4`` with ``atol=1e-5·max|ref|`` (they pass
  through two float32 factorizations), and against a float64 solve with
  the JAX tests' own bounds;
* the JAX factor fed to the port's solve (``ops/interop``): ``rtol=1e-5``,
  so a factor fault and a solve fault show apart.
"""

import dataclasses

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.models import banded as jb
from basic_sparse_matrix_tpu.models import bcr as jbcr
from basic_sparse_matrix_tpu.utils import config as jcfg
from basic_sparse_matrix_tpu_torch.models import banded as pb
from basic_sparse_matrix_tpu_torch.models import bcr as pbcr
from basic_sparse_matrix_tpu_torch.ops import interop
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _banded_spd(rng, n, bw):
    a = np.zeros((n, n), dtype=np.float32)
    for d in range(1, bw + 1):
        vals = rng.standard_normal(n - d).astype(np.float32) * 0.3
        a += np.diag(vals, k=d) + np.diag(vals, k=-d)
    a += (2.0 * bw + 2.0) * np.eye(n, dtype=np.float32)
    return a


def _laplacian_2d(k):
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


def _close(got, want, rtol=1e-5, atol_of_max=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * max(np.abs(want).max(),
                                                      1e-30))


@pytest.fixture
def configs():
    """Set the same config fields in both packages; restore both after."""
    jold, pold = jcfg.get_config(), pcfg.get_config()

    def set_both(**kw):
        jcfg.set_config(dataclasses.replace(jold, **kw))
        pcfg.set_config(dataclasses.replace(pold, **kw))
    yield set_both
    jcfg.set_config(jold)
    pcfg.set_config(pold)


# ---- blocks and dispatch --------------------------------------------------
def test_bandwidth_and_block_size():
    d = _laplacian_2d(5)
    assert pb.bandwidth(P.CSR.from_dense(d)) == jb.bandwidth(
        J.CSR.from_dense(d)) == 5
    for args in ((5,), (65,), (1, 4096), (833, 35937), (1089, 35937)):
        assert pb.block_size_for(*args) == jb.block_size_for(*args)
    assert pb.block_size_for(833, 35937) == 840


@pytest.mark.parametrize("n,bw,nb", [(37, 3, 8), (8, 2, 8), (40, 7, 16)])
def test_band_blocks_exact(n, bw, nb):
    d = _banded_spd(np.random.default_rng(n), n, bw)
    pD, pE = pb.band_blocks(P.CSR.from_dense(d), nb)
    jD, jE = jb.band_blocks(J.CSR.from_dense(d), nb)
    assert np.array_equal(pD, jD) and np.array_equal(pE, jE)


def test_band_too_wide_raises():
    d = _banded_spd(np.random.default_rng(1), 32, 9)
    with pytest.raises(P.IncorrectDimensions):
        pb.band_blocks(P.CSR.from_dense(d), 8)


@pytest.mark.parametrize("kw", [dict(), dict(banded_max_block=16),
                                dict(banded_max_block=0),
                                dict(banded_min_steps=2)])
def test_banded_block_choice_matches_jax(configs, kw):
    configs(**kw)
    rng = np.random.default_rng(13)
    for d in (_banded_spd(rng, 96, 5), _laplacian_2d(12),
              (lambda m: m @ m.T + 64 * np.eye(64))(
                  rng.standard_normal((64, 64))).astype(np.float32)):
        assert pb.banded_block_choice(P.CSR.from_dense(d)) == \
            jb.banded_block_choice(J.CSR.from_dense(d))


# ---- the block scan ---------------------------------------------------------
@pytest.mark.parametrize("n,bw", [(16, 1), (37, 3), (100, 7), (130, 12)])
def test_factor_matches_jax(n, bw):
    d = _banded_spd(np.random.default_rng(n), n, bw)
    pf = pb.factor_banded(P.CSR.from_dense(d))
    jf = jb.factor_banded(J.CSR.from_dense(d))
    assert (pf.m, pf.nb, pf.n) == (jf.m, jf.nb, jf.n)
    _close(pf.L, jf.L)
    _close(pf.F, jf.F)
    pl = pb.assemble_factor_csr(pf)
    jl = jb.assemble_factor_csr(jf)
    _close(pl.todense(), jl.todense())
    _close(pl.todense(), np.linalg.cholesky(d.astype(np.float64)),
           rtol=2e-5, atol_of_max=2e-5)


@pytest.mark.parametrize("n,bw,k", [(75, 5, 4), (20, 2, 0), (8, 2, 1)])
def test_solve_banded_matches_jax(n, bw, k):
    """k = 0 is a vector right-hand side (1-D in, 1-D out); (8, 2) is one
    block (m = 1, no subdiagonal)."""
    rng = np.random.default_rng(7 + n)
    d = _banded_spd(rng, n, bw)
    b = rng.standard_normal((n, k) if k else n).astype(np.float32)
    nb = 8 if n == 8 else None
    got = pb.solve_banded(P.CSR.from_dense(d), b, nb=nb)
    want = np.asarray(jb.solve_banded(J.CSR.from_dense(d), b, nb=nb))
    assert got.shape == want.shape
    _close(got, want, rtol=1e-4)
    _close(got, np.linalg.solve(d.astype(np.float64), b), rtol=2e-4,
           atol_of_max=2e-4)


def test_jax_factor_through_port_solve():
    rng = np.random.default_rng(23)
    d = _banded_spd(rng, 50, 4)
    b = rng.standard_normal((50, 2)).astype(np.float32)
    jf = jb.factor_banded(J.CSR.from_dense(d))
    pf = interop.banded_factor_from_numpy(jf.L, jf.F, jf.n)
    _close(pb.solve_factored_banded(pf, b),
           jb.solve_factored_banded(jf, b))


def test_laplacian_2d_via_rcm():
    """The 12×12 grid Laplacian, RCM-ordered in both packages (the same
    permutation), then solved on the banded tier."""
    from basic_sparse_matrix_tpu.ops import reorder as jro
    from basic_sparse_matrix_tpu_torch.ops import reorder as pro

    d = _laplacian_2d(12)
    pa, ja = P.CSR.from_dense(d), J.CSR.from_dense(d)
    perm = pro.rcm_permutation(pa)
    assert np.array_equal(perm, jro.rcm_permutation(ja))
    pap, jap = pro.permute_symmetric(pa, perm), jro.permute_symmetric(ja, perm)
    assert pb.banded_block_choice(pap) == jb.banded_block_choice(jap)
    b = np.random.default_rng(3).standard_normal((144, 3)).astype(np.float32)
    got = pb.solve_banded(pap, b[perm])
    _close(got, jb.solve_banded(jap, b[perm]), rtol=1e-4)
    x = np.empty_like(got.numpy())
    x[perm] = got.numpy()
    _close(x, np.linalg.solve(d.astype(np.float64), b), rtol=5e-4,
           atol_of_max=5e-4)


def test_not_positive_definite_gives_jax_nan():
    """A block that is not positive definite: NaN where the JAX factor has
    NaN, and the same finite values elsewhere."""
    d = _banded_spd(np.random.default_rng(2), 24, 2)
    d[13, 13] = -50.0
    pf = pb.factor_banded(P.CSR.from_dense(d), 8)
    jf = jb.factor_banded(J.CSR.from_dense(d), 8)
    for got, want in ((pf.L.numpy(), np.asarray(jf.L)),
                      (pf.F.numpy(), np.asarray(jf.F))):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(want).any()
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


# ---- block cyclic reduction ------------------------------------------------
@pytest.mark.parametrize("n,bw,nb", [
    (24, 5, 24),    # m=1 (no levels)
    (16, 1, 8),     # m=2 (one level)
    (40, 3, 8),     # m=5 -> padded to 8
    (64, 3, 8),     # m=8, power of two
    (96, 7, 8),     # m=12 -> padded to 16
])
def test_bcr_matches_jax(n, bw, nb):
    rng = np.random.default_rng(n + bw)
    d = _banded_spd(rng, n, bw)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    ps = pbcr.prepare_bcr(P.CSR.from_dense(d), nb)
    js = jbcr.prepare_bcr(J.CSR.from_dense(d), nb)
    assert ps.fac.m_padded == js.fac.m_padded
    assert (ps.fac.n, ps.n, ps.nb) == (js.fac.n, js.n, js.nb)
    assert len(ps.fac.ls) == len(js.fac.ls)
    _close(ps.D, js.D)
    _close(ps.E, js.E)
    _close(ps.fac.l0, js.fac.l0)
    for name in ("ls", "wls", "wrs", "elefts", "erights"):
        for got, want in zip(getattr(ps.fac, name), getattr(js.fac, name)):
            _close(got, want, atol_of_max=1e-5)
    got = ps.solve(b)
    _close(got, js.solve(b), rtol=1e-4)
    _close(got, np.linalg.solve(d.astype(np.float64), b), rtol=3e-4,
           atol_of_max=3e-4)


def test_factor_bcr_takes_padded_blocks():
    """The port pads once, in ``bcr_from_blocks``; ``factor_bcr`` of the
    padded blocks equals the JAX ``factor_bcr`` of the unpadded ones (which
    pads inside), and refuses blocks that are not padded."""
    rng = np.random.default_rng(12)
    D, E = jb.band_blocks(J.CSR.from_dense(_banded_spd(rng, 40, 3)), 8)
    want = jbcr.factor_bcr(D, E)                     # m = 5, padded to 8
    Dp, Ep = pbcr._pad_pow2(torch.as_tensor(np.asarray(D)),
                            torch.as_tensor(np.asarray(E)))
    got = pbcr.factor_bcr(Dp, Ep)
    assert (got.m_padded, got.n) == (want.m_padded, 8 * 8)
    _close(got.l0, want.l0)
    for g, w in zip(got.wls, want.wls):
        _close(g, w, atol_of_max=1e-5)
    with pytest.raises(ValueError):
        pbcr.factor_bcr(torch.as_tensor(np.asarray(D)),
                        torch.as_tensor(np.asarray(E)))


def test_bcr_jax_factor_through_port_solve():
    rng = np.random.default_rng(41)
    d = _banded_spd(rng, 72, 4)
    b = rng.standard_normal((72, 2)).astype(np.float32)
    js = jbcr.prepare_bcr(J.CSR.from_dense(d), 8)
    f = js.fac
    pfac = interop.bcr_factor_from_numpy(f.ls, f.wls, f.wrs, f.elefts,
                                         f.erights, f.l0, f.n)
    ps = pbcr.BCRSolver(fac=pfac, D=torch.as_tensor(np.array(js.D)),
                        E=torch.as_tensor(np.array(js.E)), n=js.n, nb=js.nb)
    _close(ps.solve(b), js.solve(b))


def test_bcr_matches_banded_scan_and_reuse():
    rng = np.random.default_rng(5)
    d = _banded_spd(rng, 200, 6)
    a = P.CSR.from_dense(d)
    solver = pbcr.prepare_bcr(a)
    for _ in range(2):
        b = rng.standard_normal((200, 4)).astype(np.float32)
        _close(solver.solve(b), pb.solve_banded(a, b), rtol=2e-4,
               atol_of_max=2e-4)
    x = solver.solve(np.ones(200, np.float32))
    assert x.shape == (200,)
    _close(x, np.linalg.solve(d.astype(np.float64), np.ones(200)),
           rtol=3e-4, atol_of_max=3e-4)


# ---- DirectSolver on the banded tiers -------------------------------------
@pytest.mark.parametrize("solver_kind", [("bcr", "banded-bcr"),
                                         ("scan", "banded")])
def test_direct_solver_banded_tiers(configs, solver_kind):
    backend, kind = solver_kind
    configs(banded_min_steps=2, banded_solver=backend)
    rng = np.random.default_rng(12)
    d = _banded_spd(rng, 120, 5)
    b = rng.standard_normal((120, 3)).astype(np.float32)
    ps = P.prepare_direct(P.CSR.from_dense(d))
    js = J.prepare_direct(J.CSR.from_dense(d))
    assert ps.kind == js.kind == kind
    assert set(ps.timings) == {"order", "analyze", "numeric"}
    got = ps.solve(b)
    _close(got, js.solve(b), rtol=1e-4)
    _close(got, np.linalg.solve(d.astype(np.float64), b), rtol=3e-4,
           atol_of_max=3e-4)


def test_cholesky_auto_routes_banded(configs):
    configs(dense_cholesky_max_n=16, dense_cholesky_min_density=1.0,
            banded_min_steps=2)
    d = _banded_spd(np.random.default_rng(11), 96, 5)
    got = P.cholesky_auto(P.CSR.from_dense(d))
    want = J.cholesky_auto(J.CSR.from_dense(d))
    _close(got.todense(), want.todense())
    _close(got.todense(), np.linalg.cholesky(d.astype(np.float64)),
           rtol=2e-5, atol_of_max=2e-5)
