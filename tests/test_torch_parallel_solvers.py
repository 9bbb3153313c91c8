"""The port's distributed solvers (``parallel/cg``, ``pcg``, ``lanczos``,
``chebyshev``, ``tsqr``) against the JAX package on the CPU.

The JAX functions run on ``row_mesh(s)`` of the 8-device simulated CPU
mesh, the port's on ``LocalComm`` meshes, at s ∈ {1, 2, 4, 8}, on the
inputs of ``tests/test_parallel.py``, ``test_parallel_lanczos.py`` and
``test_distributed_solvers.py`` (PCG, PCG against CG, TSQR) from the same
numpy seeds. Tolerances:

* CG and PCG at the same fixed ``iters``: iterates ``rtol=1e-4``,
  ``atol=1e-5·max|ref|`` (float32 with sums in another order, compounded
  per step). Block-Jacobi factors: ``rtol=1e-5``, ``atol=1e-6·max|ref|``.
  The JAX factors fed through ``interop.block_jacobi_from_numpy`` give the
  port's PCG the JAX iterates within the PCG bound.
* Lanczos: the JAX package draws its start vector from ``PRNGKey(seed)``,
  which torch cannot reproduce, so both get the same numpy ``v0``;
  coefficients and Ritz values ``rtol=1e-4``, ``atol=1e-5·max|λ|``,
  including the full-``k`` exact-spectrum case. At 64 steps on the 12×12
  Laplacian the late coefficients follow each package's rounding (the
  basis nears an invariant subspace): there the first 16 coefficients and
  the extreme Ritz values are held.
* Chebyshev iterates (given bounds, and bounds from each package's own
  Lanczos on a shared ``v0``): ``rtol=1e-4``, ``atol=1e-5·max|ref|``.
* TSQR: ``QR = A`` and ``QᵀQ = I`` within 1e-5 (float64 check of the
  float32 factors: ``1e-5·max|A|``), ``|R|`` against JAX's ``|R|`` within
  1e-5 of ``max|R|`` (the signs of R's rows are the library's choice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.parallel import cg as jcg
from basic_sparse_matrix_tpu.parallel import chebyshev as jch
from basic_sparse_matrix_tpu.parallel import lanczos as jl
from basic_sparse_matrix_tpu.parallel import mesh as jm
from basic_sparse_matrix_tpu.parallel import pcg as jpcg
from basic_sparse_matrix_tpu.parallel import sharded as jsh
from basic_sparse_matrix_tpu.parallel import tsqr as jts
from basic_sparse_matrix_tpu_torch.ops import interop
from basic_sparse_matrix_tpu_torch.parallel import cg as pcg_
from basic_sparse_matrix_tpu_torch.parallel import chebyshev as pch
from basic_sparse_matrix_tpu_torch.parallel import lanczos as pl
from basic_sparse_matrix_tpu_torch.parallel import mesh as pm
from basic_sparse_matrix_tpu_torch.parallel import pcg as ppcg
from basic_sparse_matrix_tpu_torch.parallel import sharded as psh
from basic_sparse_matrix_tpu_torch.parallel import tsqr as pts
from basic_sparse_matrix_tpu_torch.utils.errors import IncorrectDimensions

torch.set_num_threads(1)

SHARDS = [1, 2, 4, 8]


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


def _spd64(seed=5, n=64):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32)
    return (m @ m.T + n * np.eye(n, dtype=np.float32)).astype(np.float32), \
        rng.standard_normal(n).astype(np.float32)


def _setup(d, s):
    jmesh = jm.row_mesh(s)
    pmesh = pm.row_mesh(s, comm="local", device="cpu")
    jsa = jsh.put_sharded(jsh.shard_csr(J.CSR.from_dense(d), s), jmesh)
    psa = psh.put_sharded(psh.shard_csr(P.CSR.from_dense(d), s), pmesh)
    return jsa, jmesh, psa, pmesh


def _close(got, want, rtol=1e-4, atol_of_max=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * np.abs(want).max())


# ---- CG ---------------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_cg_matches_jax(s):
    d, b = _spd64()
    jsa, jmesh, psa, pmesh = _setup(d, s)
    for iters in (5, 30):
        _close(pcg_.cg_solve_sharded(psa, b, pmesh, iters=iters),
               jcg.cg_solve_sharded(jsa, jnp.asarray(b), jmesh, iters=iters))


# ---- block-Jacobi PCG -------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_block_jacobi_factors_match_jax(s):
    d = _lap2d(6)
    jsa, jmesh, psa, pmesh = _setup(d, s)
    _close(ppcg.build_block_jacobi(psa, pmesh),
           jpcg.build_block_jacobi(jsa, jmesh), rtol=1e-5, atol_of_max=1e-6)


@pytest.mark.parametrize("s", SHARDS)
def test_pcg_matches_jax(s):
    rng = np.random.default_rng(3)
    d = _lap2d(6)
    b = rng.standard_normal(d.shape[0]).astype(np.float32)
    jsa, jmesh, psa, pmesh = _setup(d, s)
    lj = jpcg.build_block_jacobi(jsa, jmesh)
    want = jpcg.pcg_solve_sharded(jsa, jnp.asarray(b), jmesh, iters=60,
                                  lfac=lj)
    _close(ppcg.pcg_solve_sharded(psa, b, pmesh, iters=60), want)
    # the JAX factors, carried across, in the port's loop
    lfac = interop.block_jacobi_from_numpy(np.asarray(lj), pmesh)
    _close(ppcg.pcg_solve_sharded(psa, b, pmesh, iters=60, lfac=lfac), want)
    x = psh.unshard_rows(ppcg.pcg_solve_sharded(psa, b, pmesh, iters=60),
                         d.shape[0]).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(d.astype(np.float64), b),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("s", SHARDS)
def test_pcg_beats_cg_as_in_jax(s):
    rng = np.random.default_rng(4)
    d = _lap2d(8)
    n = d.shape[0]
    b = rng.standard_normal(n).astype(np.float32)
    jsa, jmesh, psa, pmesh = _setup(d, s)
    xp = ppcg.pcg_solve_sharded(psa, b, pmesh, iters=10)
    xc = pcg_.cg_solve_sharded(psa, b, pmesh, iters=10)
    _close(xp, jpcg.pcg_solve_sharded(jsa, jnp.asarray(b), jmesh, iters=10))
    _close(xc, jcg.cg_solve_sharded(jsa, jnp.asarray(b), jmesh, iters=10))
    res_p = np.linalg.norm(d @ xp.numpy()[:n] - b)
    res_c = np.linalg.norm(d @ xc.numpy()[:n] - b)
    if s > 1:
        assert res_p < res_c
    else:   # one block: the preconditioner is the exact inverse
        assert res_p < 1e-4 * np.linalg.norm(b)


# ---- Lanczos ----------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", ["lap8_k16", "lap12_k64", "sym32_full"])
def test_lanczos_matches_jax(s, case):
    """Coefficients and Ritz values on a shared v0. At 64 steps on the
    12×12 Laplacian (n = 144, eigenvalues of multiplicity two) the basis
    nears an invariant subspace and the late coefficients follow the
    rounding of either package; there the first 16 coefficients and the
    extreme Ritz values are held."""
    if case == "sym32_full":
        rng = np.random.default_rng(1)
        m = rng.normal(size=(32, 32)).astype(np.float32)
        d = ((m + m.T) / 2 + 8 * np.eye(32)).astype(np.float32)
        k, held = 32, 32
    elif case == "lap8_k16":
        d, k, held = _lap2d(8), 16, 16
    else:
        d, k, held = _lap2d(12), 64, 16
    n = d.shape[0]
    jsa, jmesh, psa, pmesh = _setup(d, s)
    v0 = np.random.default_rng(100 + s).standard_normal(
        psa.padded_rows).astype(np.float32)
    ja, jb = jl._lanczos_sharded_jit(jsa, jnp.asarray(v0), k, jmesh, n=n)
    pa, pb = pl.lanczos_sharded_from(psa, torch.as_tensor(v0), k, pmesh,
                                     n=n)
    assert pa.shape == (k,) and pb.shape == (k - 1,)
    lam = float(np.abs(np.linalg.eigvalsh(d)).max())
    np.testing.assert_allclose(pa.numpy()[:held], np.asarray(ja)[:held],
                               rtol=1e-4, atol=1e-5 * lam)
    np.testing.assert_allclose(pb.numpy()[:held - 1],
                               np.asarray(jb)[:held - 1], rtol=1e-4,
                               atol=1e-5 * lam)
    ritz = pl.ritz_values(pa, pb).numpy()
    jt = np.diag(np.asarray(ja)) + np.diag(np.asarray(jb), 1) \
        + np.diag(np.asarray(jb), -1)
    jritz = np.linalg.eigvalsh(jt)
    np.testing.assert_allclose(ritz[[0, -1]], jritz[[0, -1]], rtol=1e-4,
                               atol=1e-5 * lam)
    if held == k:
        np.testing.assert_allclose(ritz, jritz, rtol=1e-4, atol=1e-5 * lam)
    if case == "sym32_full":
        np.testing.assert_allclose(ritz, np.linalg.eigvalsh(d),
                                   atol=5e-4 * lam)


def test_lanczos_seeded_draw():
    """The public entry draws v0 from a torch generator: same seed, same
    Ritz values; a passed generator is used as it stands."""
    d = _lap2d(8)
    _, _, psa, pmesh = _setup(d, 4)
    r0 = pl.eigen_values_lanczos_sharded(psa, pmesh, 16, seed=3)
    r1 = pl.eigen_values_lanczos_sharded(
        psa, pmesh, 16, generator=torch.Generator().manual_seed(3))
    assert torch.equal(r0, r1)
    true = np.linalg.eigvalsh(d)
    assert abs(float(r0[-1]) - true[-1]) < 1e-2 * true[-1]


# ---- Chebyshev --------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_chebyshev_matches_jax(s):
    d, b = _spd64()
    jsa, jmesh, psa, pmesh = _setup(d, s)
    lam = np.linalg.eigvalsh(d.astype(np.float64))
    bounds = (0.95 * float(lam[0]), 1.01 * float(lam[-1]))
    xj, rj = jch.chebyshev_solve_sharded(jsa, jnp.asarray(b), jmesh,
                                         iters=40, bounds=bounds)
    xp, rp = pch.chebyshev_solve_sharded(psa, b, pmesh, iters=40,
                                         bounds=bounds)
    _close(xp, xj)
    np.testing.assert_allclose(rp, rj, rtol=1e-3)


@pytest.mark.parametrize("s", SHARDS)
def test_chebyshev_lanczos_bounds_match_jax(s):
    """Bounds from each package's sharded Lanczos on one shared v0."""
    d = _lap2d(6)
    n = d.shape[0]
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    jsa, jmesh, psa, pmesh = _setup(d, s)
    v0 = np.random.default_rng(7).standard_normal(psa.padded_rows).astype(
        np.float32)
    ja, jb = jl._lanczos_sharded_jit(jsa, jnp.asarray(v0), 32, jmesh, n=n)
    jt = np.diag(np.asarray(ja)) + np.diag(np.asarray(jb), 1) \
        + np.diag(np.asarray(jb), -1)
    jr = np.linalg.eigvalsh(jt)
    pr = pl.ritz_values(*pl.lanczos_sharded_from(
        psa, torch.as_tensor(v0), 32, pmesh, n=n)).numpy()
    jbounds = (0.95 * float(jr[0]), 1.01 * float(jr[-1]))
    pbounds = (0.95 * float(pr[0]), 1.01 * float(pr[-1]))
    np.testing.assert_allclose(pbounds, jbounds, rtol=1e-4)
    xj, _ = jch.chebyshev_solve_sharded(jsa, jnp.asarray(b), jmesh, iters=80,
                                        bounds=jbounds)
    xp, _ = pch.chebyshev_solve_sharded(psa, b, pmesh, iters=80,
                                        bounds=pbounds)
    _close(xp, xj)


def test_chebyshev_refuses_indefinite():
    d = np.diag(np.array([-1.0, 2.0, 3.0, 4.0], dtype=np.float32))
    _, _, psa, pmesh = _setup(d, 2)
    with pytest.raises(ValueError, match="SPD"):
        pch.chebyshev_solve_sharded(psa, np.ones(4, np.float32), pmesh,
                                    iters=5, lanczos_k=4)


# ---- TSQR -------------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_tsqr_matches_jax(s):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((640, 24)).astype(np.float32)
    jq, jr = jts.tsqr_sharded(a, jm.row_mesh(s))
    q, r = pts.tsqr_sharded(a, pm.row_mesh(s, comm="local", device="cpu"))
    q64, r64 = q.double().numpy(), r.double().numpy()
    assert q.shape == (640, 24) and r.shape == (24, 24)
    assert np.abs(np.triu(r64) - r64).max() == 0.0
    assert np.abs(q64 @ r64 - a).max() <= 1e-5 * np.abs(a).max()
    assert np.abs(q64.T @ q64 - np.eye(24)).max() <= 1e-5
    jr = np.abs(np.asarray(jr))
    assert np.abs(np.abs(r64) - jr).max() <= 1e-5 * jr.max()


def test_tsqr_refuses_short_blocks():
    with pytest.raises(IncorrectDimensions):
        pts.tsqr_sharded(np.ones((20, 8), np.float32),
                         pm.row_mesh(4, comm="local", device="cpu"))
