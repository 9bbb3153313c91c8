"""The port's distributed direct solvers (``parallel/cholesky``,
``triangular``, ``supernodal``) against the JAX package on the CPU.

The JAX functions run on ``row_mesh(s)`` of the 8-device simulated CPU
mesh, the port's on ``LocalComm`` meshes, at s ∈ {1, 2, 4, 8}, on the
inputs of the nine direct cases of ``tests/test_distributed_solvers.py``
from the same numpy data. Tolerances:

* factors (scatter-list and supernodal): ``rtol=1e-5``,
  ``atol=1e-6·max|ref|`` against the JAX distributed factor and against
  the port's single-device supernodal factor (float32 products and merges
  summed in another order); the port's distributed scatter-list factor and
  triangular solves equal its single-device ones bit for bit on the CPU
  (each rank runs the single-device arithmetic on its slice, gathered in
  order);
* against dense float64 oracles and the reference goldens, the JAX file's
  own limits (``1e-4`` for factors and the golden solve, ``1e-3`` for the
  triangular solve, ``1e-5`` for the 3 × 3 triangular golden);
* solves against the JAX distributed solves: ``rtol=1e-5``,
  ``atol=1e-6·max|ref|``.

Extra cases: levels with fewer rows, triples or panels than ranks (a
tridiagonal chain: one column a level), so most ranks get empty ranges;
the supernodal factor under every ``supernodal_scatter`` × read mode at 3
ranks against the single-device factor under the same mode; the rank
split itself.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.models import sparse_cholesky as jsc
from basic_sparse_matrix_tpu.models import sparse_triangular as jst
from basic_sparse_matrix_tpu.models import supernodal as jsn
from basic_sparse_matrix_tpu.parallel import cholesky as jpc
from basic_sparse_matrix_tpu.parallel import mesh as jm
from basic_sparse_matrix_tpu.parallel import supernodal as jps
from basic_sparse_matrix_tpu.parallel import triangular as jpt
from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as psc
from basic_sparse_matrix_tpu_torch.models import sparse_triangular as pst
from basic_sparse_matrix_tpu_torch.models import supernodal as psn
from basic_sparse_matrix_tpu_torch.ops import reorder as pr
from basic_sparse_matrix_tpu_torch.parallel import cholesky as ppc
from basic_sparse_matrix_tpu_torch.parallel import levels
from basic_sparse_matrix_tpu_torch.parallel import mesh as pm
from basic_sparse_matrix_tpu_torch.parallel import supernodal as pps
from basic_sparse_matrix_tpu_torch.parallel import triangular as ppt
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)

SHARDS = [1, 2, 4, 8]
RTOL = 1e-5
ATOL_OF_MAX = 1e-6


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


def _chain(n=12):
    return (4 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(
        np.float32)


def _meshes(s):
    return jm.row_mesh(s), pm.row_mesh(s, comm="local", device="cpu")


def _dense(x):
    if isinstance(x, P.CSR):
        x = x.todense()
    if isinstance(x, J.CSR):
        x = x.todense()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol_of_max=ATOL_OF_MAX):
    got, want = _dense(got), _dense(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * np.abs(want).max())


# ---- scatter-list Cholesky ------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_distributed_cholesky_matches_dense(s):
    a = _lap2d(6)
    jmesh, pmesh = _meshes(s)
    l = ppc.cholesky_sparse_distributed(P.CSR.from_dense(a), pmesh)
    ref = np.linalg.cholesky(a.astype(np.float64))
    assert np.allclose(_dense(l), ref, rtol=1e-4, atol=1e-4)
    _close(l, jpc.cholesky_sparse_distributed(J.CSR.from_dense(a), jmesh))
    assert torch.equal(l.todense(),
                       psc.cholesky_sparse(P.CSR.from_dense(a)).todense())


@pytest.mark.parametrize("s", SHARDS)
def test_distributed_cholesky_reference_golden(s):
    # reference cholesky_decomposition_0 (sparse.rs:1031-1060)
    d = np.asarray([[4.0, 12, -16], [12, 37, -43], [-16, -43, 98]],
                   dtype=np.float32)
    jmesh, pmesh = _meshes(s)
    l = ppc.cholesky_sparse_distributed(P.CSR.from_dense(d), pmesh)
    ref = np.asarray([[2.0, 0, 0], [6, 1, 0], [-8, 5, 3]])
    assert np.allclose(_dense(l), ref, rtol=1e-4, atol=1e-4)
    _close(l, jpc.cholesky_sparse_distributed(J.CSR.from_dense(d), jmesh))


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_factorize_equals_single(s):
    a = _lap2d(4)
    jmesh, pmesh = _meshes(s)
    ja, pa = J.CSR.from_dense(a), P.CSR.from_dense(a)
    js, ps = jsc.analyze(ja), psc.analyze(pa)
    got = ppc.factorize_sharded(ps, pa.values, pmesh)
    single = np.asarray(jsc.factorize(js, ja.values))
    _close(got, single)
    _close(got, jpc.factorize_sharded(js, ja.values, jmesh))
    assert torch.equal(got, psc.factorize(ps, pa.values))


# ---- triangular solves ------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_distributed_triangular_solve(s):
    rng = np.random.default_rng(0)
    a = _lap2d(5)
    lref = np.linalg.cholesky(a.astype(np.float64)).astype(np.float32)
    b = rng.standard_normal((25, 3)).astype(np.float32)
    jmesh, pmesh = _meshes(s)
    l = P.CSR.from_dense(lref)
    x = ppt.solve_sparse_distributed(l, b, pmesh, lower=True)
    oracle = np.linalg.solve(lref.astype(np.float64), b)
    assert np.allclose(x.numpy(), oracle, rtol=1e-3, atol=1e-3)
    _close(x, jpt.solve_sparse_distributed(J.CSR.from_dense(lref), b, jmesh,
                                           lower=True))
    assert torch.equal(x, pst.solve_triangular_sparse(l, b))
    # the upper system through the mirrored schedule
    xu = ppt.solve_sparse_distributed(l.transpose(), b, pmesh, lower=False)
    _close(xu, jpt.solve_sparse_distributed(
        J.CSR.from_dense(lref).transpose(), b, jmesh, lower=False))
    assert torch.equal(xu, pst.solve_triangular_sparse(l.transpose(), b,
                                                       lower=False))


@pytest.mark.parametrize("s", SHARDS)
def test_distributed_full_solve_pipeline(s):
    # distributed chol + distributed fwd/bwd vs reference solve golden
    # (lib.rs:120-138)
    a = P.CSR.from_dense(np.asarray(
        [[8.0, 0, 0, 0], [0, 7, 1, 0], [0, 1, 3, 0], [0, 0, 0, 2]],
        dtype=np.float32))
    b = np.asarray([[5.0], [2.0], [8.0], [1.0]], dtype=np.float32)
    _, pmesh = _meshes(s)
    l = ppc.cholesky_sparse_distributed(a, pmesh)
    y = ppt.solve_sparse_distributed(l, b, pmesh, lower=True)
    x = ppt.solve_sparse_distributed(l.transpose(), y, pmesh, lower=False)
    assert np.allclose(x.numpy().ravel(), [0.625, -0.1, 2.6999998, 0.5],
                       rtol=1e-4)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_triangular_vector_rhs(s):
    d = np.asarray([[5.0, 0, 0], [8, 2, 0], [3, 7, 1]], dtype=np.float32)
    rhs = np.asarray([7.0, 3.0, 1.0], dtype=np.float32)
    jmesh, pmesh = _meshes(s)
    sched = pst.build_schedule(P.CSR.from_dense(d), lower=True)
    y = ppt.solve_triangular_sharded(sched, rhs, pmesh)
    assert y.shape == (3,)
    assert np.allclose(y.numpy(), [7 / 5, -4.1, 25.5], rtol=1e-5)
    _close(y, jpt.solve_triangular_sharded(
        jst.build_schedule(J.CSR.from_dense(d), lower=True), rhs, jmesh))


# ---- supernodal --------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_distributed_supernodal_matches_single(s):
    d = _lap2d(6)
    jmesh, pmesh = _meshes(s)
    a = P.CSR.from_dense(d)
    l_dist = pps.cholesky_supernodal_distributed(a, pmesh)
    _close(l_dist, psn.cholesky_supernodal(a))
    assert np.allclose(_dense(l_dist),
                       np.linalg.cholesky(d.astype(np.float64)), rtol=1e-4,
                       atol=1e-4)
    _close(l_dist, jps.cholesky_supernodal_distributed(J.CSR.from_dense(d),
                                                       jmesh))


@pytest.mark.parametrize("s", SHARDS)
def test_distributed_supernodal_dense_and_arrow(s):
    rng = np.random.default_rng(7)
    m = rng.standard_normal((16, 16))
    spd = (m @ m.T + 16 * np.eye(16)).astype(np.float32)
    jmesh, pmesh = _meshes(s)
    l = pps.cholesky_supernodal_distributed(P.CSR.from_dense(spd), pmesh)
    assert np.allclose(_dense(l), np.linalg.cholesky(spd.astype(np.float64)),
                       rtol=1e-4, atol=1e-4)
    _close(l, jps.cholesky_supernodal_distributed(J.CSR.from_dense(spd),
                                                  jmesh))


@pytest.mark.parametrize("s", SHARDS)
def test_distributed_supernodal_chunked_matches_whole(s):
    """``chunk_groups`` bounds XLA programs in the JAX package; eager
    PyTorch has none, so the port's factor is the same bits either way
    and within the factor tolerance of JAX's chunked one."""
    d = _lap2d(6)
    jmesh, pmesh = _meshes(s)
    ja, pa = J.CSR.from_dense(d), P.CSR.from_dense(d)
    ps = psn.analyze_supernodal(pa)
    whole = pps.factorize_supernodal_sharded(ps, pa.values, pmesh)
    chunked = pps.factorize_supernodal_sharded(ps, pa.values, pmesh,
                                               chunk_groups=2)
    assert torch.equal(whole, chunked)
    _close(chunked, np.asarray(jax.device_get(jps.factorize_supernodal_sharded(
        jsn.analyze_supernodal(ja), ja.values, jmesh, chunk_groups=2))))


# ---- levels narrower than the mesh -------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("which", ["cholesky", "triangular", "supernodal"])
def test_levels_narrower_than_the_mesh(s, which):
    """A tridiagonal chain: every level holds one column (one row, one
    triple; one panel), so at s > 1 every level leaves ranks empty."""
    d = _chain()
    jmesh, pmesh = _meshes(s)
    ja, pa = J.CSR.from_dense(d), P.CSR.from_dense(d)
    if which == "cholesky":
        ps = psc.analyze(pa)
        assert max(np.diff(ps.col_ptr)) == 1
        got = ppc.factorize_sharded(ps, pa.values, pmesh)
        assert torch.equal(got, psc.factorize(ps, pa.values))
        _close(got, jpc.factorize_sharded(jsc.analyze(ja), ja.values, jmesh))
    elif which == "triangular":
        l = psc.cholesky_sparse(pa)
        b = np.random.default_rng(2).standard_normal((12, 2)).astype(
            np.float32)
        sched = pst.build_schedule(l)
        assert sched.n_levels == 12
        got = ppt.solve_triangular_sharded(sched, b, pmesh)
        assert torch.equal(got, pst.solve_triangular_sparse(l, b, sched))
        _close(got, jpt.solve_sparse_distributed(jsc.cholesky_sparse(ja), b,
                                                 jmesh))
    else:
        ps = psn.analyze_supernodal(pa)
        got = pps.factorize_supernodal_sharded(ps, pa.values, pmesh)
        _close(got, psn.factorize_supernodal(ps, pa.values))
        _close(got, jps.factorize_supernodal_sharded(
            jsn.analyze_supernodal(ja), ja.values, jmesh))


# ---- the supernodal routes at 3 ranks -------------------------------------
@pytest.fixture(scope="module")
def nd_lap3d():
    k = 8
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        lo = np.take(idx, range(k - 1), axis=ax).ravel()
        hi = np.take(idx, range(1, k), axis=ax).ravel()
        r += [lo, hi]
        c += [hi, lo]
        v += [np.full(lo.size, -1.0)] * 2
    a = P.CSR.from_coo_arrays((n, n), np.concatenate(r), np.concatenate(c),
                              np.concatenate(v).astype(np.float32))
    return pr.permute_symmetric(a, pr.nd_permutation(a))


@pytest.mark.parametrize("scatter",
                         ["auto", "element", "delta", "pallas", "vmem"])
@pytest.mark.parametrize("gather", ["element", "window", "kernel"])
def test_supernodal_routes_match_single_device(nd_lap3d, scatter, gather):
    """Every route of the level step at 3 ranks (ragged splits of every
    level) against the single-device factor under the same config."""
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, supernodal_gather=gather,
                                        supernodal_scatter=scatter))
    try:
        sched = psn.analyze_supernodal(nd_lap3d, relax=8)
        want = psn.factorize_supernodal(sched, nd_lap3d.values)
        got = pps.factorize_supernodal_sharded(
            sched, nd_lap3d.values, pm.row_mesh(3, comm="local",
                                                device="cpu"))
    finally:
        pcfg.set_config(old)
    _close(got, want)


@pytest.mark.parametrize("count,num", [(0, 4), (3, 8), (10, 4), (64, 8)])
def test_split_levels_covers_each_level(count, num):
    ptr = (5, 5 + count, 5 + 2 * count + 1)
    b = levels.split_levels(ptr, num)
    assert b.shape == (2, num + 1)
    assert list(b[:, 0]) == list(ptr[:-1]) and list(b[:, -1]) == list(ptr[1:])
    sizes = np.diff(b, axis=1)
    assert (sizes >= 0).all() and (sizes.max(1) - sizes.min(1) <= 1).all()
