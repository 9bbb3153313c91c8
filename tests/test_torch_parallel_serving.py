"""The port's sharded SpGEMM (``parallel/spgemm_sparse``), its serving
wrapper (``parallel/operator.py::DistributedOperator``) and its dry run
(``parallel/dryrun.py``) against the JAX package on the CPU.

The JAX functions run on ``row_mesh(s)`` of the 8-device simulated CPU
mesh, the port's on ``LocalComm`` meshes, at s ∈ {1, 2, 4, 8}, on the
inputs of ``tests/test_parallel_spgemm.py`` and
``test_distributed_operator.py``. Tolerances:

* SpGEMM: the output pattern equal to JAX's entry for entry, values
  ``rtol=1e-5`` (``atol=1e-6·max|ref|``); plan reuse with new values; fewer
  rows than shards; a B with one dense row.
* ``DistributedOperator``: products ``rtol=1e-5``; CG and PCG iterates
  ``rtol=1e-4``, ``atol=1e-5·max|ref|``; Chebyshev with the JAX operator's
  bounds handed to the port (their Lanczos start vectors differ, see
  ``test_torch_parallel_solvers.py``) ``rtol=1e-4``; the full spectrum
  (``k = n``) ``rtol=1e-4`` of max|λ|; ``matmul_sparse`` as SpGEMM.
* ``dryrun_multichip(8)``: runs to its end (its own limits inside).
"""

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.parallel import mesh as jm
from basic_sparse_matrix_tpu.parallel import operator as jop
from basic_sparse_matrix_tpu.parallel import spgemm_sparse as jsg
from basic_sparse_matrix_tpu_torch.parallel import mesh as pm
from basic_sparse_matrix_tpu_torch.parallel import operator as pop
from basic_sparse_matrix_tpu_torch.parallel import spgemm_sparse as psg

torch.set_num_threads(1)

SHARDS = [1, 2, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _random_sparse(rows, cols, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((rows, cols)) < density)
            * rng.standard_normal((rows, cols))).astype(np.float32)


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


def _pmesh(s):
    return pm.row_mesh(s, comm="local", device="cpu")


def _close(got, want, rtol=1e-5, atol_of_max=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_of_max * scale)


def _same_csr(pc, jc):
    (pp, pi, pv), (jp, ji, jv) = pc.numpy(), jc.numpy()
    assert (pc.rows, pc.cols) == (jc.rows, jc.cols)
    np.testing.assert_array_equal(pp.astype(np.int64), jp.astype(np.int64))
    np.testing.assert_array_equal(pi.astype(np.int64), ji.astype(np.int64))
    _close(pv, jv)


# ---- sharded SpGEMM ---------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", ["rect", "skewed_b", "rows_fewer"])
def test_spgemm_sharded_matches_jax(s, case):
    if case == "rect":
        da = _random_sparse(100, 80, 0.05, 0)
        db = _random_sparse(80, 60, 0.05, 1)
    elif case == "skewed_b":   # one dense row in B
        da = _random_sparse(64, 64, 0.03, 2)
        db = _random_sparse(64, 64, 0.01, 3)
        db[5, :] = 1.0
    else:                      # fewer rows than shards
        da = _random_sparse(6, 6, 0.4, 6)
        db = _random_sparse(6, 6, 0.4, 7)
    pc = psg.spgemm_sharded(P.CSR.from_dense(da), P.CSR.from_dense(db),
                            _pmesh(s))
    jc = jsg.spgemm_sharded(J.CSR.from_dense(da), J.CSR.from_dense(db),
                            jm.row_mesh(s))
    _same_csr(pc, jc)
    np.testing.assert_allclose(pc.todense().numpy(), da @ db, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("s", SHARDS)
def test_spgemm_sharded_plan_reuse(s):
    da = _random_sparse(48, 48, 0.05, 4)
    db = _random_sparse(48, 48, 0.05, 5)
    a, b = P.CSR.from_dense(da), P.CSR.from_dense(db)
    plans = psg.plan_spgemm_sharded(a, b, s)
    assert len(plans) == s
    c1 = psg.spgemm_sharded(a, b, _pmesh(s), plans=plans)
    a2 = P.CSR(indptr=a.indptr, indices=a.indices, values=2.0 * a.values,
               rows=a.rows, cols=a.cols)
    c2 = psg.spgemm_sharded(a2, b, _pmesh(s), plans=plans)
    np.testing.assert_allclose(c2.todense().numpy(),
                               2.0 * c1.todense().numpy(), rtol=1e-5)
    ja = J.CSR.from_dense(2.0 * da)
    _same_csr(c2, jsg.spgemm_sharded(ja, J.CSR.from_dense(db),
                                     jm.row_mesh(s)))


# ---- DistributedOperator ----------------------------------------------------
@pytest.fixture(scope="module")
def ops36():
    a = _lap2d(6)
    return a, {s: (jop.DistributedOperator(J.CSR.from_dense(a),
                                           jm.row_mesh(s)),
                   pop.DistributedOperator(P.CSR.from_dense(a), _pmesh(s)))
               for s in SHARDS}


@pytest.mark.parametrize("s", SHARDS)
def test_operator_products(ops36, s):
    a, ops = ops36
    jo, po = ops[s]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    b = rng.standard_normal((a.shape[1], 4)).astype(np.float32)
    _close(po.matvec(x), jo.matvec(x))
    _close(po.matmul(b), jo.matmul(b))
    assert po.matvec(x).shape == (36,) and po.matmul(b).shape == (36, 4)


@pytest.mark.parametrize("s", SHARDS)
def test_operator_solves(ops36, s):
    a, ops = ops36
    jo, po = ops[s]
    rng = np.random.default_rng(1)
    b = rng.standard_normal(a.shape[0]).astype(np.float32)
    for name in ("solve_cg", "solve_pcg"):
        _close(getattr(po, name)(b, iters=80), getattr(jo, name)(b, iters=80),
               rtol=1e-4, atol_of_max=1e-5)
    assert po._lfac is not None
    jx = jo.solve_chebyshev(b, iters=80)
    po._bounds = jo._bounds
    _close(po.solve_chebyshev(b, iters=80), jx, rtol=1e-4, atol_of_max=1e-5)
    ref = np.linalg.solve(a.astype(np.float64), b)
    for solver in (po.solve_cg, po.solve_pcg, po.solve_chebyshev):
        np.testing.assert_allclose(solver(b, iters=80).numpy(), ref,
                                   rtol=1e-3, atol=1e-3)


def test_operator_lazy_bounds():
    a = _lap2d(6)
    po = pop.DistributedOperator(P.CSR.from_dense(a), _pmesh(4))
    b = np.ones(36, np.float32)
    x = po.solve_chebyshev(b, iters=80)
    assert po._bounds is not None
    lam = np.linalg.eigvalsh(a.astype(np.float64))
    assert 0.9 * lam[0] < po._bounds[0] < lam[0]
    assert lam[-1] < po._bounds[1] < 1.02 * lam[-1]
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("s", SHARDS)
def test_operator_eigen_values_full(ops36, s):
    a, ops = ops36
    jo, po = ops[s]
    got, want = po.eigen_values(k=36).numpy(), np.asarray(jo.eigen_values(36))
    lam = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * lam)
    np.testing.assert_allclose(got, np.linalg.eigvalsh(a.astype(np.float64)),
                               rtol=1e-3, atol=1e-3 * lam)


@pytest.mark.parametrize("s", SHARDS)
def test_operator_matmul_sparse(ops36, s):
    a, ops = ops36
    jo, po = ops[s]
    rng = np.random.default_rng(9)
    db = ((rng.random(a.shape) < 0.1)
          * rng.standard_normal(a.shape)).astype(np.float32)
    other = P.CSR.from_dense(db)
    po._spgemm_plans.clear()
    c = po.matmul_sparse(other)
    _same_csr(c, jo.matmul_sparse(J.CSR.from_dense(db)))
    assert len(po._spgemm_plans) == 1
    po.matmul_sparse(other)   # plan reused
    assert len(po._spgemm_plans) == 1


def test_operator_default_mesh():
    """With no mesh: ``row_mesh()``, one rank on the CPU."""
    po = pop.DistributedOperator(P.CSR.from_dense(_lap2d(4)))
    assert po.mesh.shape == {"rows": 1}
    _close(po.matvec(np.ones(16, np.float32)), _lap2d(4) @ np.ones(16))


# ---- the dry run ------------------------------------------------------------
@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip(n):
    from basic_sparse_matrix_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(n, device="cpu")
