"""The distributed supernodal factorization and triangular solves at the
JAX scale test's size, on ``LocalComm`` meshes on the CPU.

Port of ``tests/test_distributed_scale.py::
test_distributed_supernodal_triangular_scale``: the 13³ 7-point Laplacian
(n = 2197, which 8 shards do not divide) under nested dissection,
``analyze_supernodal(relax=64)``, ``factorize_supernodal_sharded`` with
``chunk_groups=16``, then ``solve_sparse_distributed`` forward and
backward. Held to that test's own limits (``max|L Lᵀ x − A x| / max|A x|
< 1e-5``; solve residual ``< 1e-3·max|b|``) and to the port's
single-device factor on the same schedule (``rtol=1e-5``,
``atol=1e-6·max|ref|``: float32 merges summed in another order), not to a
JAX run at this size (its chunked factorization spends about 30 s
compiling). The distributed solves equal the single-device
``solve_triangular_sparse`` bit for bit on the CPU.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.models import sparse_triangular as pst
from basic_sparse_matrix_tpu_torch.models import supernodal as psn
from basic_sparse_matrix_tpu_torch.ops import reorder as pr
from basic_sparse_matrix_tpu_torch.parallel import mesh as pm
from basic_sparse_matrix_tpu_torch.parallel import supernodal as pps
from basic_sparse_matrix_tpu_torch.parallel import triangular as ppt

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _lap3d(k):
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        lo = np.take(idx, range(k - 1), axis=ax).ravel()
        hi = np.take(idx, range(1, k), axis=ax).ravel()
        r += [lo, hi]
        c += [hi, lo]
        v += [np.full(lo.size, -1.0)] * 2
    return P.CSR.from_coo_arrays((n, n), np.concatenate(r), np.concatenate(c),
                                 np.concatenate(v).astype(np.float32))


def _scipy(a):
    ip, ix, vv = a.numpy()
    return sp.csr_matrix((vv, ix, ip), shape=(a.rows, a.cols))


@pytest.fixture(scope="module")
def system():
    a = _lap3d(13)
    ap = pr.permute_symmetric(a, pr.nd_permutation(a))
    sched = psn.analyze_supernodal(ap, relax=64)
    single = psn.factorize_supernodal(sched, ap.values)
    return ap, sched, single


@pytest.mark.parametrize("s", [2, 3, 4, 8])
def test_distributed_supernodal_triangular_scale(system, s):
    ap, sched, single = system
    n = ap.rows
    assert n % s != 0  # ragged shard boundaries are the point
    assert sched.n_groups > 20  # multi-level elimination structure
    mesh = pm.row_mesh(s, comm="local", device="cpu")
    lv = pps.factorize_supernodal_sharded(sched, ap.values, mesh,
                                          chunk_groups=16)
    np.testing.assert_allclose(lv.numpy(), single.numpy(), rtol=1e-5,
                               atol=1e-6 * float(single.abs().max()))
    l = psn.assemble_factor(ap, lv, sched)

    # L L^T == Ap (sparse residual, no dense n² array)
    L, A = _scipy(l), _scipy(ap)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    rel = np.abs(L @ (L.T @ x) - A @ x).max() / np.abs(A @ x).max()
    assert rel < 1e-5

    # distributed forward and backward solves on the factor
    b = rng.standard_normal((n, 1)).astype(np.float32)
    y = ppt.solve_sparse_distributed(l, b, mesh, lower=True)
    xx = ppt.solve_sparse_distributed(l.transpose(), y, mesh, lower=False)
    assert torch.equal(y, pst.solve_triangular_sparse(l, b))
    assert torch.equal(xx, pst.solve_triangular_sparse(l.transpose(), y,
                                                       lower=False))
    resid = np.abs(A @ xx.numpy().ravel() - b.ravel()).max()
    assert resid < 1e-3 * np.abs(b).max()
