"""The port's distributed block cyclic reduction (``parallel/bcr.py``) and
the non-cyclic ``shift`` it rides on, against the JAX package on the CPU.

The eight cases of ``tests/test_parallel_bcr.py`` on the same seeded
inputs: the JAX function on ``row_mesh(ndev)`` of the 8-device simulated
CPU mesh, the port's on a ``LocalComm`` mesh of as many ranks (3 and 6
included: the survivor count is then padded to a power of two).
Tolerances: against ``np.linalg.solve`` the JAX file's ``rtol=3e-4``,
``atol=3e-4``; against the single-device solvers its ``1e-4``; against
the JAX distributed solve ``rtol=1e-4``, ``atol=1e-5·max|ref|`` (float32
batched Cholesky, triangular solves and products of two libraries).
``LocalComm.shift`` is checked exactly.
"""

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.models import banded as jbd
from basic_sparse_matrix_tpu.parallel import bcr as jpb
from basic_sparse_matrix_tpu.parallel import mesh as jm
from basic_sparse_matrix_tpu_torch.models import bcr as pbcr
from basic_sparse_matrix_tpu_torch.parallel import bcr as ppb
from basic_sparse_matrix_tpu_torch.parallel import comm as pcomm
from basic_sparse_matrix_tpu_torch.parallel import mesh as pm
from basic_sparse_matrix_tpu_torch.utils.errors import IncorrectDimensions

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


def _mesh(ndev):
    return pm.row_mesh(ndev, comm="local", device="cpu")


def _close_jax(got, dense, b, ndev, nb):
    want = jpb.bcr_solve_sharded_csr(J.CSR.from_dense(dense), b,
                                     jm.row_mesh(ndev), nb)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("ndev,n,bw,nb", [
    (8, 512, 5, 8),    # m=64: 3 local levels + 3 redundant
    (8, 64, 3, 8),     # m=8 = ndev: no local levels, all redundant
    (4, 200, 6, 8),    # m=25 -> padded to 32: pad blocks cross ranks
    (2, 96, 7, 8),     # m=12 -> padded to 16
])
def test_sharded_bcr_matches_oracle(ndev, n, bw, nb):
    rng = np.random.default_rng(n + ndev)
    dense = _banded_spd(rng, n, bw)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    x = ppb.bcr_solve_sharded_csr(P.CSR.from_dense(dense), b, _mesh(ndev), nb)
    assert x.shape == (n, 3)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, b),
                               rtol=3e-4, atol=3e-4)
    _close_jax(x, dense, b, ndev, nb)


def test_sharded_matches_single_device_bcr():
    rng = np.random.default_rng(3)
    dense = _banded_spd(rng, 256, 4)
    a = P.CSR.from_dense(dense)
    b = rng.standard_normal((256, 2)).astype(np.float32)
    x_single = pbcr.prepare_bcr(a, 8).solve(b).numpy()
    x_sharded = ppb.bcr_solve_sharded_csr(a, b, _mesh(8), 8).numpy()
    np.testing.assert_allclose(x_sharded, x_single, rtol=1e-4, atol=1e-4)
    _close_jax(torch.as_tensor(x_sharded), dense, b, 8, 8)


def test_sharded_bcr_1d_rhs():
    rng = np.random.default_rng(7)
    dense = _banded_spd(rng, 128, 2)
    rhs = np.ones(128, dtype=np.float32)
    x = ppb.bcr_solve_sharded_csr(P.CSR.from_dense(dense), rhs, _mesh(4), 8)
    assert x.shape == (128,)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, np.ones(128)),
                               rtol=3e-4, atol=3e-4)
    _close_jax(x, dense, rhs, 4, 8)


@pytest.mark.parametrize("ndev", [3, 6])
def test_sharded_bcr_non_pow2_devices(ndev):
    # the survivor-block count isn't a power of two -> the gathered tail
    # pads the RHS to the gathered factor's padded size
    rng = np.random.default_rng(31 + ndev)
    dense = _banded_spd(rng, 96, 4)
    b = rng.standard_normal((96, 2)).astype(np.float32)
    x = ppb.bcr_solve_sharded_csr(P.CSR.from_dense(dense), b, _mesh(ndev), 8)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, b),
                               rtol=3e-4, atol=3e-4)
    _close_jax(x, dense, b, ndev, 8)


@pytest.mark.parametrize("ndev", [2, 4])
def test_block_entry_matches_jax(ndev):
    """``bcr_solve_sharded`` on (D, E, b) blocks directly (m = 16): the
    JAX blocks carried across."""
    rng = np.random.default_rng(40 + ndev)
    dense = _banded_spd(rng, 128, 3)
    D, E = jbd.band_blocks(J.CSR.from_dense(dense), 8)
    E = np.concatenate([E, np.zeros((1, 8, 8), np.float32)])
    b = rng.standard_normal((16, 8, 2)).astype(np.float32)
    want = np.asarray(jpb.bcr_solve_sharded(D, E, b, jm.row_mesh(ndev)))
    got = ppb.bcr_solve_sharded(torch.as_tensor(D), torch.as_tensor(E),
                                torch.as_tensor(b), _mesh(ndev))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,ndev", [(12, 4), (24, 8), (6, 4)])
def test_block_count_must_be_ranks_times_pow2(m, ndev):
    D = torch.eye(4).expand(m, 4, 4).contiguous()
    with pytest.raises(IncorrectDimensions):
        ppb.bcr_solve_sharded(D, torch.zeros_like(D), torch.ones(m, 4, 1),
                              _mesh(ndev))


@pytest.mark.parametrize("size", [1, 2, 3, 5])
@pytest.mark.parametrize("offset", [1, -1, 2])
def test_local_shift_fills_the_open_edge_with_zeros(size, offset):
    comm = pcomm.LocalComm(size)
    xs = [torch.full((2, 3), float(i + 1)) for i in range(size)]
    out = comm.shift(xs, offset)
    assert len(out) == size
    for i, y in enumerate(out):
        src = i - offset
        want = xs[src] if 0 <= src < size else torch.zeros(2, 3)
        assert torch.equal(y, want), (i, src)
