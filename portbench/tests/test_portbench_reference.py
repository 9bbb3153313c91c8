"""The plain reference against float64 dense linear algebra at 16³, and
TF32 rounding."""

import numpy as np
import pytest
import torch

from conftest import small
from portbench import hpcg, manifest
from portbench.reference import direct, ic0_pcg, stencil
from portbench.reference.precision import FLOAT64, TF32, tf32


@pytest.fixture(scope="module")
def config():
    return small(manifest.data("configs", "hpcg-104"))


@pytest.fixture(scope="module")
def dense(config):
    indptr, indices, values = hpcg.csr(config)
    n = indptr.shape[0] - 1
    a = np.zeros((n, n))
    a[np.repeat(np.arange(n), np.diff(indptr)), indices] = values
    return torch.from_numpy(a)


def test_operator_is_hpcg(config, dense):
    n = 16 ** 3
    assert dense.shape == (n, n)
    assert torch.equal(dense, dense.T)
    assert int((dense != 0).sum()) == (3 * 16 - 2) ** 3
    assert torch.all(dense.diagonal() == 26.0)
    assert set(dense[dense != 0].unique().tolist()) == {26.0, -1.0}
    indptr, indices, _ = hpcg.csr(config)
    for r in range(n):
        row = indices[indptr[r]: indptr[r + 1]]
        assert np.all(np.diff(row) > 0)


def test_stencil_is_the_dense_product(config, dense):
    x = torch.randn(dense.shape[0], 5, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    got = stencil.apply(config, x, FLOAT64)
    assert torch.allclose(got, dense @ x, rtol=0, atol=1e-12)
    assert torch.equal(stencil.dense(config, "cpu", block=1000), dense)


def test_direct_solve_is_the_dense_solve(config, dense):
    b = torch.randn(dense.shape[0], 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    x = direct.DenseCholesky(config, "cpu").solve(b, FLOAT64)
    assert torch.allclose(x, torch.linalg.solve(dense, b), rtol=0,
                          atol=1e-12)


def _factor(m):
    n = m.n
    l = torch.zeros((n, n), dtype=torch.float64)
    p = torch.arange(n)
    for i, step in enumerate(m.lin):
        live = m.lo[i] != 0
        l[p[live], (p + step)[live]] = m.lo[i][live]
    l[p, p] = m.ld
    return l


def test_ic0_matches_the_operator_on_its_pattern(config, dense):
    m = ic0_pcg.GridIC0(config, "cpu", FLOAT64)
    l = _factor(m)
    pattern = dense != 0
    assert torch.all((l != 0) <= torch.tril(pattern))
    assert torch.allclose((l @ l.T)[pattern], dense[pattern], rtol=0,
                          atol=1e-12)


def test_pcg_is_textbook_pcg(config, dense):
    m = ic0_pcg.GridIC0(config, "cpu", FLOAT64)
    l = _factor(m)
    mm = l @ l.T
    b = torch.randn(dense.shape[0], 2, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    x = ic0_pcg.pcg(config, b, 6, FLOAT64, m)
    for c in range(2):
        r = b[:, c].clone()
        xx = torch.zeros_like(r)
        z = torch.linalg.solve(mm, r)
        p, rz = z, r @ z
        for _ in range(6):
            ap = dense @ p
            alpha = rz / (p @ ap)
            xx, r = xx + alpha * p, r - alpha * ap
            z = torch.linalg.solve(mm, r)
            rz, rz_old = r @ z, rz
            p = z + rz / rz_old * p
        assert torch.allclose(x[:, c], xx, rtol=0, atol=1e-10)


def test_tf32_rounds_to_ten_mantissa_bits():
    t = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -10,
                      -3.14159265, 0.0])
    assert tf32(t).tolist() == [1.0, 1.0, 1 + 2 ** -9, 1 + 2 ** -10,
                                -3.140625, 0.0]
    x = torch.randn(10000, generator=torch.Generator().manual_seed(4))
    rel = ((tf32(x) - x) / x).abs().max()
    assert 2 ** -12 * 0.9 < rel <= 2 ** -11


def test_control_is_lower_precision(config):
    x = torch.randn(16 ** 3, 3, generator=torch.Generator().manual_seed(5))
    y64 = stencil.apply(config, x, FLOAT64)
    y32 = stencil.apply(config, x, TF32)
    assert y32.dtype == torch.float32
    assert (y32 - y64).abs().max() / y64.abs().max() > 1e-4
