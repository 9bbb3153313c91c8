"""``to_torch_sparse`` / ``from_torch_sparse``: the port's counterpart of the
JAX package's ``to_bcoo`` / ``from_bcoo`` (``basic_sparse_matrix_tpu/ops/
interop.py``). The same numpy-seeded matrix goes through both packages'
converters: the stored triples must agree entry for entry, the round trip
must give the matrix back, duplicates must be summed, and
``torch.sparse.mm`` of the converted operand must equal the port's ``spmm``
(rtol 1e-5, atol 1e-5 of the largest magnitude: the same float32 products
summed in another order).
"""

import numpy as np
import pytest
import torch

from basic_sparse_matrix_tpu import CSR as JCSR
from basic_sparse_matrix_tpu.ops import interop as jinterop
from basic_sparse_matrix_tpu_torch import CSR
from basic_sparse_matrix_tpu_torch.ops import interop, spmm

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _dense(seed, rows, cols, density):
    rng = np.random.default_rng(seed)
    return ((rng.random((rows, cols)) < density)
            * rng.standard_normal((rows, cols))).astype(np.float32)


SHAPES = [(0, 30, 40, 0.2), (1, 64, 64, 0.05), (2, 5, 90, 0.5),
          (3, 17, 3, 0.0)]


@pytest.mark.parametrize("layout", ["csr", "coo"])
@pytest.mark.parametrize("seed,rows,cols,density", SHAPES)
def test_round_trip_through_torch_sparse(seed, rows, cols, density, layout):
    d = _dense(seed, rows, cols, density)
    a = CSR.from_dense(d)
    m = interop.to_torch_sparse(a, layout)
    assert m.layout == (torch.sparse_csr if layout == "csr"
                        else torch.sparse_coo)
    assert tuple(m.shape) == (rows, cols)
    assert np.array_equal(m.to_dense().numpy(), d)
    back = interop.from_torch_sparse(m)
    for got, want in zip(back.numpy(), a.numpy()):
        assert np.array_equal(got, want)
    assert back.shape == a.shape and back.device == a.device


@pytest.mark.parametrize("seed,rows,cols,density", SHAPES[:3])
def test_coo_triples_equal_the_jax_bcoo(seed, rows, cols, density):
    """The same matrix through ``to_bcoo`` and ``to_torch_sparse``: equal
    coordinates in equal (sorted) order, equal values; and both packages'
    ``from_`` converters give equal CSR triples."""
    d = _dense(seed, rows, cols, density)
    bcoo = jinterop.to_bcoo(JCSR.from_dense(d))
    coo = interop.to_torch_sparse(CSR.from_dense(d), "coo")
    assert coo.is_coalesced()
    assert np.array_equal(coo.indices().numpy().T, np.asarray(bcoo.indices))
    assert np.array_equal(coo.values().numpy(), np.asarray(bcoo.data))
    for got, want in zip(interop.from_torch_sparse(coo).numpy(),
                         jinterop.from_bcoo(bcoo).numpy()):
        assert np.array_equal(got, want)


def test_from_torch_sparse_sums_duplicates_and_keeps_zeros():
    idx = torch.tensor([[0, 0, 2, 2, 1], [1, 1, 0, 0, 3]])
    vals = torch.tensor([1.0, 2.0, 5.0, -5.0, 4.0])
    m = torch.sparse_coo_tensor(idx, vals, (3, 4))
    a = interop.from_torch_sparse(m)
    indptr, indices, values = a.numpy()
    assert indptr.tolist() == [0, 1, 2, 3]
    assert indices.tolist() == [1, 3, 0]
    assert values.tolist() == [3.0, 4.0, 0.0]


@pytest.mark.parametrize("layout", [torch.sparse_csc, torch.sparse_bsr])
def test_from_torch_sparse_takes_the_other_layouts(layout):
    d = _dense(5, 8, 12, 0.4)
    t = torch.from_numpy(d)
    m = t.to_sparse_csc() if layout == torch.sparse_csc \
        else t.to_sparse_bsr((2, 3))
    assert np.array_equal(interop.from_torch_sparse(m).todense().numpy(), d)


def test_converters_reject_what_they_do_not_take():
    a = CSR.from_dense(_dense(6, 4, 4, 0.5))
    with pytest.raises(ValueError):
        interop.to_torch_sparse(a, "bsr")
    with pytest.raises(ValueError):
        interop.from_torch_sparse(torch.zeros((3, 3)))
    with pytest.raises(ValueError):
        interop.from_torch_sparse(torch.zeros((2, 3, 3)).to_sparse())


@pytest.mark.parametrize("layout", ["csr", "coo"])
@pytest.mark.parametrize("n_rhs", [1, 16])
def test_torch_sparse_mm_of_the_converted_operand_equals_spmm(layout, n_rhs):
    d = _dense(7, 48, 60, 0.15)
    a = CSR.from_dense(d)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (60, n_rhs)).astype(np.float32))
    got = torch.sparse.mm(interop.to_torch_sparse(a, layout), b).numpy()
    want = spmm(a, b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
