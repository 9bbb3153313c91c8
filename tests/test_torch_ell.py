"""The CPU side of the port's ELL path
(``basic_sparse_matrix_tpu_torch/ops/ell.py``) against the JAX package's.

On the CPU, and for integer and float64 products on any device, the port
runs the plain composition (gather, multiply, row sum), counted
``ell.products`` and ``ell.plain``; K8 takes float32 products on the card
(``tests/test_torch_ell_kernel.py``). An ELL's column indices are checked
once to lie in [0, n_cols), since K8 reads the operand's rows unchecked.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_sparse_matrix_tpu.ops import ell as e_jax
from basic_sparse_matrix_tpu_torch.ops import ell as pe
from basic_sparse_matrix_tpu_torch.ops.csr import CSR
from basic_sparse_matrix_tpu_torch.runtime import profiling as prof


def _port_layout(seed, rows, k, width, dtype, first_col=0):
    """A seeded port ELL over columns [``first_col``, ``k``) with ragged
    rows (padding after each row's length), every fifth row empty, and its
    JAX twin."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, width + 1, rows)
    lens[::5] = 0
    live = np.arange(width)[None, :] < lens[:, None]
    cols = np.where(live, rng.integers(first_col, k, (rows, width)),
                    0).astype(np.int32)
    vals = np.where(live, rng.integers(-9, 10, (rows, width)), 0).astype(
        dtype)
    port = pe.ELL(cols=torch.from_numpy(cols), vals=torch.from_numpy(vals),
                  n_cols=k)
    return port, e_jax.ELL(cols=jnp.asarray(cols), vals=jnp.asarray(vals),
                           n_cols=k)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64])
@pytest.mark.parametrize("kind", ["spmm", "spmv"])
def test_port_ell_on_the_cpu_is_the_plain_composition(kind, dtype):
    port, jell = _port_layout(31, 45, 60, 7, dtype)
    rng = np.random.default_rng(32)
    shape = (60, 5) if kind == "spmm" else (60,)
    b = rng.integers(-9, 10, shape).astype(dtype)
    bt = torch.from_numpy(b)
    before = pe.LAUNCHES
    with prof.recording():
        out = (pe.spmm_ell if kind == "spmm" else pe.spmv_ell)(port, bt)
    c = prof.snapshot().counters
    assert c.get("ell.plain") == 1 and "ell.launches" not in c
    assert c.get("ell.products") == 1
    assert pe.LAUNCHES == before
    # the composition itself, written out
    g = bt[port.cols.long()]
    v = port.vals if kind == "spmv" else port.vals.unsqueeze(-1)
    want = (v * g).sum(1, dtype=bt.dtype)
    assert out.dtype == want.dtype == bt.dtype
    assert torch.equal(out, want)
    # and the JAX package's answer (exact: small integers in every dtype)
    ref = (e_jax.spmm_ell if kind == "spmm" else e_jax.spmv_ell)(
        jell, jnp.asarray(b))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["spmm", "spmv"])
def test_port_ell_padding_reads_zero_times_b0(kind):
    # only padding slots name column 0
    port, _ = _port_layout(33, 30, 20, 4, np.float32, first_col=1)
    shape = (20, 3) if kind == "spmm" else (20,)
    b = torch.ones(shape)
    b[0] = float("inf")
    out = (pe.spmm_ell if kind == "spmm" else pe.spmv_ell)(port, b)
    padded = ((port.cols == 0) & (port.vals == 0)).any(1)
    assert bool(padded.any()) and not bool(padded.all())
    nan = torch.isnan(out) if kind == "spmv" else torch.isnan(out).all(1)
    assert torch.equal(nan, padded)


@pytest.mark.parametrize("vals,operand,device,k8", [
    (torch.float32, torch.float32, "cuda", True),
    (torch.float32, torch.float32, "cpu", False),
    (torch.float64, torch.float64, "cuda", False),
    (torch.float32, torch.float64, "cuda", False),
    (torch.float64, torch.float32, "cuda", False),
    (torch.int32, torch.int32, "cuda", False),
    (torch.int64, torch.int64, "cuda", False),
    (torch.int32, torch.float32, "cuda", False),
])
def test_port_ell_sends_only_float32_on_the_card_to_k8(vals, operand,
                                                        device, k8):
    """The route on any device, without one: integer and float64 products
    keep the plain version on the card too."""
    ell = types.SimpleNamespace(vals=types.SimpleNamespace(dtype=vals))
    b = types.SimpleNamespace(dtype=operand, is_cuda=device == "cuda")
    assert pe._on_k8(ell, b) is k8


@pytest.mark.parametrize("bad,mirror", [
    (-1, False), (20, False), (-1, True), (20, True), (None, False),
    (None, True)])
def test_port_ell_columns_are_checked_once(bad, mirror):
    """``check_cols`` raises on a column outside [0, n_cols), from the
    host mirror or the tensor, and marks a layout that passes; a row slice
    given the mark is not checked again. ``csr_to_ell`` checks what it
    builds."""
    port, _ = _port_layout(35, 30, 20, 4, np.float32)
    cols = port.cols.clone()
    if bad is not None:
        cols[7, 2] = bad
    ell = pe.ELL(cols=cols, vals=port.vals, n_cols=20,
                 _host_cols=cols.numpy() if mirror else None)
    assert not ell._cols_ok
    if bad is None:
        pe.check_cols(ell)
        assert ell._cols_ok
        part = pe.ELL(cols=ell.cols[:10], vals=ell.vals[:10], n_cols=20,
                      _cols_ok=ell._cols_ok)
        assert part._cols_ok
        return
    with pytest.raises(ValueError, match="column indices span"):
        pe.check_cols(ell)
    assert not ell._cols_ok


def test_port_csr_to_ell_marks_its_columns_checked():
    d = np.zeros((6, 9), np.float32)
    d[1, 8], d[4, 0], d[4, 5] = 1.0, 2.0, 3.0
    ell = pe.csr_to_ell(CSR.from_dense(d, device="cpu"))
    assert ell._cols_ok and ell.n_cols == 9 and ell.width == 2
    empty = pe.csr_to_ell(CSR.from_dense(np.zeros((3, 0), np.float32),
                                          device="cpu"))
    assert empty._cols_ok and empty.n_cols == 0
