"""The distributed SpMM strategies on the card: 4 logical shards
(``LocalComm``; 2 × 2 for the 2-D ring) on CUDA tensors against the
single-device ``mul_dense``, with the streaming kernel (K2) launched once
per rank and ring step.

The operand, 131,072² with 40 random columns a row (≈ 5.2M stored) × 256
columns, gives every shard and every ring block at least 2**18 stored
entries, so each local product takes ``spmm_auto``'s streaming rung as at
the full 1M-row size. Tolerance: float32 summed in another order,
``rtol=1e-4``, ``atol=1e-4·max|ref|``. Without a card every test skips; on
a GPU machine: ``python -m pytest tests/test_torch_parallel_cuda.py -q
--noconftest``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROWS, PER_ROW, N_RHS = 131_072, 40, 256


@pytest.fixture(scope="module")
def operand():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from basic_sparse_matrix_tpu_torch import CSR, mul_dense

    rng = np.random.default_rng(3)
    a = CSR.from_coo_arrays(
        (ROWS, ROWS), np.repeat(np.arange(ROWS), PER_ROW),
        rng.integers(0, ROWS, ROWS * PER_ROW),
        rng.standard_normal(ROWS * PER_ROW).astype(np.float32),
        device="cuda")
    b = torch.randn((ROWS, N_RHS),
                    generator=torch.Generator("cuda").manual_seed(3),
                    device="cuda")
    return a, b, mul_dense(a, b)


@pytest.mark.parametrize("strategy,launches", [
    ("spmm_sharded", 4), ("spmm_allgather", 4), ("spmm_ring", 16),
    ("spmm_ring_2d", 8)])
def test_strategy_on_the_card(operand, strategy, launches):
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2
    from basic_sparse_matrix_tpu_torch.parallel import sharded as sh
    from basic_sparse_matrix_tpu_torch.parallel import spmm as ps
    from basic_sparse_matrix_tpu_torch.parallel import spmm2d
    from basic_sparse_matrix_tpu_torch.parallel.mesh import make_mesh, row_mesh

    a, b, ref = operand
    if strategy == "spmm_ring_2d":
        mesh, fn = make_mesh((2, 2), comm="local", device="cuda"), \
            spmm2d.spmm_ring_2d
    else:
        mesh, fn = row_mesh(4, comm="local", device="cuda"), \
            getattr(ps, strategy)
    sa = sh.put_sharded(sh.shard_csr(a, mesh.shape["rows"]), mesh)
    before = k2.LAUNCHES
    out = sh.unshard_rows(fn(sa, b, mesh), a.rows)
    torch.cuda.synchronize()
    assert out.is_cuda
    assert k2.LAUNCHES - before == launches
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))
