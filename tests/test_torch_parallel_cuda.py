"""The distributed SpMM strategies on the card: 4 logical shards
(``LocalComm``; 2 × 2 for the 2-D ring) on CUDA tensors against the
single-device ``mul_dense``, with one kernel launched per rank and ring
step: the one the card's kernel choice (``ops/spmm.py::_card_kernel``)
takes for that local product.

The operand, 131,072² with 40 random columns a row (≈ 5.2M stored) × 256
columns, gives every shard and every ring block at least 2**18 stored
entries, so each local product may take the streaming kernel (K2) as at the
full 1M-row size: a row shard does (its X, 131,072 × 256, is beyond the
L2), a ring step's 32,768-column block and the 2-D ring's 128-column strips
take K8 (``probes/ell_probe.py --choice``). Tolerance: float32 summed in another order,
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
    from basic_sparse_matrix_tpu_torch.ops import ell as k8
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2
    from basic_sparse_matrix_tpu_torch.parallel import sharded as sh
    from basic_sparse_matrix_tpu_torch.runtime import profiling as prof
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
    before = (k2.LAUNCHES, k8.LAUNCHES)
    with prof.recording():
        out = sh.unshard_rows(fn(sa, b, mesh), a.rows)
        torch.cuda.synchronize()
    counters = prof.snapshot().counters
    got = (k2.LAUNCHES - before[0], k8.LAUNCHES - before[1])
    assert out.is_cuda
    # one launch a local product, of the kernel the choice took for it
    assert sum(got) == launches == counters.get("spmm.card.decisions")
    assert got == (counters.get("spmm.rung.stream", 0),
                   counters.get("ell.launches", 0))
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


# ---- the distributed direct solvers and BCR on the card --------------------
# The 14³ Laplacian under nested dissection (n = 2744) at 4 logical shards
# against the single-device functions on the card. Tolerance: factors and
# triangular solves within 1e-6 of max|ref| (the card's index_add_ and the
# add-back kernel's atomicAdd sum in no fixed order); BCR against the
# single-device BCR solver (which adds a refinement step) rtol=1e-4,
# atol=1e-4·max|ref|.

@pytest.fixture(scope="module")
def lap14():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.ops import reorder

    k = 14
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        lo = np.take(idx, range(k - 1), axis=ax).ravel()
        hi = np.take(idx, range(1, k), axis=ax).ravel()
        r += [lo, hi]
        c += [hi, lo]
        v += [np.full(lo.size, -1.0)] * 2
    a = CSR.from_coo_arrays((n, n), np.concatenate(r), np.concatenate(c),
                            np.concatenate(v).astype(np.float32),
                            device="cuda")
    return a, reorder.permute_symmetric(a, reorder.nd_permutation(a))


def _close_of_max(got, want, frac=1e-6):
    assert got.is_cuda
    torch.testing.assert_close(got, want, rtol=0,
                               atol=frac * float(want.abs().max()))


def test_factorize_supernodal_sharded_on_the_card(lap14):
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident
    from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read
    from basic_sparse_matrix_tpu_torch.parallel import supernodal as ps
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    _, a = lap14
    sched = sn.analyze_supernodal(a)
    want = sn.factorize_supernodal(sched, a.values)
    mods = (runs_read, addback_resident, panel_addback)
    before = [m.LAUNCHES for m in mods]
    got = ps.factorize_supernodal_sharded(
        sched, a.values, row_mesh(4, comm="local", device="cuda"))
    torch.cuda.synchronize()
    k3, k4, k5 = (m.LAUNCHES - b for m, b in zip(mods, before))
    assert k3 > 0 and k4 + k5 > 0, (k3, k4, k5)
    _close_of_max(got, want)


def test_factorize_sharded_on_the_card(lap14):
    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.parallel import cholesky as pc
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    _, a = lap14
    sched = sc.analyze(a)
    _close_of_max(pc.factorize_sharded(
        sched, a.values, row_mesh(4, comm="local", device="cuda")),
        sc.factorize(sched, a.values))


@pytest.mark.parametrize("lower", [True, False])
def test_solve_triangular_sharded_on_the_card(lap14, lower):
    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st
    from basic_sparse_matrix_tpu_torch.parallel import triangular as pt
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    _, a = lap14
    l = sc.cholesky_sparse(a)
    if not lower:
        l = l.transpose()
    b = torch.randn((a.rows, 8), generator=torch.Generator(
        "cuda").manual_seed(5), device="cuda")
    got = pt.solve_sparse_distributed(
        l, b, row_mesh(4, comm="local", device="cuda"), lower=lower)
    _close_of_max(got, st.solve_triangular_sparse(l, b, lower=lower))


def test_bcr_solve_sharded_on_the_card(lap14):
    from basic_sparse_matrix_tpu_torch.models import bcr
    from basic_sparse_matrix_tpu_torch.parallel import bcr as pb
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    a, _ = lap14      # natural order: bandwidth 196
    b = torch.randn((a.rows, 4), generator=torch.Generator(
        "cuda").manual_seed(6), device="cuda")
    got = pb.bcr_solve_sharded_csr(a, b, row_mesh(4, comm="local",
                                                  device="cuda"), nb=196)
    want = bcr.prepare_bcr(a, 196).solve(b)
    assert got.is_cuda
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
