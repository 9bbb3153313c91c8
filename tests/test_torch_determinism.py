"""Determinism of the port: the same inputs give bitwise-identical results
across two calls, the cases of ``tests/test_determinism.py`` that the port
has (SpMM, transpose and add, factorize) on CPU tensors; and on the card the
kernels: K1, K2 and K3 have no atomics and must repeat bit for bit; the
add-back entries (K4, K5 and the rect entry) add with atomics, so they must
repeat bit for bit only where no two slots share an element (disjoint
spans), which is what a level of the factorization gives them.
"""

import numpy as np
import pytest
import torch

from basic_sparse_matrix_tpu_torch import CSR
from basic_sparse_matrix_tpu_torch.models.sparse_cholesky import (
    analyze,
    factorize,
)
from basic_sparse_matrix_tpu_torch.ops import add_sparse, spmm, transpose
from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3
from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as k1
from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mat(seed=0, rows=64, cols=80, density=0.15, device=None):
    rng = np.random.default_rng(seed)
    d = ((rng.random((rows, cols)) < density)
         * rng.standard_normal((rows, cols))).astype(np.float32)
    return CSR.from_dense(d, device=device)


def _rhs(seed, rows, cols, device=None):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (rows, cols)).astype(np.float32), device=device)


def test_spmm_bitwise_deterministic():
    a = _mat()
    b = _rhs(1, 80, 16)
    assert torch.equal(spmm(a, b), spmm(a, b))


def test_transpose_add_deterministic():
    a, b = _mat(2), _mat(3)
    assert torch.equal(transpose(a).values, transpose(a).values)
    c1, c2 = add_sparse(a, b), add_sparse(a, b)
    assert torch.equal(c1.values, c2.values)
    assert torch.equal(c1.indices, c2.indices)


def test_factorize_bitwise_deterministic():
    rng = np.random.default_rng(4)
    m = rng.standard_normal((24, 24)).astype(np.float32)
    a = CSR.from_dense(m @ m.T + 24 * np.eye(24, dtype=np.float32))
    sched = analyze(a)
    assert torch.equal(factorize(sched, a.values), factorize(sched, a.values))


def test_supernodal_factorize_bitwise_deterministic():
    """The supernodal factorization on CPU tensors (plain versions of K3-K5,
    ``index_add_`` in a fixed order) repeats bit for bit."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    n, k = 64, 8
    d = np.zeros((n, n), np.float32)
    for i in range(n):
        d[i, i] = 4.0
        for j in (i - 1, i + 1, i - k, i + k):
            if 0 <= j < n and not (abs(i - j) == 1 and i // k != j // k):
                d[i, j] = -1.0
    a = CSR.from_dense(d)
    sched = sn.analyze_supernodal(a, relax=8)
    assert torch.equal(sn.factorize_supernodal(sched, a.values),
                       sn.factorize_supernodal(sched, a.values))


# ---- on the card ----------------------------------------------------------
@pytest.mark.cuda
def test_k1_bitwise_deterministic_on_the_card(cuda):
    a = _mat(5, 300, 520, 0.2, device=cuda)
    b = _rhs(6, 520, 96, cuda)
    bsr = k1.csr_to_bsr(a)
    assert torch.equal(k1.spmm_bsr(bsr, b), k1.spmm_bsr(bsr, b))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["tile", "sliced"])
def test_k2_bitwise_deterministic_on_the_card(cuda, kernel):
    rng = np.random.default_rng(7)
    rows, cols, per_row = 3000, 5000, 8
    ri = np.repeat(np.arange(rows), per_row)
    plan = k2.build_stream_plan(
        ri, rng.integers(0, cols, ri.size),
        rng.standard_normal(ri.size).astype(np.float32), rows, cols,
        tile_m=16, tile_k=cols, device=cuda)
    b = _rhs(8, cols, 64, cuda)
    run = k2.spmm_stream_tile if kernel == "tile" else k2.spmm_stream_sliced
    assert torch.equal(run(plan, b), run(plan, b))


@pytest.mark.cuda
def test_k3_bitwise_deterministic_on_the_card(cuda):
    rng = np.random.default_rng(9)
    lv = torch.as_tensor(rng.standard_normal(9000).astype(np.float32),
                         device=cuda)
    stf = rng.integers(0, 8000, 300).astype(np.int32)
    stf[::5] = -1
    stf = torch.as_tensor(stf, device=cuda)
    assert torch.equal(k3.runs_read(lv, stf, 256), k3.runs_read(lv, stf, 256))


def _disjoint_spans(rng, nslots, length, dev):
    """Rows of random live length laid end to end: no element is hit by two
    slots. Every fifth slot dead."""
    rows = np.zeros((nslots, length), np.float32)
    starts = np.full(nslots, -1, np.int32)
    pos = 3
    for c in range(nslots):
        if c % 5 == 4:
            continue
        ln = int(rng.integers(1, length + 1))
        rows[c, :ln] = rng.standard_normal(ln)
        starts[c] = pos
        pos += ln
    lv = rng.standard_normal(pos + length).astype(np.float32)
    return (torch.as_tensor(lv, device=dev), torch.as_tensor(rows, device=dev),
            torch.as_tensor(starts, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [512, 2048, 100])
def test_k4_bitwise_deterministic_on_disjoint_spans(cuda, length):
    lv, rows, starts = _disjoint_spans(np.random.default_rng(length), 200,
                                       length, cuda)
    out = k4.addback_resident(lv.clone(), rows, starts)
    assert torch.equal(out, k4.addback_resident(lv.clone(), rows, starts))
    # one add an element: equal to the plain version bit for bit, too
    assert torch.equal(out, k4.addback_resident_reference(lv.clone(), rows,
                                                          starts))


@pytest.mark.cuda
def test_k5_bitwise_deterministic_on_disjoint_spans(cuda):
    st, wt, length = 8, 16, 2048
    lv, rows, starts = _disjoint_spans(np.random.default_rng(11), st * wt,
                                       length, cuda)
    twd = torch.full((st,), wt, dtype=torch.int32, device=cuda)
    live = (starts >= 0).reshape(st, wt)
    psh = torch.where(live[:, :, None], rows.reshape(st, wt, length), 0.0)
    tcp = starts.clamp(min=0).reshape(st, wt)
    out = k5.panel_addback(lv.clone(), psh, tcp, twd)
    assert torch.equal(out, k5.panel_addback(lv.clone(), psh, tcp, twd))
    assert torch.equal(out, k5.panel_addback_reference(lv.clone(), psh, tcp,
                                                       twd))


@pytest.mark.cuda
def test_rect_entry_bitwise_deterministic_on_disjoint_runs(cuda):
    rng = np.random.default_rng(12)
    st, rd, wt = 20, 200, 12
    tnr = rng.integers(wt, rd + 1, st)
    twd = rng.integers(1, wt + 1, st)
    tcp = np.zeros((st, wt), np.int64)
    pos = 1
    for s_ in range(st):
        for w in range(wt):
            tcp[s_, w] = pos
            pos += int(tnr[s_]) - w
    p = torch.as_tensor(rng.standard_normal((st, rd, wt)).astype(np.float32),
                        device=cuda)
    tcp, tnr, twd = (torch.as_tensor(x, device=cuda) for x in (tcp, tnr, twd))
    lv = torch.as_tensor(rng.standard_normal(pos + 8).astype(np.float32),
                         device=cuda)
    out = k4.addback_rects(lv.clone(), p, tcp, tnr, twd)
    assert torch.equal(out, k4.addback_rects(lv.clone(), p, tcp, tnr, twd))
    assert torch.equal(out, k5.panel_addback_rects(lv.clone(), p, tcp, tnr,
                                                   twd))
