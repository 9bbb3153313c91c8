"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small and ragged shapes (unaligned rows, columns and RHS
widths, thin and fat BSR tiles, both vector widths and several column
slices of the streaming tile kernel, the sliced one and the dispatch
between the two; unaligned run starts, dead slots, runs past
the end and overlapping add-back spans for the supernodal kernels, every
destination alignment and class width of the add-back's span entry and
ragged, masked and misaligned rects for its rect entry; ragged
entry counts, widths that are no multiple of 4 or 32 and one hot row for
the per-entry FMA; K3 and the rect entry with a batch axis).

These need a CUDA device and nvcc; without a device every test skips. On a
GPU machine: ``python -m pytest tests/test_torch_cuda_kernels.py -q
--noconftest`` (``tests/conftest.py`` sets up jax, which these tests do not
use).
Tolerance: float32 summed in another order, ``rtol=1e-4`` and ``atol=1e-4``
times the largest reference magnitude. The run reads (K3) copy values and
must match exactly. The add-back entries (K4/K5) are held to ``|d| <=
1e-5 * max(1, max|ref|)`` (atomic adds in another order). K1's ``HIGHEST`` (3×TF32) must also come within 1e-5
of max|ref| of a float64 product at depth 2048, TF32 switched on or not,
and one TF32 pass (``DEFAULT``) must be at least 10× further off.
"""

import dataclasses

import numpy as np
import pytest
import torch

from basic_sparse_matrix_tpu_torch import CSR, mul_dense
from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
from basic_sparse_matrix_tpu_torch.ops.pallas import entry_fma as k6
from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3
from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as k1
from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2
from basic_sparse_matrix_tpu_torch.ops import ell as k8
from basic_sparse_matrix_tpu_torch.utils import config as cfgmod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(out, ref):
    scale = float(ref.abs().max()) if ref.numel() else 1.0
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * max(scale, 1))


def _sparse(rng, rows, cols, density):
    return ((rng.random((rows, cols)) < density)
            * rng.standard_normal((rows, cols))).astype(np.float32)


@pytest.mark.parametrize(
    "rows,cols,density,n_rhs,tiles,hole",
    [
        (128, 256, 0.05, 128, None, None),      # (256, 512) tiles, one block row
        (100, 200, 0.1, 64, None, None),        # unaligned everything
        (1000, 1000, 0.01, 10, None, None),     # (64, 256) tiles
        (300, 2000, 0.001, 130, None, None),    # (8, 128) thin tiles
        (64, 64, 0.0, 32, None, None),          # empty matrix, seeded blocks only
        (130, 1000, 0.2, 70, (100, 96), None),  # tiles that are no multiple of 8
        (64, 8192, 0.3, 256, (64, 256), None),  # 32 live blocks in one block row
        (600, 3000, 0.05, 512, (256, 512), None),  # fat tiles, m_sub 4
        (512, 9000, 0.02, 512, (8, 128), None),    # thin tiles, many per row
        (200, 1000, 0.1, 64, (64, 90), None),   # bk % 4 != 0: 4-byte A copies
        (300, 700, 0.05, 77, (64, 256), (64, 192)),  # N % 4 != 0, seed-only rows
        (100, 900, 0.1, 40, (8, 128), (16, 72)),     # thin, seed-only rows
    ],
)
def test_spmm_bsr_kernel_matches_plain(cuda, rows, cols, density, n_rhs,
                                       tiles, hole):
    rng = np.random.default_rng(42)
    d = _sparse(rng, rows, cols, density)
    if hole is not None:
        d[hole[0]:hole[1]] = 0.0      # block rows left with their seed only
    a = CSR.from_dense(d, device=cuda)
    bsr = k1.csr_to_bsr(a, *(tiles or (None, None)))
    if hole is not None:
        assert (torch.diff(bsr.live_ptr) == 0).any()
    b = torch.as_tensor(rng.standard_normal((cols, n_rhs)).astype(np.float32),
                        device=cuda)
    before = k1.LAUNCHES
    out = k1.spmm_bsr(bsr, b)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    _close(out, k1.spmm_bsr_reference(bsr, b))


@pytest.mark.parametrize("rows,cols,density,n_rhs,tiles", [
    (600, 3000, 0.05, 512, (256, 512)),
    (1000, 1000, 0.01, 130, (64, 256)),
    (512, 9000, 0.02, 70, (8, 128)),
])
def test_spmm_bsr_kernel_default_precision_matches_plain(
        cuda, rows, cols, density, n_rhs, tiles):
    rng = np.random.default_rng(43)
    a = CSR.from_dense(_sparse(rng, rows, cols, density), device=cuda)
    bsr = k1.csr_to_bsr(a, *tiles)
    b = torch.as_tensor(rng.standard_normal((cols, n_rhs)).astype(np.float32),
                        device=cuda)
    out = k1.spmm_bsr(bsr, b, precision=k1.DEFAULT)
    torch.cuda.synchronize()
    _close(out, k1.spmm_bsr_reference(bsr, b, k1.DEFAULT))


def _deep_block_row(cuda):
    """One block row of 8 live (64, 256) blocks (depth 2048) × a 2048×128
    normal RHS, with the float64 product on the host."""
    rng = np.random.default_rng(17)
    d = rng.standard_normal((64, 2048)).astype(np.float32)
    b = rng.standard_normal((2048, 128)).astype(np.float32)
    bsr = k1.csr_to_bsr(CSR.from_dense(d, device=cuda), 64, 256)
    assert bsr.n_live == 8
    ref = d.astype(np.float64) @ b.astype(np.float64)
    return bsr, torch.as_tensor(b, device=cuda), ref


def _err(out, ref):
    return float(np.abs(out.cpu().numpy().astype(np.float64) - ref).max())


def test_spmm_bsr_highest_reaches_float32_accuracy(cuda):
    """HIGHEST (3×TF32) is within 1e-5 of max|ref| of the float64 product;
    one TF32 pass (DEFAULT) is at least 10× worse on the same inputs, so
    the split is live."""
    bsr, b, ref = _deep_block_row(cuda)
    hi = _err(k1.spmm_bsr(bsr, b), ref)
    lo = _err(k1.spmm_bsr(bsr, b, precision=k1.DEFAULT), ref)
    bound = 1e-5 * float(np.abs(ref).max())
    assert hi <= bound, (hi, bound)
    assert lo >= 10 * hi, (lo, hi)


def test_spmm_bsr_ignores_global_tf32_switch(cuda):
    bsr, b, ref = _deep_block_row(cuda)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = k1.spmm_bsr(bsr, b)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert _err(out, ref) <= 1e-5 * float(np.abs(ref).max())


@pytest.mark.parametrize("bm", [8, 64, 256])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_spmm_bsr_kernel_config_fits_the_card(cuda, bm, precision):
    """Each configuration runs at least two thread blocks per SM, with at
    most a few spilled words (the fat tile spills 32 bytes at 255
    registers on the H100)."""
    cfg = k1.kernel_config(bm, precision)
    assert cfg["blocks_per_sm"] >= 2 and cfg["local_bytes"] <= 64
    assert (cfg["tile_m"], cfg["tile_n"]) == ((8, 128) if bm == 8
                                              else (64, 128))


@pytest.mark.parametrize("kernel", ["tile", "sliced"])
@pytest.mark.parametrize(
    "rows,cols,nnz,n_rhs,tile_m,tile_k",
    [
        (200, 300, 1500, 24, 64, 32),       # the JAX test's tiles
        (200, 300, 1500, 128, 16, 300),     # one k tile
        (1000, 5000, 20000, 512, 16, 5000),  # the main path's slice width
        (513, 77, 3000, 130, 8, 16),        # n % 4 != 0: scalar columns
        (100, 100, 500, 1000, 16, 100),     # two column slices
        (2000, 300, 8000, 128, 512, 300),   # tile over 48 KB: opt-in smem
    ],
)
def test_spmm_stream_kernel_matches_plain(cuda, rows, cols, nnz, n_rhs,
                                          tile_m, tile_k, kernel):
    """Both K2 kernels on the same cases. The sliced kernel takes the
    entries in row order (what ``stream_plan_from_ell`` gives it), under
    one k tile, and refuses a plan with several k tiles and a width that is
    no multiple of 4."""
    rng = np.random.default_rng(7)
    ri = rng.integers(0, rows, nnz)
    ci = rng.integers(0, cols, nnz)
    v = rng.standard_normal(nnz).astype(np.float32)
    v[::17] = 0.0
    if kernel == "sliced":
        ri = np.sort(ri)           # row order; the k tiles stay as they are
    plan = k2.build_stream_plan(ri, ci, v, rows, cols, tile_m=tile_m,
                                tile_k=tile_k, device=cuda)
    b = torch.as_tensor(rng.standard_normal((cols, n_rhs)).astype(np.float32),
                        device=cuda)
    dense = np.zeros((rows, cols), np.float64)
    np.add.at(dense, (ri, ci), v)
    ref64 = torch.as_tensor(dense @ b.cpu().numpy().astype(np.float64),
                            device=cuda).float()
    ref = k2.spmm_stream_reference(plan, b)
    if kernel == "tile":
        def run():
            return k2.spmm_stream(plan, b)
    elif n_rhs % 4 or plan.n_kt != 1:
        with pytest.raises(ValueError):
            k2.spmm_stream_sliced(plan, b)
        return
    else:
        def run():
            return k2.spmm_stream_sliced(plan, b)
    before = (k2.LAUNCHES, k2.LAUNCHES_BY_KERNEL[kernel])
    out = run()
    torch.cuda.synchronize()
    assert (k2.LAUNCHES, k2.LAUNCHES_BY_KERNEL[kernel]) == (
        before[0] + 1, before[1] + 1)
    _close(out, ref)
    _close(out, ref64)
    assert torch.equal(out, run())      # no atomics: bitwise repeatable


def _row_sorted_plan(rng, rows, cols, per_row, tile_m, cuda, long_row=None,
                     empty=None):
    """A one-k-tile plan from entries in row order: ``per_row`` random
    columns a row, optionally one row of ``long_row`` entries and a range
    of rows left empty."""
    counts = np.full(rows, per_row)
    if long_row is not None:
        counts[rows // 3] = long_row
    if empty is not None:
        counts[empty[0]:empty[1]] = 0
    ri = np.repeat(np.arange(rows), counts)
    ci = rng.integers(0, cols, ri.size)
    v = rng.standard_normal(ri.size).astype(np.float32)
    v[v == 0] = 1.0
    return k2.build_stream_plan(ri, ci, v, rows, cols, tile_m=tile_m,
                                tile_k=cols, device=cuda)


@pytest.mark.parametrize(
    "rows,cols,per_row,n_rhs,budget,want,long_row,empty,force",
    [
        (3000, 5000, 8, 64, 1 << 20, ("sliced", 32), None, None, True),
        (3000, 5000, 8, 20, 1 << 18, ("sliced", 32), None, None, True),  # N % w
        (3000, 5000, 8, 40, 1 << 18, ("sliced", 32), None, None, True),
        (3000, 5000, 12, 64, 1 << 20, ("tile", 0), 1200, None, True),  # 100x
        (3000, 5000, 8, 64, 1 << 20, ("sliced", 32), None, (32, 48), True),
        (3000, 5000, 8, 64, 5000 * 64 * 4, ("tile", 0), None, None, True),
        (3000, 5000, 8, 62, 1 << 20, ("tile", 0), None, None, False),  # N % 4
    ],
)
def test_spmm_stream_dispatch_on_the_card(cuda, monkeypatch, rows, cols,
                                          per_row, n_rhs, budget, want,
                                          long_row, empty, force):
    """``spmm_stream`` crosses from one kernel to the other by shape alone
    (the L2 budget is lowered to bring the crossing to a small operand: a
    ``B`` over the budget takes the sliced kernel at w = 32, one that fits
    it, a ragged width or a row 100x the average the tile kernel); the
    kernel it takes and the sliced kernel called by name agree with the
    plain version and the tile kernel, and the result is bitwise equal
    across two calls."""
    monkeypatch.setattr(k2, "L2_SLICE_BUDGET_BYTES", budget)
    rng = np.random.default_rng(11)
    plan = _row_sorted_plan(rng, rows, cols, per_row, 16, cuda, long_row,
                            empty)
    b = torch.as_tensor(rng.standard_normal((cols, n_rhs)).astype(np.float32),
                        device=cuda)
    _, longest = k2.cell_row_pointers(plan)
    assert longest == (long_row or per_row)
    assert k2.pick_stream_kernel(rows, cols, n_rhs, plan.n_kt,
                                 longest) == want
    before = dict(k2.LAUNCHES_BY_KERNEL)
    out = k2.spmm_stream(plan, b)
    torch.cuda.synchronize()
    other = "tile" if want[0] == "sliced" else "sliced"
    assert k2.LAUNCHES_BY_KERNEL[want[0]] == before[want[0]] + 1
    assert k2.LAUNCHES_BY_KERNEL[other] == before[other]
    ref = k2.spmm_stream_reference(plan, b)
    _close(out, ref)
    assert torch.equal(out, k2.spmm_stream(plan, b))
    if force:
        forced = k2.spmm_stream_sliced(plan, b)
        _close(forced, ref)
        _close(forced, k2.spmm_stream_tile(plan, b))
        assert torch.equal(forced, k2.spmm_stream_sliced(plan, b))
    if empty is not None:
        assert not out[empty[0]:empty[1]].any()


def test_spmm_stream_unsorted_cells_keep_the_tile_kernel(cuda, monkeypatch):
    """Entries in no row order leave cells unsorted: no row pointers, the
    dispatch stays with the tile kernel and the sliced kernel refuses."""
    monkeypatch.setattr(k2, "L2_SLICE_BUDGET_BYTES", 1 << 18)
    rng = np.random.default_rng(12)
    ri, ci = rng.integers(0, 3000, 20000), rng.integers(0, 5000, 20000)
    v = rng.standard_normal(20000).astype(np.float32)
    plan = k2.build_stream_plan(ri, ci, v, 3000, 5000, tile_m=16,
                                tile_k=5000, device=cuda)
    assert k2.cell_row_pointers(plan)[0] is None
    b = torch.randn((5000, 64), device=cuda)
    before = dict(k2.LAUNCHES_BY_KERNEL)
    _close(k2.spmm_stream(plan, b), k2.spmm_stream_reference(plan, b))
    assert k2.LAUNCHES_BY_KERNEL["tile"] == before["tile"] + 1
    with pytest.raises(ValueError):
        k2.spmm_stream_sliced(plan, b)
    assert k2.LAUNCHES_BY_KERNEL["sliced"] == before["sliced"]


def test_mul_dense_reaches_each_kernel(cuda):
    rng = np.random.default_rng(3)
    # Block-dense 2048x2048 at 1% density: no dense rung under a lowered
    # byte cap, BSR fill 1.0.
    n, bm, bk = 2048, 64, 256
    d = np.zeros((n, n), np.float32)
    for t in rng.choice((n // bm) * (n // bk), 2, replace=False):
        r, c = divmod(int(t), n // bk)
        d[r * bm:(r + 1) * bm, c * bk:(c + 1) * bk] = rng.standard_normal(
            (bm, bk))
    a_bsr = CSR.from_dense(d, device=cuda)
    # Random columns: the card's kernel choice takes K2 where X (131,072 ×
    # 256) is beyond the L2, K8 where it (20,000 × 128) fits
    # (probes/ell_probe.py --choice).
    operands = []
    for rows, cols, per, n in ((32768, 131072, 40, 256),
                               (20000, 20000, 16, 128)):
        operands.append((CSR.from_coo_arrays(
            (rows, cols), np.repeat(np.arange(rows), per),
            rng.integers(0, cols, rows * per),
            rng.standard_normal(rows * per).astype(np.float32),
            device=cuda), n))
    (a_st, n_st), (a_ell, n_ell) = operands
    old = cfgmod.get_config()
    cfgmod.set_config(dataclasses.replace(old, dense_dispatch_max_bytes=1))
    try:
        for a, kernel, n in ((a_bsr, k1, 128), (a_st, k2, n_st),
                             (a_ell, k8, n_ell)):
            b = torch.randn((a.cols, n), device=cuda)
            before = kernel.LAUNCHES
            out = mul_dense(a, b)
            torch.cuda.synchronize()
            assert kernel.LAUNCHES == before + 1
            ref = torch.zeros_like(out).index_add_(
                0, a.row_ids(),
                b.index_select(0, a.indices) * a.values.unsqueeze(1))
            _close(out, ref)
    finally:
        cfgmod.set_config(old)


def test_integer_operands_take_plain_rungs(cuda):
    rng = np.random.default_rng(5)
    n = 3000
    a = CSR.from_coo_arrays((n, n), rng.integers(0, n, 400000),
                            rng.integers(0, n, 400000),
                            rng.integers(0, 10, 400000).astype(np.int32),
                            device=cuda)
    b = rng.integers(0, 16, (n, 128)).astype(np.int32)
    dense = np.zeros((n, n), np.int64)
    np.add.at(dense, (a.row_ids().cpu().numpy(), a.indices.cpu().numpy()),
              a.values.cpu().numpy())
    before = (k1.LAUNCHES, k2.LAUNCHES)
    old = cfgmod.get_config()
    cfgmod.set_config(dataclasses.replace(old, dense_dispatch_max_bytes=1))
    try:
        out = mul_dense(a, torch.as_tensor(b, device=cuda))
    finally:
        cfgmod.set_config(old)
    assert (k1.LAUNCHES, k2.LAUNCHES) == before
    assert out.dtype == torch.int32
    assert np.array_equal(out.cpu().numpy().astype(np.int64), dense @ b)


def test_kernels_reject_what_they_do_not_take(cuda):
    rng = np.random.default_rng(9)
    a = CSR.from_dense(_sparse(rng, 64, 128, 0.2), device=cuda)
    bsr = k1.csr_to_bsr(a)
    with pytest.raises(TypeError):
        k1.spmm_bsr(bsr, torch.zeros((128, 8), dtype=torch.float64,
                                     device=cuda))
    with pytest.raises(ValueError):
        k1.spmm_bsr(bsr, torch.zeros((100, 8), device=cuda))
    r, c = np.nonzero(_sparse(rng, 64, 128, 0.2))
    plan = k2.build_stream_plan(r, c, np.ones(r.size, np.float32), 64, 128,
                                tile_m=16, tile_k=128, device=cuda)
    with pytest.raises(ValueError):
        k2.spmm_stream(plan, torch.zeros((128, 8), device=cuda),
                       layout="diag")
    with pytest.raises(TypeError):
        k2.spmm_stream(plan, torch.zeros((128, 8), dtype=torch.float16,
                                         device=cuda))


@pytest.mark.parametrize("n,crq,l_pad", [
    (1000, 300, 37),       # odd run length, unaligned starts
    (5000, 1024, 128),
    (3000, 77, 2048),      # runs longer than most of lvals
    (100000, 4096, 512),
    (10, 9, 1),
])
def test_runs_read_kernel_matches_plain(cuda, n, crq, l_pad):
    rng = np.random.default_rng(n + crq)
    lv = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                         device=cuda)
    stf = rng.integers(0, n, crq).astype(np.int32)
    stf[::5] = -1                       # dead slots
    stf[1::7] = n - 1                   # runs past the end read zeros
    stf = torch.as_tensor(stf, device=cuda)
    before = k3.LAUNCHES
    out = k3.runs_read(lv, stf, l_pad)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == before + 1
    assert torch.equal(out, k3.runs_read_reference(lv, stf, l_pad))


def _spans(rng, nslots, length, n):
    """Rows with a random live prefix and a zero tail, at random (often
    overlapping) starts; a quarter of the slots dead."""
    rows = np.zeros((nslots, length), np.float32)
    for c in range(nslots):
        ln = int(rng.integers(1, length + 1))
        rows[c, :ln] = rng.standard_normal(ln)
    starts = rng.integers(0, n, nslots).astype(np.int32)
    starts[::4] = -1
    return rows, starts


@pytest.mark.parametrize("n,nslots,length", [
    (3000, 16, 256), (20000, 4096, 512), (5000, 333, 2048), (64, 50, 100),
])
def test_addback_resident_kernel_matches_plain(cuda, n, nslots, length):
    rng = np.random.default_rng(nslots)
    rows, starts = _spans(rng, nslots, length, n)
    lv0 = rng.standard_normal(n).astype(np.float32)
    args = (torch.as_tensor(rows, device=cuda),
            torch.as_tensor(starts, device=cuda))
    out = torch.as_tensor(lv0, device=cuda)
    before = k4.LAUNCHES
    k4.addback_resident(out, *args)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1
    ref = k4.addback_resident_reference(torch.as_tensor(lv0, device=cuda),
                                        *args)
    _close(out, ref)


def test_addback_overlapping_spans_lose_no_update(cuda):
    """4096 slots add 1.0 over the same 2048-element span: every element
    must end at exactly 4096 (a read-modify-write without atomics loses
    updates)."""
    nslots, length = 4096, 2048
    lv = torch.zeros(length + 10, device=cuda)
    rows = torch.ones((nslots, length), device=cuda)
    starts = torch.full((nslots,), 5, dtype=torch.int32, device=cuda)
    k4.addback_resident(lv, rows, starts)
    torch.cuda.synchronize()
    assert torch.equal(lv[5:5 + length],
                       torch.full((length,), float(nslots), device=cuda))
    assert float(lv[:5].abs().sum()) == 0 and float(lv[-5:].abs().sum()) == 0


@pytest.mark.parametrize("st,wt,col_len,n", [
    (1, 64, 2048, 50000), (64, 128, 2048, 9000), (3, 5, 1024, 700),
])
def test_panel_addback_kernel_matches_plain(cuda, st, wt, col_len, n):
    rng = np.random.default_rng(st * wt)
    psh = np.zeros((st, wt, col_len), np.float32)
    for s_ in range(st):
        for w in range(wt):
            ln = int(rng.integers(1, max(col_len - 1024, 1) + 1))
            psh[s_, w, :ln] = rng.standard_normal(ln)
    tcp = rng.integers(0, n, (st, wt)).astype(np.int32)
    twd = rng.integers(0, wt + 1, st).astype(np.int32)
    lv0 = rng.standard_normal(n).astype(np.float32)
    args = [torch.as_tensor(x, device=cuda) for x in (psh, tcp, twd)]
    out = torch.as_tensor(lv0, device=cuda)
    before = k5.LAUNCHES
    k5.panel_addback(out, *args)
    torch.cuda.synchronize()
    assert k5.LAUNCHES == before + 1
    ref = k5.panel_addback_reference(torch.as_tensor(lv0, device=cuda),
                                     *args)
    _close(out, ref)


def _tight(out, ref):
    """The add-back entries against their plain versions: float32 adds in
    another order (atomics), ``|d| <= 1e-5 * max(1, max|ref|)``."""
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    err = float((out - ref).abs().max()) if ref.numel() else 0.0
    assert out.shape == ref.shape and err <= 1e-5 * scale, err


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("len_mod", [0, 1, 2, 3])
@pytest.mark.parametrize("start_mod", [0, 1, 2, 3])
def test_addback_span_entry_alignments(cuda, start_mod, len_mod, holes, cut):
    """Every destination alignment against every row length mod 4 (the
    vector kernel for 0, the scalar one else), with zeros inside the run and
    with spans cut by the end of ``lvals``: the head/body/tail split and the
    end-of-run scan add each live element once and drop what falls off."""
    rng = np.random.default_rng(16 * start_mod + 4 * len_mod + 2 * holes + cut)
    nslots, length, n = 24, 640 + len_mod, 5000
    rows = np.zeros((nslots, length), np.float32)
    for c in range(nslots):
        ln = int(rng.integers(1, length + 1))
        rows[c, :ln] = rng.standard_normal(ln)
        if holes:       # zero runs inside the live part, longer than a scan step
            z0 = int(rng.integers(0, ln))
            rows[c, z0: z0 + 200] = 0.0
            rows[c, ln - 1] = 1.5
    rows[3] = 0.0                                   # a live slot of zeros
    starts = (4 * rng.integers(0, (n - length) // 4, nslots)
              + start_mod).astype(np.int32)
    if cut:
        starts[:8] = n - np.arange(1, 9) * 37 - start_mod
    starts[5] = -1
    lv0 = rng.standard_normal(n).astype(np.float32)
    args = (torch.as_tensor(rows, device=cuda),
            torch.as_tensor(starts, device=cuda))
    out = k4.addback_resident(torch.as_tensor(lv0, device=cuda), *args)
    torch.cuda.synchronize()
    _tight(out, k4.addback_resident_reference(
        torch.as_tensor(lv0, device=cuda), *args))


@pytest.mark.parametrize("col_pad", [512, 2048, 8192])
def test_addback_span_entry_at_every_class_width(cuda, col_pad):
    """The K4 class widths of ``models/supernodal._VMEM_COL_CLASSES``: rows
    of one to sixteen parts, runs that end anywhere, a quarter dead."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    assert col_pad in sn._VMEM_COL_CLASSES
    rng = np.random.default_rng(col_pad)
    n, nslots = 60000, 96
    rows, starts = _spans(rng, nslots, col_pad, n)
    lv0 = rng.standard_normal(n).astype(np.float32)
    args = (torch.as_tensor(rows, device=cuda),
            torch.as_tensor(starts, device=cuda))
    out = k4.addback_resident(torch.as_tensor(lv0, device=cuda), *args)
    torch.cuda.synchronize()
    _tight(out, k4.addback_resident_reference(
        torch.as_tensor(lv0, device=cuda), *args))


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_addback_entries_take_a_misaligned_lvals_view(cuda, shift):
    """``lvals`` that starts 4, 8 or 12 bytes past a 16-byte boundary: the
    quads follow the address, not the index, and nothing outside the view
    changes."""
    rng = np.random.default_rng(shift)
    n = 4000
    base = torch.as_tensor(rng.standard_normal(n + 8).astype(np.float32),
                           device=cuda)
    keep = base.clone()
    view = base[shift: shift + n]
    rows, starts = _spans(rng, 40, 512, n)
    starts[1] = 0                                    # a span at the view's start
    starts[2] = n - 100                              # one cut by its end
    args = (torch.as_tensor(rows, device=cuda),
            torch.as_tensor(starts, device=cuda))
    ref = k4.addback_resident_reference(keep[shift: shift + n].clone(), *args)
    k4.addback_resident(view, *args)
    st, rd, wt = 6, 150, 9
    p = torch.as_tensor(rng.standard_normal((st, rd, wt)).astype(np.float32),
                        device=cuda)
    tcp = torch.as_tensor(rng.integers(0, n - rd, (st, wt)).astype(np.int32),
                          device=cuda)
    tnr = torch.as_tensor(rng.integers(0, rd + 1, st).astype(np.int32),
                          device=cuda)
    twd = torch.as_tensor(rng.integers(0, wt + 1, st).astype(np.int32),
                          device=cuda)
    ref = k4.addback_rects_reference(ref, p, tcp, tnr, twd)
    k4.addback_rects(view, p, tcp, tnr, twd)
    torch.cuda.synchronize()
    _tight(view, ref)
    assert torch.equal(base[:shift], keep[:shift])
    assert torch.equal(base[shift + n:], keep[shift + n:])


def test_addback_entries_on_dead_and_empty_operands(cuda):
    lv0 = torch.arange(100, dtype=torch.float32, device=cuda)
    lv = lv0.clone()
    dead = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    k4.addback_resident(lv, torch.ones((64, 512), device=cuda), dead)
    k4.addback_resident(lv, torch.ones((64, 7), device=cuda), dead)
    k4.addback_resident(lv, torch.ones((0, 512), device=cuda), dead[:0])
    k4.addback_resident(lv, torch.ones((64, 0), device=cuda), dead + 1)
    k5.panel_addback(lv, torch.ones((4, 8, 64), device=cuda),
                     torch.zeros((4, 8), dtype=torch.int32, device=cuda),
                     torch.zeros(4, dtype=torch.int32, device=cuda))
    zero = torch.zeros(4, dtype=torch.int64, device=cuda)
    tcp = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    p = torch.ones((4, 16, 8), device=cuda)
    k4.addback_rects(lv, p, tcp, zero + 16, zero)          # no live column
    k4.addback_rects(lv, p, tcp, zero, zero + 8)           # no live row
    k4.addback_rects(lv, p[:0], tcp[:0], zero[:0], zero[:0])
    k4.addback_rects(lv, p[:, :0], tcp, zero, zero + 8)
    torch.cuda.synchronize()
    assert torch.equal(lv, lv0)


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("st,rd,wt,n", [
    (1, 40, 8, 900), (37, 130, 5, 9000), (9, 300, 33, 20000),
    (3, 129, 70, 12000), (200, 12, 3, 4000), (2, 1000, 32, 3000),
])
def test_addback_rects_kernel_matches_plain(cuda, st, rd, wt, n, idx):
    """The rect entry against the shear, negation and span add-back it
    folds, at both index types: tiles cut by ``tnr``, ``twd`` and the
    wedge, column counts that are no multiple of 32, rects taller than one
    tile, panels whose runs overlap, nonzero values outside the live
    trapezoids (never added) and runs cut by the end of ``lvals``."""
    rng = np.random.default_rng(st * rd + wt)
    p = torch.as_tensor(rng.standard_normal((st, rd, wt)).astype(np.float32),
                        device=cuda)
    tcp = torch.as_tensor(rng.integers(0, n, (st, wt)), device=cuda).to(idx)
    tnr = torch.as_tensor(rng.integers(0, rd + 1, st), device=cuda).to(idx)
    twd = torch.as_tensor(rng.integers(0, wt + 1, st), device=cuda).to(idx)
    tnr[0], twd[0] = rd, wt
    lv0 = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                          device=cuda)
    ref = k4.addback_rects_reference(lv0.clone(), p, tcp, tnr, twd)
    before = k4.LAUNCHES
    out = k4.addback_rects(lv0.clone(), p, tcp, tnr, twd)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1
    _tight(out, ref)


def test_addback_rects_equals_the_delta_route_and_spares_scratch(cuda):
    """The rect entry against ``supernodal_scatter="delta"``'s masked
    ``index_add_`` on disjoint runs: equal bit for bit where the delta route
    writes, and the scratch slot (where that route parks masked elements)
    and everything past the runs untouched."""
    rng = np.random.default_rng(7)
    st, rd, wt = 12, 90, 6
    tnr = rng.integers(wt, rd + 1, st)
    twd = rng.integers(1, wt + 1, st)
    tcp = np.zeros((st, wt), np.int64)
    pos = 0
    for s_ in range(st):
        for w in range(wt):
            tcp[s_, w] = pos
            pos += max(int(tnr[s_]) - w, 0)
    scratch = pos
    p = torch.as_tensor(rng.standard_normal((st, rd, wt)).astype(np.float32),
                        device=cuda)
    tcp, tnr, twd = (torch.as_tensor(x, device=cuda) for x in (tcp, tnr, twd))
    lv0 = torch.as_tensor(rng.standard_normal(scratch + 50)
                          .astype(np.float32), device=cuda)
    lv0[scratch:] = 0.0
    out = k4.addback_rects(lv0.clone(), p, tcp, tnr, twd)
    rr = torch.arange(rd, device=cuda)[None, :, None]
    ww = torch.arange(wt, device=cuda)[None, None, :]
    mask = (ww < twd[:, None, None]) & (rr >= ww) & (rr < tnr[:, None, None])
    where = torch.where(mask, tcp[:, None, :] + rr - ww, scratch)
    ref = lv0.clone().index_add_(0, where.reshape(-1), (-p).reshape(-1))
    torch.cuda.synchronize()
    assert torch.equal(out[:scratch], ref[:scratch])
    assert float(out[scratch:].abs().max()) == 0.0


def test_supernodal_kernels_reject_what_they_do_not_take(cuda):
    lv = torch.zeros(100, device=cuda)
    with pytest.raises(TypeError):
        k3.runs_read(lv, torch.zeros(4, dtype=torch.int64, device=cuda), 8)
    with pytest.raises(TypeError):
        k4.addback_resident(lv.double(), torch.zeros((2, 8), device=cuda),
                            torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        k4.addback_resident(lv, torch.zeros((2, 8), device=cuda),
                            torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        k5.panel_addback(lv, torch.zeros((2, 3, 8), device=cuda),
                         torch.zeros((2, 4), dtype=torch.int32, device=cuda),
                         torch.zeros(2, dtype=torch.int32, device=cuda))
    p = torch.zeros((2, 8, 3), device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        k4.addback_rects(lv, p, torch.zeros((2, 4), **i32),
                         torch.zeros(2, **i32), torch.zeros(2, **i32))
    with pytest.raises(TypeError):
        k4.addback_rects(lv, p, torch.zeros((2, 3), **i32),
                         torch.zeros(2, **i32),
                         torch.zeros(2, dtype=torch.int64, device=cuda))
    with pytest.raises(TypeError):
        k4.addback_rects(lv, p.double(), torch.zeros((2, 3), **i32),
                         torch.zeros(2, **i32), torch.zeros(2, **i32))
    with pytest.raises(ValueError):
        k4.addback_rects(torch.zeros(200, device=cuda)[::2], p,
                         torch.zeros((2, 3), **i32), torch.zeros(2, **i32),
                         torch.zeros(2, **i32))



@pytest.mark.parametrize("n,crq,l_pad,bt", [
    (1000, 300, 37, 3), (5000, 1024, 128, 8), (3000, 77, 2048, 2),
    (10, 9, 1, 5)])
def test_runs_read_kernel_batched_matches_plain(cuda, n, crq, l_pad, bt):
    """K3 with a batch axis, one launch: equal to the plain version and to
    a loop of one-system launches; a run near the end of a system reads
    zeros there, never the next system's head."""
    rng = np.random.default_rng(n + crq + bt)
    lv = torch.as_tensor(rng.standard_normal((bt, n)).astype(np.float32),
                         device=cuda)
    stf = rng.integers(0, n, crq).astype(np.int32)
    stf[::5] = -1
    stf[1::7] = n - 1
    stf = torch.as_tensor(stf, device=cuda)
    before = k3.LAUNCHES
    out = k3.runs_read(lv, stf, l_pad)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == before + 1
    assert out.shape == (bt, crq, l_pad)
    assert torch.equal(out, k3.runs_read_reference(lv, stf, l_pad))
    assert torch.equal(out, torch.stack([k3.runs_read(lv[i], stf, l_pad)
                                         for i in range(bt)]))


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("bt,st,rd,wt,n", [
    (3, 37, 130, 5, 9000), (8, 9, 300, 33, 20000), (2, 2, 1000, 32, 3000),
    (5, 3, 129, 70, 12000)])
def test_addback_rects_kernel_batched_matches_plain(cuda, bt, st, rd, wt, n,
                                                    idx):
    """The rect entry with a batch axis, one launch through each wrapper:
    against its batched plain version, system by system against its
    one-system launch, runs cut by the end of each system's ``lvals``
    dropped there (an odd ``n`` misaligns every system after the first)."""
    rng = np.random.default_rng(bt * st + rd)
    n += 1
    p = torch.as_tensor(rng.standard_normal((bt, st, rd, wt)).astype(
        np.float32), device=cuda)
    tcp = torch.as_tensor(rng.integers(0, n, (st, wt)), device=cuda).to(idx)
    tnr = torch.as_tensor(rng.integers(0, rd + 1, st), device=cuda).to(idx)
    twd = torch.as_tensor(rng.integers(0, wt + 1, st), device=cuda).to(idx)
    tnr[0], twd[0] = rd, wt
    tcp[0, 0] = n - 3
    lv0 = torch.as_tensor(rng.standard_normal((bt, n)).astype(np.float32),
                          device=cuda)
    ref = k4.addback_rects_reference(lv0.clone(), p, tcp, tnr, twd)
    before = k4.LAUNCHES
    out = k4.addback_rects(lv0.clone(), p, tcp, tnr, twd)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1
    _tight(out, ref)
    for i in range(bt):
        _tight(out[i], k4.addback_rects(lv0[i].clone(), p[i], tcp, tnr,
                                        twd))


def test_span_entry_takes_one_system_on_the_card(cuda):
    """The span entries are not on the batched path: a batch raises."""
    i32 = dict(dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one system"):
        k4.addback_resident(torch.zeros((2, 100), device=cuda),
                            torch.zeros((2, 4, 8), device=cuda),
                            torch.zeros(4, **i32))
    with pytest.raises(ValueError, match="one system"):
        k5.panel_addback(torch.zeros((2, 100), device=cuda),
                         torch.zeros((2, 2, 3, 8), device=cuda),
                         torch.zeros((2, 3), **i32), torch.zeros(2, **i32))


def _lap3(k):
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        a = np.take(idx, range(k - 1), axis=ax).ravel()
        b = np.take(idx, range(1, k), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    return (n, np.concatenate(r), np.concatenate(c),
            np.concatenate(v).astype(np.float32))


@pytest.mark.parametrize("gather,scatter", [
    ("kernel", "auto"), ("kernel", "vmem"), ("kernel", "pallas"),
    ("kernel", "delta"), ("element", "element"), ("window", "vmem"),
])
def test_supernodal_factor_on_card_matches_cpu(cuda, gather, scatter):
    """The factor of an ND-ordered 10³ Laplacian on the card (kernels)
    equals the one on the CPU (plain versions)."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops import reorder

    n, r, c, v = _lap3(10)
    old = cfgmod.get_config()
    cfgmod.set_config(dataclasses.replace(
        old, supernodal_gather=gather, supernodal_scatter=scatter))
    try:
        lv = {}
        for dev in ("cpu", cuda):
            a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
            a = reorder.permute_symmetric(a, reorder.nd_permutation(a))
            sched = sn.analyze_supernodal(a, relax=8)
            before = (k3.LAUNCHES, k4.LAUNCHES, k5.LAUNCHES)
            lv[str(dev)] = sn.factorize_supernodal(sched, a.values)
            got = (k3.LAUNCHES - before[0], k4.LAUNCHES - before[1],
                   k5.LAUNCHES - before[2])
        torch.cuda.synchronize()
    finally:
        cfgmod.set_config(old)
    levels = sum(int(sched.tabs[gi][0].shape[0])
                 for gi in range(sched.n_groups)
                 if sn._group_delta(sched, gi, scatter) == "rects")
    assert (got[0] > 0) == (gather in ("kernel", "auto"))
    assert got[1:] == (levels, 0)
    assert (levels > 0) == (scatter in ("auto", "vmem", "pallas"))
    _close(lv[str(cuda)], lv["cpu"].to(cuda))



@pytest.mark.parametrize("gather,scatter", [
    ("kernel", "auto"), ("kernel", "vmem"), ("kernel", "pallas"),
    ("window", "delta"), ("element", "element"),
])
def test_batched_supernodal_on_card_launches_as_one_system(cuda, gather,
                                                           scatter):
    """A batch of 4 value sets of the ND-ordered 10³ Laplacian on the card
    launches K3 and the add-back exactly as often as one system, and each
    system's factor matches its single-system factor on the card and the
    batched factor on the CPU (plain versions)."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops import reorder

    n, r, c, v = _lap3(10)
    old = cfgmod.get_config()
    cfgmod.set_config(dataclasses.replace(
        old, supernodal_gather=gather, supernodal_scatter=scatter))
    try:
        lv, counts = {}, {}
        for dev in ("cpu", cuda):
            a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
            a = reorder.permute_symmetric(a, reorder.nd_permutation(a))
            sched = sn.analyze_supernodal(a, relax=8)
            rows = torch.repeat_interleave(
                torch.arange(n, device=a.device), a.indptr.diff())
            eye = (a.indices == rows).float()
            vals = torch.stack([a.values * (1 + 0.25 * b) + 0.5 * b * eye
                                for b in range(4)])
            for name, arg in (("batch", vals), ("one", vals[0])):
                before = (k3.LAUNCHES, k4.LAUNCHES, k5.LAUNCHES)
                lv[str(dev), name] = sn.factorize_supernodal(sched, arg)
                counts[str(dev), name] = (
                    k3.LAUNCHES - before[0], k4.LAUNCHES - before[1],
                    k5.LAUNCHES - before[2])
            singles = [sn.factorize_supernodal(sched, vals[b])
                       for b in range(4)]
            lv[str(dev), "singles"] = torch.stack(singles)
        torch.cuda.synchronize()
    finally:
        cfgmod.set_config(old)
    dev = str(cuda)
    assert counts[dev, "batch"] == counts[dev, "one"]
    assert (counts[dev, "one"][0] > 0) == (gather == "kernel")
    assert (counts[dev, "one"][1] + counts[dev, "one"][2] > 0) == (
        scatter in ("auto", "vmem", "pallas"))
    assert lv[dev, "batch"].shape == (4, sched.nnz_l)
    _close(lv[dev, "batch"], lv[dev, "singles"])
    _close(lv[dev, "batch"], lv["cpu", "batch"].to(cuda))

# ---- K6: per-entry FMA ------------------------------------------------------
def _entries(rng, entries, rows, lanes, dev, hot=None):
    ii = rng.integers(0, rows, entries)
    if hot is not None:
        ii[:] = hot
    kk = rng.integers(0, rows, entries)
    vv = rng.standard_normal(entries)
    b = rng.standard_normal((rows, lanes))
    return (torch.as_tensor(ii.astype(np.int32), device=dev),
            torch.as_tensor(kk.astype(np.int32), device=dev),
            torch.as_tensor(vv.astype(np.float32), device=dev),
            torch.as_tensor(b.astype(np.float32), device=dev))


@pytest.mark.parametrize(
    "entries,rows,lanes,hot",
    [
        (8192, 4096, 128, None),   # the probe's default shape
        (8192, 4096, 512, None),   # the streaming kernel's width
        (1001, 37, 128, None),     # ragged E, heavy repeats
        (777, 50, 100, None),      # lanes % 32 != 0, still float4 rows
        (513, 64, 30, None),       # lanes % 4 != 0: the scalar kernel
        (300, 20, 1, None),        # one lane
        (8192, 4096, 128, 7),      # every entry into one row
        (4096, 16, 33, 15),        # one hot row, scalar kernel, last row
        (0, 8, 16, None),          # no entries: C is cleared
        (1, 1, 4, None),
        (5000, 4096, 4096, None),  # a 64 MiB tile, over the L2
    ],
)
def test_entry_fma_kernel_matches_plain(cuda, entries, rows, lanes, hot):
    """Tolerance: the adds come in no fixed order; the probe's own bound,
    max abs error < 1e-4, scaled by the largest magnitude where one row
    takes thousands of entries."""
    rng = np.random.default_rng(7)
    ii, kk, vv, b = _entries(rng, entries, rows, lanes, cuda, hot)
    before = k6.LAUNCHES
    out = k6.entry_fma(ii, kk, vv, b, rows)
    torch.cuda.synchronize()
    assert k6.LAUNCHES == before + 1
    ref = k6.entry_fma_reference(ii, kk, vv, b, rows)
    assert out.shape == ref.shape == (rows, lanes)
    ref64 = torch.zeros((rows, lanes), dtype=torch.float64, device=cuda)
    ref64.index_add_(0, ii, vv.double()[:, None] * b.double()[kk.long()])
    scale = max(float(ref64.abs().max()), 1.0) if entries else 1.0
    assert float((out - ref).abs().max()) < 1e-4 * scale
    assert float((out.double() - ref64).abs().max()) < 1e-4 * scale


def test_entry_fma_unaligned_b_takes_the_scalar_kernel(cuda):
    """A ``b`` whose storage starts off a 16-byte boundary cannot take the
    float4 loads; the wrapper must pick the scalar kernel, not fault."""
    rng = np.random.default_rng(8)
    ii, kk, vv, b = _entries(rng, 500, 40, 64, cuda)
    flat = torch.zeros(40 * 64 + 1, device=cuda)
    flat[1:] = b.reshape(-1)
    b_off = flat[1:].view(40, 64)
    assert b_off.data_ptr() % 16 != 0 and b_off.is_contiguous()
    out = k6.entry_fma(ii, kk, vv, b_off, 40)
    torch.cuda.synchronize()
    _close(out, k6.entry_fma_reference(ii, kk, vv, b, 40))


def test_entry_fma_raises_on_cuda_misuse(cuda):
    rng = np.random.default_rng(9)
    ii, kk, vv, b = _entries(rng, 64, 32, 128, cuda)
    before = k6.LAUNCHES
    with pytest.raises(TypeError):
        k6.entry_fma(ii.long(), kk, vv, b, 32)
    with pytest.raises(IndexError):
        k6.entry_fma(ii + 32, kk, vv, b, 32)
    with pytest.raises(ValueError):
        k6.entry_fma(ii, kk, vv, b.t().contiguous().t(), 32)
    with pytest.raises(ValueError):
        k6.entry_fma(ii, kk, vv, b.cpu(), 32)
    assert k6.LAUNCHES == before


def test_entry_fma_probe_runs_on_the_card(cuda):
    from basic_sparse_matrix_tpu_torch.probes import entry_fma_probe as probe

    assert probe.check(*probe.CHECK_SHAPE, cuda) < 1e-4
    res = probe.measure(8192, 4096, 128, cuda, iters=5)
    assert res["value"] > 0 and res["stream_kernel_ns"] > 0
    assert res["max_abs_err"] < 1e-4 and res["stream_max_abs_err"] < 1e-4
    assert res["kernel_ms"] > 0 and res["call_ms"] > 0


def test_stream_slice_probe_runs_on_the_card(cuda):
    from basic_sparse_matrix_tpu_torch.probes import stream_slice_probe as sp

    assert sp.l2_gather_gbps(1 << 20, cuda, iters=64) > 0
    plan, b = sp.make_operand(20_000, 16, 64, cuda)
    reports = sp.sweep(plan, b, iters=2)
    assert [r["kernel"] for r in reports] == ["tile", "sliced"]
    assert all(r["ms"] > 0 for r in reports)
    assert all(r["max_abs_err_vs_tile"] < 1e-4 and r["bitwise_repeatable"]
               for r in reports if r["kernel"] == "sliced")
    long = sp.long_row_report(20_000, 16, 64, 700, cuda, iters=2)
    assert long["longest_row"] == 700 and long["max_abs_err_vs_tile"] < 1e-4
    assert long["tile"]["ms"] > 0 and long["sliced"]["ms"] > 0
