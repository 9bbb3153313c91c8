"""K8, the ELL product (``csrc/ell_spmm.cu``), on the card (this file
imports no JAX; every case is ``cuda``-marked and skips without a CUDA
device; the CPU side of ``ops/ell.py`` is tested in ``test_ell.py``).

K8 against its plain version (the gather + multiply + row sum that
``ops/ell.py`` runs off the card, forced onto the same CUDA operands) for N
= 1 as a 1-D ``x`` and N = 2, 3, 31, 32, 33, 64, 100 at widths 1, 13 and
27, on ELL layouts with ragged rows (padding slots inside the width), empty
rows (every slot padding) and zero rows (stored values 0); a 0-row layout;
non-contiguous operands (a column slice, strided columns, a transposed B,
a strided ``x``) and the lane shape the launcher takes for each; padding
read as ``0 · B[0]`` (a non-finite ``B[0]`` makes the padded rows NaN, as
in the plain version); two calls bit for bit; K8 captured in a CUDA graph
(``runtime/graphs.py::run``) and replayed on new operands, equal to the
eager call bit for bit, with ``ell.launches`` added at each replay.

Tolerance of K8 against the plain version: both sum a row's ``width``
products in float32, K8 as one fma chain in slot order (N > 1) or lane
sums joined by a butterfly (N = 1), the plain version as rounded products
summed by ``torch.sum`` in its own order. Each differs from the exact sum
by at most ``width · 2⁻²⁴`` times the row's sum of magnitudes
``Σ_k |vals[r, k]·B[cols[r, k], j]|``, so the two differ by at most twice
that: the bound checked, entry by entry.

IC(0)-PCG (20 iterations) and one HPCG V-cycle (4 levels) at 16³ run
through K8 on the card and through the plain version, each against the
float64 reference (``portbench/reference/ic0_pcg.py``,
``torch_mg_reference.py``): K8's error ≤ ``RTOL`` (2e-6 of ‖ref‖∞, the
multigrid tests' float32-against-float64 limit) and within ``ORDER`` times
the plain version's error (both are float32's rounding carried through
the iterations; K8 changes only the order of each row's sum).
``LAUNCHES`` and ``ell.launches`` show that the path went through K8
(one a PCG iteration, 13 a V-cycle), and ``ell.plain`` that nothing took
the plain version. A layout with a column outside [0, n_cols) raises
before K8 launches.
"""

import copy

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
import torch_mg_reference as R
from basic_sparse_matrix_tpu_torch.models import multigrid as pmg
from basic_sparse_matrix_tpu_torch.models import pcg as ppcg
from basic_sparse_matrix_tpu_torch.ops import ell as pe
from basic_sparse_matrix_tpu_torch.probes.trsv_probe import hpcg27
from basic_sparse_matrix_tpu_torch.runtime import cuda_kernels, graphs
from basic_sparse_matrix_tpu_torch.runtime import profiling as prof
from basic_sparse_matrix_tpu_torch.utils import config as pcfg
from portbench.reference import ic0_pcg, stencil
from portbench.reference.precision import FLOAT64

RTOL = 2e-6
VCYCLE_SPMVS = 3 * 4 + 1
ORDER = 4.0
EPS32 = 2.0 ** -24


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU where they do not name a device, and hand the previous
    default back afterwards."""
    with pcfg.use_device("cpu"):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _layout(rng, rows, k, width, device, first_col=0):
    """A seeded ELL of ``rows`` rows over columns [``first_col``, ``k``):
    ragged rows (padding slots, col 0 val 0, after each row's own length),
    every seventh row empty (all padding), every eleventh a zero row
    (stored values 0)."""
    lens = rng.integers(0, width + 1, rows)
    lens[::7] = 0
    live = np.arange(width)[None, :] < lens[:, None]
    cols = np.where(live, rng.integers(first_col, k, (rows, width)), 0)
    vals = np.where(live, rng.standard_normal((rows, width)), 0.0)
    vals[5::11] = 0.0
    return pe.ELL(cols=torch.as_tensor(cols.astype(np.int32), device=device),
                  vals=torch.as_tensor(vals.astype(np.float32),
                                       device=device),
                  n_cols=k)


def _plain(fn, ell, b):
    """The plain version of ``fn`` (``spmm_ell`` or ``spmv_ell``) on the
    same operands."""
    return {pe.spmm_ell: pe.spmm_ell_plain,
            pe.spmv_ell: pe.spmv_ell_plain}[fn](ell, b)


def _bound(ell, b):
    """Twice ``width · 2⁻²⁴`` times each entry's sum of magnitudes."""
    cols = ell.cols.long()
    mags = (ell.vals.double().abs().unsqueeze(-1)
            * b.double().abs().reshape(b.shape[0], -1)[cols]).sum(1)
    return 2 * max(ell.width, 1) * EPS32 * mags.reshape(
        (ell.n_rows, *b.shape[1:]))


def _k8(fn, ell, b):
    """``fn`` on K8, with the launches it made (``LAUNCHES`` and the
    recorder's ``ell.launches``) checked to be one, ``ell.plain`` none."""
    before = pe.LAUNCHES
    with prof.recording():
        out = fn(ell, b)
    c = prof.snapshot().counters
    assert pe.LAUNCHES == before + 1
    assert c.get("ell.launches") == 1 and "ell.plain" not in c
    assert c.get("ell.products") == 1
    return out


def _near(got, want, bound):
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    err = (got.double() - want.double()).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


N_CASES = ["1 (x)", 2, 3, 31, 32, 33, 64, 100]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 13, 27])
@pytest.mark.parametrize("n", N_CASES)
def test_k8_matches_plain(cuda, n, width):
    rng = np.random.default_rng(width * 1000 + (1 if n == "1 (x)" else n))
    ell = _layout(rng, 3001, 2500, width, cuda)
    if n == "1 (x)":
        fn, b = pe.spmv_ell, torch.randn(2500, device=cuda)
    else:
        fn, b = pe.spmm_ell, torch.randn(2500, n, device=cuda)
    got = _k8(fn, ell, b)
    _near(got, _plain(fn, ell, b), _bound(ell, b))
    assert torch.equal(got, fn(ell, b))      # no atomics: bit for bit
    empty = torch.arange(3001, device=cuda) % 7 == 0
    assert not got[empty].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [None, 1, 32])
def test_k8_on_a_layout_without_rows(cuda, n):
    ell = pe.ELL(cols=torch.zeros((0, 5), dtype=torch.int32, device=cuda),
                 vals=torch.zeros((0, 5), device=cuda), n_cols=9)
    b = torch.randn(9, device=cuda) if n is None else \
        torch.randn(9, n, device=cuda)
    before = pe.LAUNCHES
    out = (pe.spmv_ell if n is None else pe.spmm_ell)(ell, b)
    assert out.shape == (0, *b.shape[1:]) and pe.LAUNCHES == before


def _shape(b, out):
    """(team lanes, lane width) that the launcher takes for ``b``, ``out``."""
    lib = cuda_kernels.load()
    got = np.zeros(2, np.int32)
    n = 1 if b.ndim == 1 else int(b.shape[1])
    lib.bsm_ell_spmm_shape(b.data_ptr(), out.data_ptr(), 27, n, b.stride(0),
                           b.stride(1) if b.ndim == 2 else 1,
                           out.stride(0), got.ctypes.data)
    return tuple(int(v) for v in got)


@pytest.mark.cuda
@pytest.mark.parametrize("view,shape", [
    ("contiguous", (8, 4)),           # N = 32: 8 lanes of 16 bytes a row
    ("column slice", (32, 1)),        # rows 70 floats apart, offset 3
    ("strided columns", (32, 1)),     # every second column
    ("transposed", (32, 1)),          # B = M.t()
    ("x strided", (32, 1)),           # x a column of a matrix, width 27
])
def test_k8_on_non_contiguous_operands(cuda, view, shape):
    rng = np.random.default_rng(17)
    ell = _layout(rng, 1500, 700, 27, cuda)
    big = torch.randn(700, 70, device=cuda)
    b = {"contiguous": big[:, :32].contiguous(),
         "column slice": big[:, 3:35],
         "strided columns": big[:, ::2][:, :32],
         "transposed": torch.randn(32, 700, device=cuda).t(),
         "x strided": big[:, 5]}[view]
    fn = pe.spmv_ell if b.ndim == 1 else pe.spmm_ell
    got = _k8(fn, ell, b)
    assert _shape(b, got) == shape
    _near(got, _plain(fn, ell, b.contiguous()), _bound(ell, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", ["1 (x)", 3, 32])
def test_k8_reads_padding_as_zero_times_b0(cuda, n):
    rng = np.random.default_rng(23)
    ell = _layout(rng, 400, 300, 13, cuda, first_col=1)  # padding: col 0
    if n == "1 (x)":
        fn, b = pe.spmv_ell, torch.randn(300, device=cuda)
    else:
        fn, b = pe.spmm_ell, torch.randn(300, n, device=cuda)
    b[0] = float("inf")
    got, want = _k8(fn, ell, b), _plain(fn, ell, b)
    padded = ((ell.cols == 0) & (ell.vals == 0)).any(1)
    nan = torch.isnan(got) if got.ndim == 1 else torch.isnan(got).all(1)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(nan, padded) and bool(padded.any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", ["1 (x)", 32])
def test_k8_captured_and_replayed(cuda, n):
    rng = np.random.default_rng(29)
    ell = _layout(rng, 5000, 5000, 27, cuda)
    fn = pe.spmv_ell if n == "1 (x)" else pe.spmm_ell
    shape = (5000,) if n == "1 (x)" else (5000, n)
    owner = type("Owner", (), {})()
    bs = [torch.randn(shape, device=cuda) for _ in range(4)]
    twice = lambda b: fn(ell, fn(ell, b) if b.ndim == 1 else b)  # noqa: E731
    pe.check_cols(ell)        # a host read, so not inside the capture
    graphs.run(owner, "k8", twice, bs[0])          # captures
    before = pe.LAUNCHES
    with prof.recording():
        outs = [graphs.run(owner, "k8", twice, b) for b in bs]
    c = prof.snapshot().counters
    assert c["graphs.replays"] == 4 and c.get("graphs.captures", 0) == 0
    per_call = 2 if n == "1 (x)" else 1
    assert c["ell.launches"] == 4 * per_call and "ell.plain" not in c
    assert pe.LAUNCHES == before                   # replays launch no call
    for b, out in zip(bs, outs):
        assert torch.equal(out, twice(b))


def _err(got, want):
    return float((got.double().cpu() - want.double().cpu()).abs().max()
                 / want.abs().max())


def _operator(dims, device):
    n = int(np.prod(dims))
    return P.CSR.from_host(*R.csr(dims), (n, n), device=device)


HPCG16 = {"nx": 16, "ny": 16, "nz": 16, "stencil_points": 27,
          "diagonal": 26.0, "off_diagonal": -1.0}


@pytest.mark.cuda
def test_ic0_pcg_on_hpcg_16_through_k8(cuda, monkeypatch):
    a = hpcg27(16, cuda)
    setup = ppcg.PCGSetup.build(a)
    assert setup.ell is not None
    xs = torch.randn(a.rows, generator=torch.Generator().manual_seed(3),
                     dtype=torch.float64)
    b64 = stencil.apply(HPCG16, xs, FLOAT64)
    want = ic0_pcg.pcg(HPCG16, b64[:, None], 20, FLOAT64)[:, 0]
    b = b64.float().to(cuda)
    ppcg.pcg_solve(a, b, tol=0.0, max_iters=20, setup=setup)   # captures
    with prof.recording():
        x, it, _ = ppcg.pcg_solve(a, b, tol=0.0, max_iters=20, setup=setup)
    c = prof.snapshot().counters
    assert it == 20 and c.get("graphs.captures", 0) == 0
    assert c["ell.launches"] == c["ell.products"] == 20   # A·p a step
    assert "ell.plain" not in c
    monkeypatch.setattr(pe, "_on_k8", lambda *_: False)
    xp, itp, _ = ppcg.pcg_solve(a, b, tol=0.0, max_iters=20,
                                setup=copy.copy(setup))   # a new graph owner
    assert itp == it
    err, err_plain = _err(x, want), _err(xp, want)
    assert err <= RTOL and err <= ORDER * err_plain, (err, err_plain)


@pytest.mark.cuda
def test_vcycle_on_hpcg_16_through_k8(cuda, monkeypatch):
    dims = (16, 16, 16)
    grids = R.hierarchy(dims, 4)
    ops = [_operator(d, cuda) for d in grids]
    setup = pmg.MultigridSetup.build(
        ops, [pmg.injection_map(d, cuda) for d in grids[:-1]])
    r = torch.randn(ops[0].rows, generator=torch.Generator().manual_seed(11),
                    dtype=torch.float64)
    want = R.MG(dims, 4).vcycle(r)
    before = pe.LAUNCHES
    with prof.recording():
        got = setup.apply_m_inv(r.float().to(cuda))      # captures
        again = setup.apply_m_inv(r.float().to(cuda))    # replays
    c = prof.snapshot().counters
    assert pe.LAUNCHES > before
    # 13 a V-cycle: on each of the 3 finer grids the pre-smoothing's
    # backward sweep, the residual and the post-smoothing's two sweeps
    # (models/multigrid.py); one backward sweep on the coarsest
    assert c["ell.launches"] == c["ell.products"] == 2 * VCYCLE_SPMVS
    assert "ell.plain" not in c
    assert torch.equal(got, again)
    monkeypatch.setattr(pe, "_on_k8", lambda *_: False)
    plain = copy.copy(setup)                          # a new graph owner
    got_plain = plain.apply_m_inv(r.float().to(cuda))
    err, err_plain = _err(got, want), _err(got_plain, want)
    assert err <= RTOL and err <= ORDER * err_plain, (err, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [-1, 2500])
@pytest.mark.parametrize("n", ["1 (x)", 32])
def test_k8_refuses_a_column_out_of_range(cuda, n, bad):
    """K8 reads the operand's rows unchecked: a layout with a column
    outside [0, n_cols) raises before any launch, at its first product."""
    rng = np.random.default_rng(31)
    ell = _layout(rng, 300, 2500, 13, cuda)
    ell.cols[9, 0] = bad
    fn = pe.spmv_ell if n == "1 (x)" else pe.spmm_ell
    b = torch.randn(2500, device=cuda) if n == "1 (x)" else \
        torch.randn(2500, n, device=cuda)
    before = pe.LAUNCHES
    with pytest.raises(ValueError, match="column indices span"):
        fn(ell, b)
    assert pe.LAUNCHES == before and not ell._cols_ok
