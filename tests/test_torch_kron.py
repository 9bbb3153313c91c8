"""GAP's ``kron`` PageRank product in the port (this file imports no JAX):
the generator (``portbench/kron.py``), the split rung (``ops/split.py``)
and the 1-D entry (``SparseOperator.matvec``).

CPU cases: the generator's invariants at scales 8–12 (symmetric, no
self-loops or duplicates, n = 2^scale, values 1/deg); the split layout's
plain version, ``matvec`` and ``matmul`` at N = 1 and N = 8 against
``torch_kron_reference.py`` (float64 from the edge list); at widths 2 and
4 a hub spanning several combine passes; the CPU ladder's rung unchanged.

Card cases (``cuda``-marked, skip without a CUDA device): the split rung
against the reference at scale 20, two products bit for bit, the memory a
product allocates (its output and the sums buffer), the recorder's
``spmm.rung.split`` and K8 launch counts, and ``matvec`` of any other dtype
pair taking no rung and keeping the vector's dtype, equal to the CPU's
``spmv`` (which the CPU tests hold to the JAX package's ``mul_vector``).

Tolerance: a row's sum is a tree of at most ``width``-long float32 runs
over its pieces, so it differs from the exact sum by at most
``(width · levels) · 2⁻²⁴`` of the row's sum of magnitudes; the rows'
magnitudes are positive here (``x > 0``, values 1/deg), so the check is
relative to the reference row by row, with ``RTOL`` above that bound.
"""

import importlib

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
import torch_kron_reference as R
from basic_sparse_matrix_tpu_torch.ops import ell as pe
from basic_sparse_matrix_tpu_torch.ops import split as ps
from basic_sparse_matrix_tpu_torch.runtime import profiling as prof
from basic_sparse_matrix_tpu_torch.utils import config as pcfg
from portbench import kron
from portbench.reference import graph

RTOL = 1e-5
pspmm = importlib.import_module("basic_sparse_matrix_tpu_torch.ops.spmm")


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


def _config(scale, seed=27491):
    return {"scale": scale, "edge_factor": 16,
            "initiator": [0.57, 0.19, 0.19], "graph_seed": seed}


_GRAPHS = {}


def _graph(scale, device="cpu"):
    key = (scale, str(device))
    if key not in _GRAPHS:
        _GRAPHS[key] = kron.csr(_config(scale), device)
    return _GRAPHS[key]


def _arcs(indptr, indices):
    return np.repeat(np.arange(indptr.size - 1), np.diff(indptr)), \
        indices.astype(np.int64)


def _operand(n, cols, seed=5, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    shape = (n,) if cols is None else (n, cols)
    x = torch.rand(shape, generator=g, dtype=torch.float64) + 0.5
    return (x / x.sum(0)).float().to(device)


def _close(got, ref):
    """Row by row within ``RTOL`` of the reference, the benchmark's
    comparison (``x`` > 0 and values 1/deg, so each row's scale is its
    reference); an empty row exactly 0."""
    got = got.detach().cpu()
    assert got.shape == ref.shape
    err = graph.row_error(got, ref, ref.abs())
    assert err <= RTOL, err


@pytest.mark.parametrize("scale", [8, 9, 10, 11, 12])
def test_generator_invariants(scale):
    indptr, indices, values = _graph(scale)
    n = 1 << scale
    assert indptr.shape == (n + 1,) and indptr.dtype == np.int32
    src, dst = _arcs(indptr, indices)
    assert not np.any(src == dst)
    keys = src * n + dst
    assert np.all(np.diff(keys) > 0)            # sorted, no duplicates
    back = np.sort(dst * n + src)
    assert np.array_equal(back, keys)           # symmetric
    deg = np.diff(indptr)
    assert np.array_equal(values, (1.0 / deg[dst]).astype(np.float32))
    assert indices.size > 8 * n                 # about 16 n arcs less loops
    assert kron.stats(indptr)["ell_overhead"] > 4


def test_the_cpu_refuses_the_cards_scale():
    with pytest.raises(ValueError):
        kron.arcs(_config(kron.CPU_MAX_SCALE + 1), "cpu")


def test_generator_is_fixed_by_its_seed():
    a = kron.csr(_config(9), "cpu")
    b = kron.csr(_config(9), "cpu")
    c = kron.csr(_config(9, seed=1), "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])


def _csr(scale, device="cpu"):
    indptr, indices, values = _graph(scale)
    n = indptr.size - 1
    return P.CSR.from_host(indptr, indices, values, (n, n), device=device)


@pytest.mark.parametrize("cols", [None, 8])
@pytest.mark.parametrize("width", [2, 4, 16, 32])
def test_split_plain_version_against_the_reference(width, cols):
    a = _csr(11)
    x = _operand(a.cols, cols)
    ref = R.product(*_arcs(*_graph(11)[:2]), a.rows, x)
    _close(ps.spmm_split(ps.build(a, width), x), ref)


@pytest.mark.parametrize("width", [2, 4])
def test_a_hub_spans_several_combine_passes(width):
    a = _csr(10)
    split = ps.build(a, width)
    longest = int(torch.diff(a.indptr).max())
    passes = 1
    while longest > width:
        longest = -(-longest // width)
        passes += 1
    assert len(split.passes) == passes and passes >= 4
    assert split.out.n_rows == a.rows and split.out.width == 1
    x = _operand(a.cols, None)
    with prof.recording():
        y = ps.spmm_split(split, x)
    c = prof.snapshot().counters
    assert c["split.levels"] == passes and c["ell.plain"] == passes + 1
    assert c["split.entries"] == a.stored
    assert c["split.slots"] == split.slots
    assert c["split.pieces"] == split.pieces
    _close(y, R.product(*_arcs(*_graph(10)[:2]), a.rows, x))


def test_split_width_must_join_sums():
    with pytest.raises(ValueError):
        ps.build(_csr(8), 1)


@pytest.mark.parametrize("cols", [None, 8])
def test_matvec_and_matmul_on_the_cpu_against_the_reference(cols):
    a = _csr(12)
    op = P.SparseOperator(a)
    x = _operand(a.cols, cols)
    ref = R.product(*_arcs(*_graph(12)[:2]), a.rows, x)
    with prof.recording():
        y = op.matvec(x) if cols is None else op.matmul(x)
    snap = prof.snapshot()
    _close(y, ref)
    assert snap.requests() == 1
    # the CPU keeps the JAX package's rungs: spmv for a vector, the
    # ladder's plain rung for a block; never the split rung
    assert a._split_cache is None
    assert (snap.counters == {}) == (cols is None)
    assert not any("split" in k for k in snap.counters)


def test_cpu_rung_unchanged_and_overhead_memoised():
    a = _csr(14)
    b = torch.ones(a.cols, 4)
    assert a.get_density() < pcfg.get_config().dense_dispatch_density
    assert pspmm._rung(a, b) == "gather"
    assert pspmm._rung(a, b[:, 0]) == "gather"
    want = a.rows * int(np.diff(a.numpy()[0]).max()) / a.stored
    assert pe.ell_overhead(a) == want == a._ell_overhead
    a._ell_overhead = 1.0       # the memo is what the dispatch reads
    assert pspmm._rung(a, b) == "ell"


# ---------------------------------------------------------------- card --
SCALE_CARD = 20


@pytest.fixture(scope="module")
def card_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    indptr, indices, values = kron.csr(_config(SCALE_CARD), dev)
    n = indptr.size - 1
    a = P.CSR.from_host(indptr, indices, values, (n, n), device=dev)
    return a, _arcs(indptr, indices)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [None, 8])
def test_split_rung_on_the_card_against_the_reference(cuda, card_graph,
                                                      cols):
    a, arcs = card_graph
    x = _operand(a.cols, cols, device=cuda)
    with prof.recording():
        y = P.SparseOperator(a).matvec(x) if cols is None \
            else P.SparseOperator(a).matmul(x)
    torch.cuda.synchronize()
    c = prof.snapshot().counters
    assert c["spmm.rung.split"] == 1
    assert c["ell.launches"] == c["ell.products"] == \
        len(a._split_cache.passes) + 1
    assert "ell.plain" not in c
    assert c["split.levels"] == len(a._split_cache.passes)
    _close(y, R.product(*arcs, a.rows, x.cpu()))


@pytest.mark.cuda
def test_split_products_bit_for_bit_and_their_memory(cuda, card_graph):
    a, _ = card_graph
    split = ps.cached_split(a)
    x = _operand(a.cols, None, device=cuda)
    first = ps.spmm_split(split, x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    second = ps.spmm_split(split, x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    grew = torch.cuda.max_memory_allocated() - base
    # the output and the sums buffer, each rounded up by the caching
    # allocator to its 2 MiB blocks
    allowed = 4 * (a.rows + split.n_sums) + 2 * (2 << 20)
    assert grew <= allowed, (grew, allowed)


@pytest.mark.cuda
@pytest.mark.parametrize("mat,vec", [("int32", "int32"),
                                     ("int32", "int64"),
                                     ("int32", "float32"),
                                     ("float32", "float64"),
                                     ("float32", "int32"),
                                     ("float32", "float32")])
def test_mul_vector_on_the_card_keeps_other_dtypes(cuda, mat, vec):
    # dense enough for the ladder's dense rung, which computes in float32:
    # only a float32 vector times a float32 matrix may take the ladder (the
    # CSR holds float32 or int32 values, as the JAX package does without
    # x64; the vector may be any dtype)
    rng = np.random.default_rng(7)
    d = np.where(rng.random((300, 300)) < 0.05,
                 rng.integers(1, 10, (300, 300)), 0).astype(mat)
    x = torch.from_numpy(rng.integers(-9, 10, 300).astype(vec))
    on_cpu = pspmm.spmv(P.CSR.from_dense(d), x)
    a = P.CSR.from_dense(d, device=cuda)
    assert a.dtype == getattr(torch, mat)
    assert a.get_density() >= pcfg.get_config().dense_dispatch_density
    with prof.recording():
        y = P.SparseOperator(a).matvec(x.to(cuda))
    torch.cuda.synchronize()
    rungs = [k for k in prof.snapshot().counters if k.startswith("spmm.rung.")]
    assert rungs == (["spmm.rung.dense"] if mat == vec == "float32" else [])
    assert y.dtype == on_cpu.dtype == x.dtype
    assert y.is_cuda
    # small whole numbers: every sum is exact in each of these dtypes, so
    # the card's answer is the CPU's spmv exactly
    assert torch.equal(y.cpu(), on_cpu)
