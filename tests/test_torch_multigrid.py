"""HPCG's multigrid preconditioner in the port (``models/multigrid.py``)
against the plain-torch reference ``torch_mg_reference.py`` (float64, on
the grid; neither JAX nor the port), on the CPU at grids up to 16³.

* A forward sweep and a SymGS equal the literal row-by-row loop at 4³,
  from zero and from a nonzero start, and the reference's wavefront sweeps
  at 8³ and 16 × 8 × 24.
* ``injection_map`` is HPCG's ``f2c``; bad hierarchies are refused.
* One V-cycle at 2 and 4 levels, and at other smoothing steps.
* ``SparseOperator.solve_cg`` after ``use_multigrid`` against the
  reference's MG-PCG after 1, 3 and 50 iterations; without it, IC(0).
* The recorder counts ``mg.applies`` (iterations + 1) and ``mg.sweeps``
  (14 an application at 4 levels).
* ``CSR.triangle`` against numpy's ``tril``/``triu``.

Tolerance: float32 against float64, ‖x − x_ref‖∞ ≤ 2e-6·‖x_ref‖∞ (the
program reads within 3e-7 at these sizes).

The ``cuda``-marked cases run on the card (this file imports no JAX): the
chunk-graph loop equals the eager loop, and the counters add up through
the replays.
"""

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
import torch_mg_reference as R
from basic_sparse_matrix_tpu_torch.models import multigrid as pmg
from basic_sparse_matrix_tpu_torch.models import pcg as ppcg
from basic_sparse_matrix_tpu_torch.runtime import graphs
from basic_sparse_matrix_tpu_torch.runtime import profiling as prof
from basic_sparse_matrix_tpu_torch.utils import config as pcfg
from basic_sparse_matrix_tpu_torch.utils.errors import IncorrectDimensions

torch.set_num_threads(1)

RTOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    with pcfg.use_device("cpu"):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operator(dims, device="cpu"):
    n = int(np.prod(dims))
    return P.CSR.from_host(*R.csr(dims), (n, n), device=device)


def _setup(dims, levels, device="cpu"):
    grids = R.hierarchy(dims, levels)
    return pmg.MultigridSetup.build(
        [_operator(d, device) for d in grids],
        [pmg.injection_map(d, device) for d in grids[:-1]])


def _vec(n, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g, dtype=torch.float64).to(device)


def _err(got, want):
    return float((got.cpu().double() - want.cpu()).abs().max()
                 / want.abs().max())


# ---- sweeps -----------------------------------------------------------------
@pytest.mark.parametrize("start", ["zero", "nonzero"])
@pytest.mark.parametrize("what", ["forward", "symgs"])
def test_sweeps_equal_the_sequential_loop(what, start):
    dims = (4, 4, 4)
    setup = _setup(dims, 1)
    lv = setup.levels[0]
    r = _vec(64, 1)
    x0 = torch.zeros(64, dtype=torch.float64) if start == "zero" \
        else _vec(64, 2)
    want = R.symgs_sequential(*R.csr(dims), r.numpy(), x0.numpy(),
                              backward=what == "symgs")
    x = None if start == "zero" else x0.float()
    if what == "forward":
        got = pmg.MultigridSetup._forward(lv, r.float(), x)
    else:
        got = setup._symgs(lv, r.float(), x)
    assert _err(got, torch.from_numpy(want)) <= RTOL


def test_wavefronts_are_the_sequential_sweep():
    dims = (4, 4, 4)
    r, x0 = _vec(64, 3), _vec(64, 4)
    want = R.symgs_sequential(*R.csr(dims), r.numpy(), x0.numpy())
    got = R.Grid(dims).symgs(r, x0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("what", ["forward", "backward", "symgs"])
@pytest.mark.parametrize("dims", [(8, 8, 8), (16, 8, 24)])
def test_sweeps_match_the_reference(dims, what):
    setup = _setup(dims, 1)
    lv = setup.levels[0]
    grid = R.Grid(dims)
    r, x0 = _vec(grid.n, 5), _vec(grid.n, 6)
    if what == "forward":
        got = pmg.MultigridSetup._forward(lv, r.float(), x0.float())
        want = grid.sweep(r, x0, forward=True)
    elif what == "backward":
        got = pmg.MultigridSetup._backward(lv, r.float(), x0.float())
        want = grid.sweep(r, x0, forward=False)
    else:
        got = setup._symgs(lv, r.float(), x0.float())
        want = grid.symgs(r, x0)
    assert _err(got, want) <= RTOL


def test_the_sweeps_are_the_level_schedules_of_the_triangles():
    """Forward and backward sweeps walk x + 2y + 4z: 722 wavefronts at
    104³, here 4 + 2·7 + 4·11 + 1 = 63 at 5 × 8 × 12."""
    dims = (5, 8, 12)
    lv = _setup(dims, 1).levels[0]
    assert lv.fwd.n_levels == lv.bwd.n_levels == 63
    assert lv.lower.stored == lv.upper.stored
    assert lv.lower.stored * 2 + lv.a.rows == lv.a.stored


# ---- the hierarchy ----------------------------------------------------------
@pytest.mark.parametrize("dims", [(2, 2, 2), (4, 4, 4), (8, 8, 8),
                                  (16, 8, 24), (2, 4, 6)])
def test_injection_map_is_hpcg_f2c(dims):
    assert torch.equal(pmg.injection_map(dims), R.f2c(dims))


@pytest.mark.parametrize("dims", [(3, 4, 4), (4, 4, 1), (0, 2, 2)])
def test_injection_map_needs_even_dimensions(dims):
    with pytest.raises(IncorrectDimensions):
        pmg.injection_map(dims)


def _bad_maps(kind):
    fine, coarse = _operator((4, 4, 4)), _operator((2, 2, 2))
    f2c = pmg.injection_map((4, 4, 4))
    return {
        "a map too many": ([fine, coarse], [f2c, f2c]),
        "a map too short": ([fine, coarse], [f2c[:-1]]),
        "a repeated row": ([fine, coarse], [torch.cat([f2c[:-1],
                                                        f2c[:1]])]),
        "a row out of range": ([fine, coarse], [f2c + 64]),
    }[kind]


@pytest.mark.parametrize("kind", ["a map too many", "a map too short",
                                  "a repeated row", "a row out of range"])
def test_build_refuses_bad_hierarchies(kind):
    levels, maps = _bad_maps(kind)
    with pytest.raises(IncorrectDimensions):
        pmg.MultigridSetup.build(levels, maps)


# ---- the V-cycle ------------------------------------------------------------
@pytest.mark.parametrize("dims,levels,pre,post", [
    ((8, 8, 8), 2, 1, 1),
    ((16, 16, 16), 4, 1, 1),
    ((16, 8, 24), 4, 1, 1),
    ((16, 16, 16), 3, 2, 0),
    ((16, 16, 16), 3, 0, 2),
])
def test_one_vcycle_matches_the_reference(monkeypatch, dims, levels, pre,
                                          post):
    monkeypatch.setattr(pmg, "PRE_STEPS", pre)
    monkeypatch.setattr(pmg, "POST_STEPS", post)
    setup = _setup(dims, levels)
    mg = R.MG(dims, levels, pre, post)
    r = _vec(setup.a.rows, 7)
    assert _err(setup.apply_m_inv(r.float()), mg.vcycle(r)) <= RTOL


# ---- PCG --------------------------------------------------------------------
@pytest.fixture(scope="module")
def hpcg16():
    """HPCG's 4-level hierarchy at 16³: the port's operator with multigrid
    chosen, the reference's V-cycle, and a right-hand side b = A·x*."""
    dims = (16, 16, 16)
    grids = R.hierarchy(dims, 4)
    op = P.SparseOperator(_operator(dims))
    op.use_multigrid([_operator(d) for d in grids[1:]],
                     [pmg.injection_map(d) for d in grids[:-1]])
    mg = R.MG(dims, 4)
    return op, mg, mg.grids[0].apply(_vec(op.a.rows, 8))


@pytest.mark.parametrize("iters", [1, 3, 50])
def test_solve_cg_with_multigrid_matches_the_reference(hpcg16, iters):
    op, mg, b = hpcg16
    x, it, res = op.solve_cg(b.float(), tol=0.0, max_iters=iters)
    assert it == iters and isinstance(op.pcg_setup, pmg.MultigridSetup)
    assert _err(x, R.pcg(mg, b, iters)) <= RTOL
    assert 0 <= res < 1.0


def test_solve_cg_builds_ic0_unless_multigrid_is_chosen():
    a = _operator((4, 4, 4))
    op = P.SparseOperator(a)
    assert op.pcg_setup is None
    b = torch.ones(64)
    x, it, res = op.solve_cg(b, tol=1e-6, max_iters=100)
    assert isinstance(op.pcg_setup, ppcg.PCGSetup) and res <= 1e-6
    mg = op.use_multigrid([_operator((2, 2, 2))],
                          [pmg.injection_map((4, 4, 4))])
    assert op.pcg_setup is mg and mg.a is a
    x2, it2, res2 = op.solve_cg(b, tol=1e-6, max_iters=100)
    assert res2 <= 1e-6 and it2 < it
    np.testing.assert_allclose(x2.numpy(), x.numpy(), rtol=1e-4)


@pytest.mark.parametrize("iters", [1, 3])
def test_counters_count_applies_and_sweeps(hpcg16, iters):
    op, _, b = hpcg16
    with prof.recording():
        op.solve_cg(b.float(), tol=0.0, max_iters=iters)
    counters = prof.snapshot().counters
    assert counters["mg.applies"] == iters + 1
    assert counters["mg.sweeps"] == 14 * (iters + 1)
    spans = [s.name for s in prof.snapshot().spans]
    assert spans.count("bsm.mg.apply") == iters + 1


def test_set_up_laps():
    setup = _setup((8, 8, 8), 3)
    assert set(setup.timings) == {"hierarchy", "schedules", "ell"}
    laps = prof.snapshot().laps
    assert all(f"mg.{k}" in laps for k in setup.timings)


# ---- CSR.triangle -----------------------------------------------------------
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("lower", [True, False])
def test_triangle_is_tril_or_triu(lower, strict):
    rng = np.random.default_rng(9)
    d = ((rng.random((30, 30)) < 0.2) * rng.standard_normal((30, 30))
         ).astype(np.float32)
    t = P.CSR.from_dense(d).triangle(lower=lower, strict=strict)
    k = (-1 if lower else 1) if strict else 0
    want = np.tril(d, k) if lower else np.triu(d, k)
    np.testing.assert_array_equal(t.todense().numpy(), want)
    assert t.stored == np.count_nonzero(want)


# ---- on the card ------------------------------------------------------------
def _eager(owner, tag, fn, *operands, **kwargs):
    return fn(*operands)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [6, 7])
def test_chunk_graphs_equal_the_eager_loop(cuda, monkeypatch, iters):
    dims = (16, 16, 16)
    setup = _setup(dims, 4, device=cuda)
    b = R.Grid(dims).apply(_vec(setup.a.rows, 10)).float().to(cuda)
    with prof.recording():
        x, it, res = ppcg.pcg_solve(setup.a, b, tol=0.0, max_iters=iters,
                                    setup=setup)
    counters = prof.snapshot().counters
    with monkeypatch.context() as m:
        m.setattr(graphs, "run", _eager)
        xe, ite, rese = ppcg._pcg_loop(setup, b, 0.0, iters)
    assert it == ite == iters
    torch.testing.assert_close(x, xe, rtol=1e-6, atol=1e-6 * float(
        xe.abs().max()))
    chunks = -(-iters // setup.chunk)
    applies = 1 + chunks * setup.chunk
    assert counters["mg.applies"] == applies
    assert counters["mg.sweeps"] == 14 * applies
    assert counters["graphs.replays"] == 1 + chunks
    assert counters["trsv.launches"] > 0
    assert graphs.count(setup) == 2


@pytest.mark.cuda
def test_a_vcycle_replays_its_graph_with_device_time(cuda):
    setup = _setup((16, 16, 16), 4, device=cuda)
    r = _vec(setup.a.rows, 11).float().to(cuda)
    first = setup.apply_m_inv(r)
    with prof.recording():
        again = setup.apply_m_inv(r)
    snap = prof.snapshot()
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    replays = [s for s in snap.spans if s.name == "bsm.graphs.replay"]
    assert len(replays) == 1 and replays[0].attrs["device_ms"] > 0
    assert snap.spans[replays[0].parent].name == "bsm.mg.apply"
    assert snap.counters["mg.applies"] == 1
    assert snap.counters["mg.sweeps"] == 14
    mg = R.MG((16, 16, 16), 4)
    assert _err(again, mg.vcycle(r.double().cpu())) <= RTOL
