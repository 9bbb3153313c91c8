"""The port's compiled loops (``runtime/graphs.py``): the level loop of the
triangular solve, IC(0)-PCG's chunked while loop and Chebyshev, captured
as CUDA graphs on the card and run as they are on the CPU.

On the CPU (inputs from a seed with numpy: the 6³ and 8³ Laplacians, a
200-node tree Laplacian):

* the PCG chunk body, run eagerly, equals the port's eager ``_pcg_loop``
  bit for bit (iterate, iteration count, residual), and JAX's
  ``pcg_solve`` in the iteration count exactly and in ``x`` within
  ``rtol=1e-5`` and ``atol=1e-5·max|ref|``, when ``tol`` is reached in the
  middle of a chunk and exactly at a chunk's end, when ``max_iters`` comes
  first, for ``max_iters = 0`` and for ``b = 0``; ``tol`` sits halfway (in
  ratio) between two residuals of the eager loop a factor 0.9 or more
  apart, so that float32 rounding in either package cannot move the stop;
* the scatter tier's solves on the tree, Chebyshev and the triangular solve
  against JAX (``rtol=1e-4``, ``atol=1e-5·max|ref|``, the bounds of
  ``test_torch_solve.py`` and ``test_torch_iterative.py``);
* a CPU call builds no graph.

The ``cuda``-marked cases run on the card (the JAX package is imported
only by the CPU cases, since the card's machine has no jax): graph replay
against the eager loop within ``1e-5·max|ref|`` for every operand form,
static copy-in, fresh results, graphs freed with their schedule, PCG's
iteration count, the ctypes kernels captured, the deterministic-algorithms
path, and a host read in a captured function raising.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.models import chebyshev as pch
from basic_sparse_matrix_tpu_torch.models import pcg as ppcg
from basic_sparse_matrix_tpu_torch.models import sparse_triangular as pst
from basic_sparse_matrix_tpu_torch.runtime import graphs
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)

REPLAY_ATOL_OF_MAX = 1e-5


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


@pytest.fixture
def jax_pkg():
    """The JAX package (the reference of the CPU cases)."""
    return pytest.importorskip("basic_sparse_matrix_tpu")


def _lap3(k):
    """The 7-point Laplacian on a k³ grid as COO arrays."""
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


def _tree(n, seed):
    """The Laplacian of a random tree plus I (SPD) as a dense array."""
    parent = np.random.default_rng(seed).integers(
        0, np.maximum(np.arange(1, n), 1))
    d = np.eye(n)
    for i, p in enumerate(parent, start=1):
        d[i, p] = d[p, i] = -1.0
        d[i, i] += 1.0
        d[p, p] += 1.0
    return d.astype(np.float32)


def _dense(k):
    n, r, c, v = _lap3(k)
    d = np.zeros((n, n), dtype=np.float32)
    np.add.at(d, (r, c), v)
    return d


def _close(got, want, rtol, atol_of_max):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_of_max * max(float(np.abs(want).max(initial=0.0)), 1e-30))


# ---- PCG: the chunk body against the eager loop and JAX ---------------------
def _stop_at(setup, b, k):
    """A ``tol`` at which the eager loop stops after exactly ``k``
    iterations with a margin: halfway in ratio between the residual after
    ``k`` steps and the least one before, if that is 0.9 of it or less."""
    res = [float(ppcg._pcg_loop(setup, b, 0.0, j)[2]) for j in range(k + 1)]
    before = min(res[:k])
    assert res[k] <= 0.9 * before, (k, res)
    return float(np.sqrt(res[k] * before))


def _pcg_case(k, case):
    """(b, tol, max_iters) of one stopping case on the k³ Laplacian."""
    rng = np.random.default_rng(k)
    b = rng.standard_normal(k ** 3).astype(np.float32)
    setup = ppcg.PCGSetup.build(P.CSR.from_dense(_dense(k)))
    bt = torch.as_tensor(b)
    if case == "tol mid-chunk":
        return b, _stop_at(setup, bt, ppcg.CHUNK + 3), 500
    if case == "tol at a chunk's end":
        return b, _stop_at(setup, bt, ppcg.CHUNK), 500
    if case == "max_iters first":
        return b, 1e-12, ppcg.CHUNK + 5
    if case == "max_iters 0":
        return b, 1e-6, 0
    return np.zeros_like(b), 1e-6, 500        # b = 0


PCG_CASES = ["tol mid-chunk", "tol at a chunk's end", "max_iters first",
             "max_iters 0", "b = 0"]


@pytest.mark.parametrize("case", PCG_CASES)
@pytest.mark.parametrize("k", [6, 8])
def test_pcg_chunks_are_the_eager_loop_and_jax(k, case, jax_pkg):
    from basic_sparse_matrix_tpu.models import pcg as jpcg

    b, tol, max_iters = _pcg_case(k, case)
    pa = P.CSR.from_dense(_dense(k))
    setup = ppcg.PCGSetup.build(pa)
    bt = torch.as_tensor(b)
    x, it, res = ppcg._pcg_chunked(setup, bt, tol, max_iters)
    x0, it0, res0 = ppcg._pcg_loop(setup, bt, tol, max_iters)
    assert it == it0
    assert torch.equal(x, x0) and torch.equal(res, res0)
    jx, jit, _ = jpcg.pcg_solve(jax_pkg.CSR.from_dense(_dense(k)), b,
                                tol=tol, max_iters=max_iters)
    assert it == jit
    _close(x, jx, rtol=1e-5, atol_of_max=1e-5)
    want = {"tol mid-chunk": ppcg.CHUNK + 3,
            "tol at a chunk's end": ppcg.CHUNK,
            "max_iters first": max_iters}.get(case, 0)
    assert it == want
    # pcg_solve on the CPU runs the eager loop: the same answer
    xs, its, _ = ppcg.pcg_solve(pa, b, tol=tol, max_iters=max_iters,
                                setup=setup)
    assert its == it and torch.equal(xs, x)


# ---- the other loops on the CPU against JAX ---------------------------------
def test_scatter_tier_solves_on_a_tree_match_jax(jax_pkg):
    """The 200-node tree takes the scatter-list tier in both packages
    (RCM, no banded tier): forward and backward level loops of 35 levels
    or so, 1 and 3 right-hand sides."""
    from basic_sparse_matrix_tpu.utils import config as jcfg

    d = _tree(200, 5)
    b = np.random.default_rng(6).standard_normal((200, 3)).astype(
        np.float32)
    jold, pold = jcfg.get_config(), pcfg.get_config()
    try:
        for cfg, old in ((jcfg, jold), (pcfg, pold)):
            cfg.set_config(dataclasses.replace(old, ordering="rcm",
                                               banded_max_block=0))
        ps = P.DirectSolver(P.CSR.from_dense(d))
        js = jax_pkg.DirectSolver(jax_pkg.CSR.from_dense(d))
    finally:
        jcfg.set_config(jold)
        pcfg.set_config(pold)
    assert ps.kind == js.kind == "scatter"
    assert ps._fwd.n_levels > 5
    for rhs in (b[:, 0], b):
        got = ps.solve(rhs)
        _close(got, np.asarray(js.solve(rhs)), rtol=1e-4, atol_of_max=1e-5)
        _close(got, np.linalg.solve(d.astype(np.float64), rhs), rtol=1e-4,
               atol_of_max=1e-5)
    assert graphs.count(ps._fwd) == graphs.count(ps._bwd) == 0


def test_chebyshev_matches_jax(jax_pkg):
    from basic_sparse_matrix_tpu.models import chebyshev as jch

    d = _dense(6)
    b = np.random.default_rng(3).standard_normal(216).astype(np.float32)
    lam = np.linalg.eigvalsh(d.astype(np.float64))
    bounds = (0.95 * lam[0], 1.01 * lam[-1])
    x, res = pch.chebyshev_solve(P.CSR.from_dense(d), b, iters=40,
                                 bounds=bounds)
    jx, jres = jch.chebyshev_solve(jax_pkg.CSR.from_dense(d), b, iters=40,
                                   bounds=bounds)
    _close(x, jx, rtol=1e-4, atol_of_max=1e-5)
    assert res == pytest.approx(float(jres), rel=1e-3)


def test_a_cpu_call_builds_no_graph():
    owners = graphs.owners()
    d = _dense(6)
    a = P.CSR.from_dense(d)
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(216)
                        .astype(np.float32))
    l = P.CSR.from_dense(np.tril(d))
    sched = pst.build_schedule(l)
    pst.solve_triangular_sparse(l, b, sched)
    setup = ppcg.PCGSetup.build(a)
    ppcg.pcg_solve(a, b, setup=setup)
    ppcg._pcg_chunked(setup, b, 1e-6, 50)
    op = P.SparseOperator(a)
    op.solve_chebyshev(b, iters=10)
    for owner in (sched, setup, setup.fwd, setup.bwd, op._lanczos):
        assert graphs.count(owner) == 0
    assert graphs.owners() == owners


# ---- on the card ------------------------------------------------------------
def _lower(seed, n, density, device):
    rng = np.random.default_rng(seed)
    d = np.tril((rng.random((n, n)) < density)
                * rng.standard_normal((n, n)), -1)
    d += np.diag(rng.uniform(1.0, 2.0, n))
    return P.CSR.from_dense(d.astype(np.float32), device=device)


def _rhs(seed, shape, device):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32), device=device)


def _near(got, want):
    assert got.shape == want.shape and want.numel()
    assert float((got - want).abs().max()) \
        <= REPLAY_ATOL_OF_MAX * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("form", ["1-D", "(n, k)", "(Bt, n, k)"])
def test_replay_is_the_eager_loop(cuda, lower, form):
    l = _lower(0, 300, 0.05, cuda)
    l = l if lower else l.transpose()
    sched = pst.build_schedule(l, lower=lower)
    shape = {"1-D": (300,), "(n, k)": (300, 4), "(Bt, n, k)": (3, 300, 4)}
    values = None
    if form == "(Bt, n, k)":
        vals = l.values[None] * torch.tensor([[1.0], [1.5], [2.0]],
                                             device=cuda)
        values = pst.schedule_values(sched, vals)
    for seed in (1, 2):
        b = _rhs(seed, shape[form], cuda)
        got = pst.solve_triangular_sparse(l, b, sched, lower=lower,
                                          values=values)
        want = pst._solve(sched, b, *(values or ()))
        _near(got, want)
    assert graphs.count(sched) == 1


@pytest.mark.cuda
def test_replay_of_an_empty_schedule(cuda):
    l = P.CSR.from_dense(np.zeros((0, 0), dtype=np.float32), device=cuda)
    for lower in (True, False):
        sched = pst.build_schedule(l, lower=lower)
        assert sched.n_levels == 0
        for shape in ((0,), (0, 3)):
            out = pst.solve_triangular_sparse(l, torch.zeros(shape,
                                                             device=cuda),
                                              sched, lower=lower)
            assert out.shape == shape and out.is_cuda


@pytest.mark.cuda
def test_replays_copy_in_their_operands_and_return_fresh_tensors(cuda):
    l = _lower(3, 200, 0.05, cuda)
    sched = pst.build_schedule(l)
    scale = torch.tensor([[1.0], [3.0]], device=cuda)
    outs = []
    for i in range(3):
        b = _rhs(10 + i, (2, 200, 2), cuda)
        values = pst.schedule_values(sched, l.values[None] * (scale + i))
        got = pst.solve_triangular_sparse(l, b, sched, values=values)
        _near(got, pst._solve(sched, b, *values))
        outs.append((got.clone(), got))
    assert graphs.count(sched) == 1
    for kept, returned in outs:     # no later replay wrote into a result
        assert torch.equal(kept, returned)
    assert not torch.equal(outs[0][0], outs[1][0])


@pytest.mark.cuda
def test_graphs_go_with_their_schedule(cuda):
    torch.cuda.synchronize()
    gc.collect()
    held = torch.cuda.memory_allocated()
    owners = graphs.owners()
    l = _lower(4, 400, 0.05, cuda)
    sched = pst.build_schedule(l)
    for shape in ((400,), (400, 8)):
        pst.solve_triangular_sparse(l, _rhs(5, shape, cuda), sched)
    assert graphs.count(sched) == 2 and graphs.owners() == owners + 1
    alive = weakref.ref(sched)
    del sched, l
    gc.collect()
    assert alive() is None
    assert graphs.owners() == owners
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= held


@pytest.mark.cuda
def test_dropping_a_direct_solver_frees_its_graphs(cuda):
    """The tree takes the scatter-list tier (no kernel to build): its two
    schedules own the solve graphs, and go with the solver."""
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, ordering="rcm",
                                        banded_max_block=0))
    try:
        solver = P.DirectSolver(P.CSR.from_dense(_tree(200, 5), device=cuda))
    finally:
        pcfg.set_config(old)
    assert solver.kind == "scatter"
    owners = graphs.owners()
    for shape in ((200,), (200, 3)):
        b = _rhs(14, shape, cuda)
        x = solver.solve(b)
        _near(x, solver.solve(b))
    assert graphs.owners() == owners + 2
    alive = weakref.ref(solver)
    del solver
    gc.collect()
    assert alive() is None and graphs.owners() == owners


@pytest.mark.cuda
def test_the_oldest_graph_goes_first(cuda):
    l = _lower(6, 100, 0.1, cuda)
    sched = pst.build_schedule(l)
    for k in range(1, graphs.MAX_GRAPHS_PER_OWNER + 2):
        b = _rhs(k, (100, k), cuda)
        _near(pst.solve_triangular_sparse(l, b, sched), pst._solve(sched, b))
    assert graphs.count(sched) == graphs.MAX_GRAPHS_PER_OWNER


@pytest.mark.cuda
def test_pcg_counts_the_eager_loops_iterations(cuda):
    d = _dense(8)
    a = P.CSR.from_dense(d, device=cuda)
    setup = ppcg.PCGSetup.build(a)
    b = _rhs(7, 512, cuda)
    for tol, max_iters in ((1e-6, 500), (1e-12, ppcg.CHUNK + 5),
                           (1e-6, 0)):
        x, it, res = ppcg.pcg_solve(a, b, tol=tol, max_iters=max_iters,
                                    setup=setup)
        x0, it0, res0 = ppcg._pcg_loop(setup, b, tol, max_iters)
        assert it == it0
        _near(x, x0)
    assert graphs.count(setup) == 1     # tol and max_iters are operands


@pytest.mark.cuda
def test_chebyshev_replay_is_the_eager_loop(cuda):
    d = _dense(8)
    op = P.SparseOperator(P.CSR.from_dense(d, device=cuda))
    b = _rhs(8, 512, cuda)
    lam = np.linalg.eigvalsh(d.astype(np.float64))
    for bounds in ((0.95 * lam[0], 1.01 * lam[-1]), (lam[0], lam[-1])):
        x, res = pch.chebyshev_solve(op.a, b, iters=50, bounds=bounds,
                                     setup=op._ensure_lanczos())
        f32 = dict(dtype=torch.float32, device=cuda)
        x0, res0 = pch._cheby_iterate(op._lanczos, 50, b,
                                      torch.tensor(bounds[0], **f32),
                                      torch.tensor(bounds[1], **f32))
        _near(x, x0)
        assert res == pytest.approx(float(res0), rel=1e-4)
    assert graphs.count(op._lanczos) == 1


class _Owner:
    """A graph owner for the kernel captures below."""


@pytest.mark.cuda
def test_the_ctypes_kernels_launch_on_the_capturing_stream(cuda):
    """K3 and the add-back's rect entry take ``torch.cuda.current_stream()``,
    so a graph records them (what a graphed numeric phase needs): replays
    on new operands equal the kernels' eager calls bit for bit (K3 copies;
    the rect entry adds on disjoint runs). A replay relaunches a kernel
    without its wrapper, so ``LAUNCHES`` counts the warm-up and the capture
    only."""
    from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read

    rng = np.random.default_rng(13)
    stf = rng.integers(0, 8000, 300).astype(np.int32)
    stf[::5] = -1
    stf = torch.as_tensor(stf, device=cuda)
    st, rd, wt = 20, 200, 12
    tnr = rng.integers(wt, rd + 1, st)
    twd = rng.integers(1, wt + 1, st)
    tcp = np.zeros((st, wt), np.int64)
    pos = 1
    for s_ in range(st):
        for w in range(wt):
            tcp[s_, w] = pos
            pos += int(tnr[s_]) - w
    tcp, tnr, twd = (torch.as_tensor(x, device=cuda) for x in (tcp, tnr, twd))

    def step(lv, p):
        rect = addback_resident.addback_rects(lv[:pos + 8].clone(), p, tcp,
                                              tnr, twd)
        return runs_read.runs_read(lv, stf, 256), rect
    owner = _Owner()
    before = (runs_read.LAUNCHES, addback_resident.LAUNCHES)
    for seed in (1, 2, 3):
        lv = _rhs(seed, (9000,), cuda)
        p = _rhs(seed + 10, (st, rd, wt), cuda)
        got = graphs.run(owner, "kernels", step, lv, p)
        want = step(lv, p)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert graphs.count(owner) == 1
    assert (runs_read.LAUNCHES - before[0],
            addback_resident.LAUNCHES - before[1]) == (5, 5)


@pytest.mark.cuda
def test_replay_under_deterministic_algorithms(cuda):
    """With torch's deterministic algorithms on, a CUDA ``index_add_`` sums
    in a fixed order: the graph records that path, so two replays and the
    eager loop agree bit for bit."""
    l = _lower(9, 300, 0.1, cuda)
    sched = pst.build_schedule(l)
    b = _rhs(11, (300, 4), cuda)
    torch.use_deterministic_algorithms(True)
    try:
        first = pst.solve_triangular_sparse(l, b, sched)
        again = pst.solve_triangular_sparse(l, b, sched)
        eager = pst._solve(sched, b)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(first, again) and torch.equal(first, eager)


@pytest.mark.cuda
def test_a_capture_that_fails_raises(cuda):
    """A host read inside the captured region fails the capture: ``run``
    raises and caches nothing (no eager run in its place). Last in the
    file: a failed capture may leave the capture stream current."""
    owner = pst.build_schedule(_lower(12, 10, 0.2, cuda))

    def reads_the_host(x):
        return x * float(x.sum())
    with pytest.raises(RuntimeError):
        graphs.run(owner, "host read", reads_the_host,
                   torch.ones(4, device=cuda))
    assert graphs.count(owner) == 0
