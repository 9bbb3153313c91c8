"""K7, the triangular solve's level step (``csrc/trsv_level.cu``), its
launch plan and its tables.

On the CPU (inputs from a seed with numpy): the plan
(``sparse_triangular.launch_plan``) covers every level once and in order,
each narrow run is maximal and holds only levels within ``NARROW_ROWS`` and
``NARROW_ENTRIES``, each wide launch one wider level on blocks enough for a
team a row; K7's tables (``cols32``, ``row_ent``, ``levels``) walked launch
by launch as the kernel walks them, in float64, give the plain loop's
solution within ``1e-5·max|ref|`` (float32 against float64 sums).

The ``cuda``-marked cases run on the card (this file imports no JAX): K7
against its plain version, the four-operation loop run on the same CUDA
schedule and operands, for lower and mirrored-upper schedules, ``b`` of
shape (n), (n, k), (Bt, n) and (Bt, n, k) with batched values, single-row
levels with long rows (within the staging buffers and beyond them), wide
levels, levels without entries, a plan that mixes wide launches and narrow
runs, systems that a run holds in shared memory and one that it does not,
and forced plans (every level a run, every level a wide launch).
Tolerance ``1e-5·max|ref|``: both sum each row in float32, K7 with one fma
a product in lane-strided order and a fixed butterfly, the loop with
rounded products and ``index_add_``, so a row differs by a few ulps of its
sum of magnitudes; the test factors are diagonally dominant, so such an
error does not grow from level to level. Two K7 solves agree bit for bit.
``DirectSolver`` (nested dissection, supernodal) and IC(0)-PCG on HPCG's
27-point operator at 16³ through ``graphs.run`` against the same calls with
the plain loop in K7's place (PCG ``1e-4·max|ref|`` after 20 iterations,
which carry each solve's rounding differences); the recorder counts
``trsv.launches`` and ``trsv.levels`` at every replayed solve.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.models import pcg as ppcg
from basic_sparse_matrix_tpu_torch.models import sparse_triangular as pst
from basic_sparse_matrix_tpu_torch.probes.trsv_probe import hpcg27, leveled
from basic_sparse_matrix_tpu_torch.runtime import profiling as prof
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)

ATOL_OF_MAX = 1e-5


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


# Level sizes and dependencies a row of the test matrices
# (``probes/trsv_probe.py::leveled``).
CASES = {
    # single-row levels whose rows reach 1,499 entries (staged in a run)
    "long-rows": ([2000] + [1] * 200, 1500),
    # single-row levels of 20,000 entries: beyond the staging buffers
    "longer-than-a-stage": ([24000] + [1] * 6, 20000),
    "wide": ([3000, 2500, 4000, 1000], 13),
    "mixed": ([3000, 1, 2, 600, 300, 1, 5000, 100, 100, 1, 1, 700], 20),
    # more unknowns than a run holds in shared memory
    "large": ([36000, 1, 2, 600, 1, 1, 100, 40, 1], 30),
    # one level, no entries: wide, and narrow
    "diagonal-wide": ([5000], 1),
    "diagonal-narrow": ([3], 1),
}


def _plan_ok(sched):
    """The plan's invariants against the schedule's levels."""
    plan = sched.plan
    rows = np.diff(sched.row_ptr)
    ents = np.diff(sched.ent_ptr)
    narrow = (rows <= pst.NARROW_ROWS) & (ents <= pst.NARROW_ENTRIES)
    assert plan.dtype == np.int32 and plan.flags.c_contiguous
    if sched.n_levels == 0:
        assert plan.shape == (0, 3)
        return
    assert plan[0, 0] == 0 and plan[-1, 1] == sched.n_levels
    assert np.array_equal(plan[1:, 0], plan[:-1, 1])
    assert np.all(plan[:, 1] > plan[:, 0])
    for i, (lv0, lv1, blocks) in enumerate(plan):
        if blocks == 0:
            assert narrow[lv0:lv1].all()
            # maximal: no narrow level just before or after the run
            assert lv0 == 0 or not narrow[lv0 - 1]
            assert lv1 == sched.n_levels or not narrow[lv1]
        else:
            assert lv1 == lv0 + 1 and not narrow[lv0]
            mean = min(-(-ents[lv0] // rows[lv0]), pst.WIDE_THREADS)
            team = 1 << int(np.ceil(np.log2(max(mean, 1))))
            assert blocks * pst.WIDE_THREADS >= rows[lv0] * team
            assert (blocks - 1) * pst.WIDE_THREADS < rows[lv0] * team


def _walk(sched, b):
    """K7's walk in numpy, float64: every launch of the plan, every level
    of it, every row of the level from ``levels`` and ``row_ent``, every
    entry from ``cols32``, all in level order."""
    y = b.double().numpy()[sched.rows.numpy()]
    lev = sched.levels.numpy()
    ent = sched.row_ent.numpy()
    cols, vals = sched.cols32.numpy(), sched.vals.double().numpy()
    inv = sched.inv_diag.double().numpy()
    for lv0, lv1, _ in sched.plan:
        for lv in range(lv0, lv1):
            assert ent[lev[lv, 0]] == lev[lv, 1]
            for r in range(lev[lv, 0], lev[lv + 1, 0]):
                e = slice(ent[r], ent[r + 1])
                y[r] = (y[r] - vals[e] @ y[cols[e]]) * inv[r]
    out = np.empty_like(y)
    out[sched.rows.numpy()] = y
    return out


@pytest.mark.parametrize("case", ["long-rows", "wide", "mixed",
                                  "diagonal-wide", "diagonal-narrow"])
@pytest.mark.parametrize("lower", [True, False])
def test_the_plan_covers_every_level_once(case, lower):
    sizes, deps = CASES[case]
    l = leveled(sizes, deps, seed=len(sizes))
    sched = pst.build_schedule(l if lower else l.transpose(), lower=lower)
    _plan_ok(sched)
    if lower:
        assert np.array_equal(np.diff(sched.row_ptr), sizes)
    kinds = set(np.sign(sched.plan[:, 2]))
    assert kinds == {"long-rows": {0, 1}, "wide": {1}, "mixed": {0, 1},
                     "diagonal-wide": {1}, "diagonal-narrow": {0}}[case] \
        or not lower


@pytest.mark.parametrize("limits", [(1, 10), (3, 1000), (50, 50),
                                    (10**6, 10**9)])
def test_the_plan_follows_the_limits(monkeypatch, limits):
    monkeypatch.setattr(pst, "NARROW_ROWS", limits[0])
    monkeypatch.setattr(pst, "NARROW_ENTRIES", limits[1])
    sizes, deps = CASES["mixed"]
    sched = pst.build_schedule(leveled(sizes, deps, seed=3))
    _plan_ok(sched)
    if limits[0] >= 10**6:
        assert sched.plan.tolist() == [[0, sched.n_levels, 0]]


def test_an_empty_schedule_has_an_empty_plan():
    sched = pst.build_schedule(P.CSR.from_dense(np.zeros((0, 0),
                                                         np.float32)))
    _plan_ok(sched)
    assert sched.row_ent.tolist() == [0] and sched.levels.tolist() == [[0, 0]]


@pytest.mark.parametrize("case", ["long-rows", "mixed", "diagonal-narrow"])
@pytest.mark.parametrize("lower", [True, False])
def test_the_tables_walked_as_k7_walks_them(case, lower):
    sizes, deps = CASES[case]
    l = leveled(sizes, deps, seed=7)
    l = l if lower else l.transpose()
    sched = pst.build_schedule(l, lower=lower)
    assert sched.cols32.dtype == sched.row_ent.dtype == torch.int32
    assert sched.levels.dtype == torch.int32
    assert torch.equal(sched.cols32.long(), sched.cols)
    assert sched.levels[:, 1].tolist() == list(sched.ent_ptr)
    b = torch.as_tensor(np.random.default_rng(8).standard_normal(
        l.rows).astype(np.float32))
    bb = b if lower else torch.flip(b, (0,))
    got = _walk(sched, bb)
    got = got if lower else got[::-1]
    want = pst._solve(sched, b).numpy()
    assert np.abs(got - want).max() <= ATOL_OF_MAX * np.abs(want).max()


# ---- on the card ------------------------------------------------------------


SHAPES = {"(n)": lambda n: (n,), "(n, k)": lambda n: (n, 3),
          "(Bt, n)": lambda n: (2, n), "(Bt, n, k)": lambda n: (2, n, 3)}


def _forced(sched, kind):
    """The schedule with its plan replaced: every level one run, or every
    level a wide launch."""
    nlev = sched.n_levels
    if kind == "run":
        plan = [[0, nlev, 0]]
    else:
        rows = np.diff(sched.row_ptr)
        blocks = pst.wide_blocks(rows, np.diff(sched.ent_ptr))
        plan = [[lv, lv + 1, b] for lv, b in enumerate(blocks)]
    return dataclasses.replace(sched, plan=np.asarray(plan, np.int32))


def _near(got, want):
    assert got.shape == want.shape and got.is_cuda and want.numel()
    assert float((got - want).abs().max()) \
        <= ATOL_OF_MAX * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES) + [
    "mixed, one run", "mixed, all wide", "large, one run"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("lower", [True, False])
def test_k7_is_its_plain_version(cuda, monkeypatch, case, shape, lower):
    sizes, deps = CASES[case.split(",")[0]]
    l = leveled(sizes, deps, seed=len(sizes), device=cuda)
    l = l if lower else l.transpose()
    sched = pst.build_schedule(l, lower=lower)
    if "," in case:
        sched = _forced(sched, "run" if "run" in case else "wide")
    values = None
    if shape.startswith("(Bt"):
        scale = torch.tensor([[1.0], [0.5]], device=cuda)
        values = pst.schedule_values(sched, l.values[None] * scale)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(
        SHAPES[shape](l.rows)).astype(np.float32), device=cuda)
    before = pst.LAUNCHES
    got = pst._solve(sched, b, *(values or ()))
    assert pst.LAUNCHES - before == len(sched.plan)
    again = pst._solve(sched, b, *(values or ()))
    assert torch.equal(got, again)
    monkeypatch.setattr(pst, "_levels_cuda", pst._levels_plain)
    _near(got, pst._solve(sched, b, *(values or ())))


@pytest.mark.cuda
def test_k7_constants_are_the_plans(cuda):
    import ctypes

    from basic_sparse_matrix_tpu_torch.runtime import cuda_kernels

    out = (ctypes.c_int * 6)()
    cuda_kernels.load().bsm_trsv_info(out)
    run, wide, stage_entries, stage_rows, _, _ = out
    assert wide == pst.WIDE_THREADS
    assert pst.NARROW_ENTRIES <= stage_entries
    assert pst.NARROW_ROWS <= stage_rows <= run


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["(n)", "(n, k)"])
def test_direct_solver_on_hpcg_16(cuda, monkeypatch, shape):
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, ordering="nd"))
    try:
        solver = P.DirectSolver(hpcg27(16, cuda))
    finally:
        pcfg.set_config(old)
    assert solver.kind == "supernodal"
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(
        SHAPES[shape](solver.n)).astype(np.float32), device=cuda)
    with prof.recording():
        got = solver.solve(b)
        again = solver.solve(b)
    c = prof.snapshot().counters
    fwd, bwd = solver._fwd, solver._bwd
    assert c["trsv.launches"] == 2 * (len(fwd.plan) + len(bwd.plan))
    assert c["trsv.levels"] == 2 * (fwd.n_levels + bwd.n_levels)
    assert torch.equal(got, again)
    # the plain loop in K7's place, on new graph owners
    solver._fwd, solver._bwd = copy.copy(fwd), copy.copy(bwd)
    monkeypatch.setattr(pst, "_levels_cuda", pst._levels_plain)
    _near(got, solver.solve(b))


@pytest.mark.cuda
def test_pcg_on_hpcg_16(cuda, monkeypatch):
    a = hpcg27(16, cuda)
    setup = ppcg.PCGSetup.build(a)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(
        a.rows).astype(np.float32), device=cuda)
    ppcg.pcg_solve(a, b, tol=0.0, max_iters=20, setup=setup)   # captures
    with prof.recording():
        x, it, _ = ppcg.pcg_solve(a, b, tol=0.0, max_iters=20, setup=setup)
    c = prof.snapshot().counters
    solves = 2 + 2 * 20   # the start's two, two an iteration (5 chunks)
    assert it == 20 and c.get("graphs.captures", 0) == 0
    assert c["trsv.launches"] == solves // 2 * (len(setup.fwd.plan)
                                                + len(setup.bwd.plan))
    assert c["trsv.levels"] == solves // 2 * (setup.fwd.n_levels
                                              + setup.bwd.n_levels)
    plain = copy.copy(setup)
    plain.fwd, plain.bwd = copy.copy(setup.fwd), copy.copy(setup.bwd)
    monkeypatch.setattr(pst, "_levels_cuda", pst._levels_plain)
    want, want_it, _ = ppcg.pcg_solve(a, b, tol=0.0, max_iters=20,
                                      setup=plain)
    assert want_it == it
    assert float((x - want).abs().max()) <= 1e-4 * float(want.abs().max())
