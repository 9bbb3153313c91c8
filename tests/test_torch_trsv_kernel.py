"""K7, the triangular solve's level step (``csrc/trsv_level.cu``), its
launch plan and its tables.

On the CPU (inputs from a seed with numpy): the plan
(``sparse_triangular.launch_plan``) covers every level once and in order,
each narrow run is maximal and holds only levels within ``NARROW_ROWS`` and
``NARROW_ENTRIES``, each dataflow chain is a maximal run of at least
``DATAFLOW_MIN_LEVELS`` wide levels whose rows take a team of at most a
warp, each wide launch one other wider level on blocks enough for a team a
row; K7's tables (``cols32``, ``row_ent``, ``levels``) walked launch by
launch as the kernel walks them, in float64, give the plain loop's
solution within ``1e-5·max|ref|`` (float32 against float64 sums). On
HPCG's IC(0), multigrid and nested-dissection schedules every chain's row
depends only on earlier level-order positions (what keeps the chain free of
deadlock) and the chain's warp-units (``units``) give each of its rows to
exactly one warp's team.

The ``cuda``-marked cases run on the card (this file imports no JAX): K7
against its plain version, the four-operation loop run on the same CUDA
schedule and operands, for lower and mirrored-upper schedules, ``b`` of
shape (n), (n, k), (Bt, n) and (Bt, n, k) with batched values, single-row
levels with long rows (within the staging buffers and beyond them), wide
levels, levels without entries, a plan that mixes wide launches and narrow
runs, systems that a run holds in shared memory and one that it does not,
and forced plans (every level a run, every level a wide launch).
A dataflow chain equals K7 launched a level at a time bit for bit
(``torch.equal``) on IC(0)'s L and U at 64³, D+L and D+U on each of HPCG's
multigrid grids (104³ to 13³), the 32³ nested-dissection factor, and in a
graph that runs one schedule twice back to back, replayed 1,000 times
under a hard time limit; several columns or systems run the chain's levels
as wide launches and equal the chain column by column.
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
import faulthandler
import types

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


@pytest.fixture
def time_limit():
    """Arms a hard limit on the test's seconds: past it the process prints
    its stacks and exits (a wait inside a kernel cannot be interrupted)."""
    yield lambda seconds: faulthandler.dump_traceback_later(seconds,
                                                            exit=True)
    faulthandler.cancel_dump_traceback_later()


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
    # a run of 12 wide levels: one dataflow chain
    "chain": ([3000] + [700] * 12 + [2], 13),
}


def _team(rows, ents):
    mean = min(-(-ents // rows), pst.WIDE_THREADS)
    return 1 << int(np.ceil(np.log2(max(mean, 1))))


def _plan_ok(sched):
    """The plan's invariants against the schedule's levels."""
    plan = sched.plan
    rows = np.diff(sched.row_ptr)
    ents = np.diff(sched.ent_ptr)
    narrow = (rows <= pst.NARROW_ROWS) & (ents <= pst.NARROW_ENTRIES)
    fits = np.array([not nw and _team(r, e) <= 32
                     for r, e, nw in zip(rows, ents, narrow)], dtype=bool)
    assert plan.dtype == np.int32 and plan.flags.c_contiguous
    if sched.n_levels == 0:
        assert plan.shape == (0, 3)
        return
    assert plan[0, 0] == 0 and plan[-1, 1] == sched.n_levels
    assert np.array_equal(plan[1:, 0], plan[:-1, 1])
    assert np.all(plan[:, 1] > plan[:, 0])
    units = sched.units.numpy()
    for i, (lv0, lv1, blocks) in enumerate(plan):
        if blocks == 0:
            assert narrow[lv0:lv1].all()
            # maximal: no narrow level just before or after the run
            assert lv0 == 0 or not narrow[lv0 - 1]
            assert lv1 == sched.n_levels or not narrow[lv1]
        elif blocks < 0:
            # a dataflow chain: a maximal run of enough wide levels whose
            # rows take a team of at most a warp, a warp a unit
            assert fits[lv0:lv1].all()
            assert lv1 - lv0 >= pst.DATAFLOW_MIN_LEVELS
            assert lv0 == 0 or not fits[lv0 - 1]
            assert lv1 == sched.n_levels or not fits[lv1]
            need = units[lv1] - units[lv0]
            want = -(-pst.DATAFLOW_LOOKAHEAD * need // (lv1 - lv0))
            assert -blocks == max(1, -(-min(want, need) // pst.CHAIN_WARPS))
        else:
            assert lv1 == lv0 + 1 and not narrow[lv0]
            # in no chain: its run of fitting levels is too short
            run0, run1 = lv0, lv1
            while fits[lv0] and run0 > 0 and fits[run0 - 1]:
                run0 -= 1
            while fits[lv0] and run1 < sched.n_levels and fits[run1]:
                run1 += 1
            assert not fits[lv0] or run1 - run0 < pst.DATAFLOW_MIN_LEVELS
            team = _team(rows[lv0], ents[lv0])
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
                                  "diagonal-wide", "diagonal-narrow",
                                  "chain"])
@pytest.mark.parametrize("lower", [True, False])
def test_the_plan_covers_every_level_once(case, lower):
    sizes, deps = CASES[case]
    l = leveled(sizes, deps, seed=len(sizes))
    sched = pst.build_schedule(l if lower else l.transpose(), lower=lower)
    _plan_ok(sched)
    if lower:
        assert np.array_equal(np.diff(sched.row_ptr), sizes)
    kinds = set(np.sign(sched.plan[:, 2]))
    # "wide": four wide levels, one dataflow chain
    assert kinds == {"long-rows": {0, 1}, "wide": {-1}, "mixed": {0, 1},
                     "diagonal-wide": {1}, "diagonal-narrow": {0},
                     "chain": {-1, 0}}[case] \
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


@pytest.mark.parametrize("runs", [
    # (levels, rows a level, entries a row) runs in order
    [(1, 2, 0), (7, 600, 13), (1, 2, 4), (8, 600, 13), (1, 3, 2),
     (20, 300, 13)],
    # long rows (a team wider than a warp) keep a launch a level
    [(1, 1, 0), (12, 200, 40), (9, 900, 9)],
    # one level under the chain's minimum, then exactly at it
    [(pst.DATAFLOW_MIN_LEVELS - 1, 400, 13), (1, 1, 3),
     (pst.DATAFLOW_MIN_LEVELS, 400, 13)],
])
def test_the_plan_chains_only_long_runs_of_wide_levels(runs):
    rows = np.concatenate([[r] * lv for lv, r, _ in runs])
    ents = np.concatenate([[r * e] * lv for lv, r, e in runs])
    row_ptr = np.concatenate([[0], np.cumsum(rows)])
    ent_ptr = np.concatenate([[0], np.cumsum(ents)])
    units = np.concatenate([[0], np.cumsum(pst.warp_units(rows, ents))])
    sched = types.SimpleNamespace(
        plan=pst.launch_plan(row_ptr, ent_ptr), row_ptr=row_ptr,
        ent_ptr=ent_ptr, n_levels=rows.size, units=torch.as_tensor(units))
    _plan_ok(sched)
    narrow = (rows <= pst.NARROW_ROWS) & (ents <= pst.NARROW_ENTRIES)
    chain = pst.chained(rows, ents, narrow)
    # the narrow runs are the plan's without chains
    each = pst.plan_of(rows, ents, narrow)
    assert [p for p in sched.plan.tolist() if p[2] == 0] \
        == [p for p in each.tolist() if p[2] == 0]
    # the chains replaced by a launch a level give the plan without chains
    assert np.array_equal(pst.level_by_level(sched), each)
    assert chain.sum() == sum(p[1] - p[0] for p in sched.plan if p[2] < 0)
    # the runs of 13 entries a row and enough levels, and no other
    want = np.concatenate([[e <= 32 and r > pst.NARROW_ROWS
                            and lv >= pst.DATAFLOW_MIN_LEVELS] * lv
                           for lv, r, e in runs])
    assert np.array_equal(chain, want)


@pytest.mark.parametrize("lengths", [(8, 8, 8), (3, 13, 5)])
def test_the_plan_with_a_chain_by_level_sizes(lengths):
    """plan_of on level sizes alone: wide runs of enough levels chained,
    narrow levels between them kept in runs."""
    first, chain, last = lengths
    rows = np.array([1] * first + [1500] * chain + [2] * last)
    ents = np.array([2] * first + [13 * 1500] * chain + [5] * last)
    narrow = (rows <= pst.NARROW_ROWS) & (ents <= pst.NARROW_ENTRIES)
    plan = pst.plan_of(rows, ents, narrow, pst.chained(rows, ents, narrow))
    per_level = -(-1500 // 2)      # a team of 16: two rows a warp
    warps = pst.DATAFLOW_LOOKAHEAD * per_level
    assert plan.tolist() == [
        [0, first, 0],
        [first, first + chain, -(-(-warps // pst.CHAIN_WARPS))],
        [first + chain, first + chain + last, 0]]


def _hpcg_schedules(kind):
    """HPCG's schedules at small grids: IC(0)'s L and U, a multigrid grid's
    D+L and D+U, the nested-dissection factor's L and Lᵀ."""
    a = hpcg27(16 if kind != "mg-8" else 8)
    if kind == "ic0":
        setup = ppcg.PCGSetup.build(a)
        return setup.fwd, setup.bwd
    if kind.startswith("mg"):
        return (pst.build_schedule(a.triangle(lower=True)),
                pst.build_schedule(a.triangle(lower=False), lower=False))
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, ordering="nd"))
    try:
        solver = P.DirectSolver(a)
    finally:
        pcfg.set_config(old)
    return solver._fwd, solver._bwd


@pytest.mark.parametrize("kind", ["ic0", "mg-16", "mg-8", "nd"])
def test_a_chains_rows_depend_on_earlier_positions(kind):
    """What the chain's freedom from deadlock rests on: in level order every
    entry of a chain's row points to an earlier position, and the plan has
    a chain wherever HPCG's schedules have long runs of wide levels."""
    for sched in _hpcg_schedules(kind):
        _plan_ok(sched)
        chains = sched.plan[sched.plan[:, 2] < 0]
        assert len(chains) or kind == "nd"
        ent = sched.row_ent.numpy()
        cols = sched.cols32.numpy()
        for lv0, lv1, _ in chains:
            r0, r1 = sched.row_ptr[lv0], sched.row_ptr[lv1]
            owner = np.repeat(np.arange(r0, r1), np.diff(ent[r0:r1 + 1]))
            assert np.all(cols[ent[r0]:ent[r1]] < owner)
            # and to a position of an earlier level
            lev_of = np.searchsorted(sched.row_ptr, owner, side="right")
            assert np.all(cols[ent[r0]:ent[r1]]
                          < np.asarray(sched.row_ptr)[lev_of - 1])


@pytest.mark.parametrize("kind", ["ic0", "mg-16", "chain"])
def test_a_chains_units_give_each_row_one_team(kind):
    """The kernel's walk of a chain (``trsv_chain``): warp-unit u of level
    lv holds rows ``a + (u - units[lv])·(32/g) + lane/g`` for lanes 0..31,
    g the level's team; over the chain's units every row of its levels is
    taken by exactly one team."""
    if kind == "chain":
        sizes, deps = CASES["chain"]
        scheds = [pst.build_schedule(leveled(sizes, deps, seed=2))]
    else:
        scheds = _hpcg_schedules(kind)
    for sched in scheds:
        units = sched.units.numpy()
        rows, ents = np.diff(sched.row_ptr), np.diff(sched.ent_ptr)
        assert units[0] == 0 and np.array_equal(
            np.diff(units), pst.warp_units(rows, ents))
        for lv0, lv1, _ in sched.plan[sched.plan[:, 2] < 0]:
            taken = []
            for lv in range(lv0, lv1):
                g = _team(rows[lv], ents[lv])
                assert g <= 32
                for u in range(units[lv], units[lv + 1]):
                    lanes = np.arange(32)[::g]
                    i = sched.row_ptr[lv] + (u - units[lv]) * (32 // g) \
                        + lanes // g
                    taken += i[i < sched.row_ptr[lv + 1]].tolist()
            r0, r1 = sched.row_ptr[lv0], sched.row_ptr[lv1]
            assert sorted(taken) == list(range(r0, r1))


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
    plan = sched.plan if shape == "(n)" else pst.level_by_level(sched)
    assert pst.LAUNCHES - before == len(plan)
    again = pst._solve(sched, b, *(values or ()))
    assert torch.equal(got, again)
    monkeypatch.setattr(pst, "_levels_cuda", pst._levels_plain)
    _near(got, pst._solve(sched, b, *(values or ())))


@pytest.mark.cuda
def test_k7_constants_are_the_plans(cuda):
    import ctypes

    from basic_sparse_matrix_tpu_torch.runtime import cuda_kernels

    out = (ctypes.c_int * 8)()
    assert cuda_kernels.load().bsm_trsv_info(out) == 0
    run, wide, stage_entries, stage_rows, _, _, chain, resident = out
    assert wide == pst.WIDE_THREADS
    assert pst.NARROW_ENTRIES <= stage_entries
    assert pst.NARROW_ROWS <= stage_rows <= run
    assert chain == 32 * pst.CHAIN_WARPS and resident > 0


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
    plans = [s.plan if shape == "(n)" else pst.level_by_level(s)
             for s in (fwd, bwd)]
    assert c["trsv.launches"] == 2 * sum(map(len, plans))
    assert c["trsv.levels"] == 2 * (fwd.n_levels + bwd.n_levels)
    assert c["trsv.dataflow_launches"] == 2 * sum(
        int((p[:, 2] < 0).sum()) for p in plans)
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
    chains = [p[p[:, 2] < 0] for p in (setup.fwd.plan, setup.bwd.plan)]
    assert c["trsv.dataflow_launches"] == solves // 2 * sum(map(len, chains))
    assert c["trsv.dataflow_levels"] == solves // 2 * sum(
        int((p[:, 1] - p[:, 0]).sum()) for p in chains) > 0
    plain = copy.copy(setup)
    plain.fwd, plain.bwd = copy.copy(setup.fwd), copy.copy(setup.bwd)
    monkeypatch.setattr(pst, "_levels_cuda", pst._levels_plain)
    want, want_it, _ = ppcg.pcg_solve(a, b, tol=0.0, max_iters=20,
                                      setup=plain)
    assert want_it == it
    assert float((x - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ---- the dataflow chain on the card -----------------------------------------


def _each_level(sched):
    """The schedule with each chain launched a level at a time."""
    return dataclasses.replace(sched, plan=pst.level_by_level(sched))


def _card_schedules(kind, device):
    """HPCG's schedules on the card: IC(0)'s L and U at 64³, D+L and D+U of
    a multigrid grid, the 32³ nested-dissection factor's L and Lᵀ."""
    if kind == "ic0-64":
        setup = ppcg.PCGSetup.build(hpcg27(64, device))
        return setup.fwd, setup.bwd
    if kind.startswith("mg-"):
        a = hpcg27(int(kind[3:]), device)
        return (pst.build_schedule(a.triangle(lower=True)),
                pst.build_schedule(a.triangle(lower=False), lower=False))
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, ordering="nd"))
    try:
        solver = P.DirectSolver(hpcg27(32, device))
    finally:
        pcfg.set_config(old)
    return solver._fwd, solver._bwd


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ic0-64", "mg-104", "mg-52", "mg-26",
                                  "mg-13", "nd-32"])
def test_the_chain_is_k7_level_by_level(cuda, time_limit, kind):
    """Bit for bit, eager and through the solve's replayed graph."""
    time_limit(600)
    chained = 0
    for sched in _card_schedules(kind, cuda):
        chained += int((sched.plan[:, 2] < 0).sum())
        each = _each_level(sched)
        b = torch.as_tensor(np.random.default_rng(4).standard_normal(
            sched.n).astype(np.float32), device=cuda)
        want = pst._solve(each, b)
        assert torch.equal(pst._solve(sched, b), want)
        for _ in range(3):    # a capture, then replays
            got = pst.solve_triangular_sparse(None, b, sched,
                                              lower=sched.lower)
            assert torch.equal(got, want)
    assert chained > 0


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["as planned", "one chain"])
def test_one_schedule_twice_in_a_graph(cuda, time_limit, plan):
    """One captured graph solves twice in place on one schedule (as the
    multigrid's pre- and post-smoother run one D+L), replayed 1,000 times
    on four right-hand sides in turn, every result checked; "one chain"
    makes every level one chain, so the second chain is launched straight
    after the first on the same words."""
    time_limit(300)
    sched = pst.build_schedule(hpcg27(52, cuda).triangle(lower=True))
    if plan == "one chain":
        units = sched.units.cpu().numpy()
        sched = dataclasses.replace(sched, plan=np.asarray(
            [[0, sched.n_levels,
              -int(pst.chain_blocks(units[-1], sched.n_levels))]],
            np.int32))
    each = _each_level(sched)
    rng = np.random.default_rng(6)
    bs = [torch.as_tensor(rng.standard_normal(sched.n).astype(np.float32),
                          device=cuda) for _ in range(4)]
    wants = []
    for b in bs:
        y = b.clone()
        pst._levels_cuda(each, y, each.vals, each.inv_diag)
        pst._levels_cuda(each, y, each.vals, each.inv_diag)
        wants.append(y)
    b_in, y = bs[0].clone(), torch.empty_like(bs[0])

    def twice():
        y.copy_(b_in)
        pst._levels_cuda(sched, y, sched.vals, sched.inv_diag)
        pst._levels_cuda(sched, y, sched.vals, sched.inv_diag)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        twice()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        twice()
    for i in range(1000):
        b_in.copy_(bs[i % 4])
        graph.replay()
        assert torch.equal(y, wants[i % 4]), i


@pytest.mark.cuda
def test_columns_and_systems_equal_the_chain(cuda, time_limit):
    """Several columns, or systems of batched values, run the chain's levels
    as wide launches; each column and each system equals the chain's solve
    of it alone bit for bit."""
    time_limit(300)
    l = hpcg27(26, cuda).triangle(lower=True)
    sched = pst.build_schedule(l)
    assert (sched.plan[:, 2] < 0).any()
    rng = np.random.default_rng(7)
    b = torch.as_tensor(rng.standard_normal((sched.n, 3)).astype(
        np.float32), device=cuda)
    got = pst._solve(sched, b)
    for j in range(3):
        assert torch.equal(got[:, j], pst._solve(sched, b[:, j].clone()))
    vals, inv = pst.schedule_values(
        sched, l.values[None] * torch.tensor([[1.0], [0.5]], device=cuda))
    bb = b[:, :2].T.contiguous()
    got = pst._solve(sched, bb, vals, inv)
    for j in range(2):
        assert torch.equal(got[j], pst._solve(
            sched, bb[j:j + 1], vals[j:j + 1], inv[j:j + 1])[0])
