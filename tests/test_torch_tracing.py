"""The port's recorder (``runtime/profiling.py``): spans, counters and
set-up laps at the serving, SpMM-dispatch, graph-replay, PCG and set-up
boundaries.

On the CPU: nothing is recorded while recording is off; ``recording()``
records nested spans with their parents and one request per root; under a
CPU ``torch.profiler`` session the spans are among the profiler's events and
each session's record starts empty; the SpMM rung counters agree with the
rung the dispatch caches show; the eager PCG loop's host reads are counted;
the IC(0) and direct set-ups write their laps to their ``timings`` and to
the laps table.

The ``cuda``-marked cases run on the card (this file imports no JAX): a
second solve replays without capturing, the graphs' node counts are read
and the replays carry device times, and a fifth key evicts a graph.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.models import pcg as ppcg
from basic_sparse_matrix_tpu_torch.models import sparse_triangular as pst
from basic_sparse_matrix_tpu_torch.runtime import profiling as prof
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)


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


def _lap2(k, device="cpu"):
    """The 5-point Laplacian on a k × k grid."""
    n = k * k
    idx = np.arange(n).reshape(k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 4.0)]
    for a, b in ((idx[:-1].ravel(), idx[1:].ravel()),
                 (idx[:, :-1].ravel(), idx[:, 1:].ravel())):
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    return P.CSR.from_coo_arrays(
        (n, n), np.concatenate(r), np.concatenate(c),
        np.concatenate(v).astype(np.float32), device=device)


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


def _names(snap):
    return [s.name for s in snap.spans]


def test_off_by_default_nothing_is_recorded():
    assert prof.span("bsm.a") is prof.span("bsm.b")
    with prof.span("bsm.a") as s:
        assert s is None
    with prof.recording():
        with prof.span("bsm.kept"):
            prof.count("kept")
    kept = prof.snapshot()
    op = P.SparseOperator(_lap2(6))
    op.matmul(torch.ones(36, 4))
    prof.count("kept", 5)
    with prof.span("bsm.later"):
        pass
    after = prof.snapshot()
    assert _names(after) == _names(kept) == ["bsm.kept"]
    assert after.counters == kept.counters == {"kept": 1}


def test_recording_nests_spans_with_parents_and_requests():
    with prof.recording():
        with prof.span("bsm.root", tag=1):
            with prof.span("bsm.child"):
                with prof.span("bsm.leaf"):
                    time.sleep(0.002)
            with prof.span("bsm.child"):
                time.sleep(0.002)
            time.sleep(0.002)
        with prof.span("bsm.second"):
            with prof.span("bsm.child"):
                pass
        prof.count("n")
        prof.count("n", 2)
    snap = prof.snapshot()
    assert _names(snap) == ["bsm.root", "bsm.child", "bsm.leaf", "bsm.child",
                            "bsm.second", "bsm.child"]
    assert [s.parent for s in snap.spans] == [None, 0, 1, 0, None, 4]
    assert [s.request for s in snap.spans] == [0, 0, 0, 0, 4, 4]
    assert snap.spans[0].attrs == {"tag": 1}
    assert snap.requests() == 2 and snap.counters == {"n": 3}
    assert all(s.end_ns >= s.start_ns for s in snap.spans)
    rows = snap.summary()
    assert rows["bsm.child"]["count"] == 3 and rows["bsm.root"]["count"] == 1
    root, kids = snap.spans[0], snap.spans[1].seconds + snap.spans[3].seconds
    assert rows["bsm.root"]["self_s"] == pytest.approx(
        root.seconds - kids, abs=1e-9)
    assert 0.0015 < rows["bsm.root"]["self_s"] < root.seconds
    assert rows["bsm.leaf"]["self_s"] == rows["bsm.leaf"]["total_s"]
    # a new block starts an empty record
    with prof.recording():
        pass
    assert prof.snapshot().spans == () and prof.snapshot().counters == {}


def test_spans_sit_on_the_cpu_profilers_timeline():
    op = P.SparseOperator(_lap2(40))
    b = torch.ones(1600, 8)
    op.matmul(b)   # the layout is converted before the sessions
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as p:
        op.matmul(b)
        op.matmul(b)
    names = {e.name for e in p.events()}
    assert {"bsm.matmul", "bsm.spmm.dispatch", "bsm.spmm.ell"} <= names
    first = prof.snapshot()
    assert first.requests() == 2
    assert first.summary()["bsm.spmm.dispatch"]["count"] == 2
    assert first.counters == {"spmm.rung.ell": 2}
    with profile(activities=[ProfilerActivity.CPU]):
        op.matmul(b)
    second = prof.snapshot()
    assert second.requests() == 1 and second.counters == {"spmm.rung.ell": 1}
    # ... and it stays the last session's record afterwards
    op.matmul(b)
    assert prof.snapshot().counters == {"spmm.rung.ell": 1}


def _uniform_rows(seed, n, per):
    rng = np.random.default_rng(seed)
    return P.CSR.from_coo_arrays(
        (n, n), np.repeat(np.arange(n), per), rng.integers(0, n, n * per),
        rng.standard_normal(n * per).astype(np.float32))


# The matrices of test_torch_slice.py that reach the CPU's three rungs.
RUNGS = {
    "dense": lambda: P.CSR.from_coo_arrays(
        (200, 200), *np.random.default_rng(1000).integers(0, 200,
                                                          (2, 30_000)),
        np.random.default_rng(1000).integers(0, 255, 30_000).astype(
            np.float32)),
    "ell": lambda: _uniform_rows(2, 3000, 4),
    "gather": lambda: P.CSR.from_coo_arrays(
        (400, 400), np.r_[np.zeros(300, int), np.arange(1, 400)],
        np.r_[np.arange(300), np.zeros(399, int)],
        np.ones(699, np.float32)),
}


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_rung_counters_agree_with_the_caches(rung):
    a = RUNGS[rung]()
    b = torch.ones(a.cols, 8)
    with prof.recording():
        P.mul_dense(a, b)
        P.mul_dense(a, b[None].expand(3, -1, -1))   # a batch: one product
    snap = prof.snapshot()
    cached = ("dense" if a._dense_cache is not None
              else "ell" if a._ell_cache is not None else "gather")
    assert cached == rung
    assert snap.counters == {f"spmm.rung.{rung}": 2}
    rows = snap.summary()
    assert rows["bsm.spmm.dispatch"]["count"] == 2
    assert rows[f"bsm.spmm.{rung}"]["count"] == 2


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_pcg_host_reads_count_the_eager_loops_reads(tol):
    a = _lap2(10)
    b = torch.ones(100)
    setup = ppcg.PCGSetup.build(a)
    with prof.recording():
        _, it, _ = ppcg.pcg_solve(a, b, tol=tol, max_iters=12, setup=setup)
    snap = prof.snapshot()
    # one test a loop turn, one more where it stopped before max_iters, and
    # the residual's float
    reads = it + (it < 12) + 1
    assert (tol == 0.0) == (it == 12)
    assert snap.counters == {"pcg.host_reads": reads}
    rows = snap.summary()
    assert rows["bsm.pcg.read"]["count"] == reads
    assert rows["bsm.pcg.start"]["count"] == 1
    assert rows["bsm.trsv"]["count"] == 2 * (it + 1)


def test_setup_laps_fill_timings_and_the_laps_table():
    a = _lap2(12)
    with prof.recording():
        setup = ppcg.PCGSetup.build(a)
    phases = ("analyze", "numeric", "assemble", "schedules", "ell")
    assert tuple(setup.timings) == phases
    snap = prof.snapshot()
    for k in phases:
        assert setup.timings[k] >= 0
        assert snap.laps[f"pcg.{k}"] == setup.timings[k]
    assert _names(snap) == [f"bsm.pcg.{k}" for k in phases]
    again = ppcg.PCGSetup.from_factor(
        a, P.CSR.from_dense(np.eye(144, dtype=np.float32)))
    assert tuple(again.timings) == ("schedules", "ell")
    # DirectSolver.timings as before, and its laps in the table
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, ordering="rcm",
                                        banded_max_block=0))
    try:
        solver = P.DirectSolver(P.CSR.from_dense(_tree(200, 5)))
    finally:
        pcfg.set_config(old)
    assert solver.kind == "scatter"
    assert tuple(solver.timings) == ("order", "analyze", "numeric",
                                     "assemble", "schedules")
    laps = prof.snapshot().laps
    assert all(laps[f"direct.{k}"] == v for k, v in solver.timings.items())


def test_operator_requests_are_the_roots():
    op = P.SparseOperator(P.CSR.from_dense(_tree(120, 3)))
    b = torch.ones(120)
    with prof.recording():
        op.solve(b)
        op.solve_cg(b, tol=1e-5, max_iters=50)
        op.matmul(b[:, None])
    snap = prof.snapshot()
    roots = [s.name for s in snap.spans if s.parent is None]
    assert roots == ["bsm.solve", "bsm.solve_cg", "bsm.matmul"]
    by_request = {}
    for s in snap.spans:
        by_request.setdefault(snap.spans[s.request].name, set()).add(s.name)
    assert {"bsm.direct.solve"} <= by_request["bsm.solve"]
    assert {"bsm.pcg.start", "bsm.pcg.read", "bsm.trsv",
            "bsm.pcg.analyze"} <= by_request["bsm.solve_cg"]
    assert "bsm.spmm.dispatch" in by_request["bsm.matmul"]


# ---- on the card ----------------------------------------------------------


def _scatter_solver(device):
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, ordering="rcm",
                                        banded_max_block=0))
    try:
        solver = P.DirectSolver(P.CSR.from_dense(_tree(200, 5),
                                                 device=device))
    finally:
        pcfg.set_config(old)
    assert solver.kind == "scatter"
    return solver


@pytest.mark.cuda
def test_a_second_solve_replays_without_capturing(cuda):
    solver = _scatter_solver(cuda)
    b = torch.ones(200, device=cuda)
    with prof.recording():
        solver.solve(b)
    first = prof.snapshot().counters
    assert first["graphs.captures"] == 2 and first["graphs.replays"] == 2
    with prof.recording():
        x = solver.solve(b)
    snap = prof.snapshot()
    c = snap.counters
    assert c.get("graphs.captures", 0) == 0 and c["graphs.replays"] == 2
    assert c["graphs.nodes"] > 0 and c["graphs.nodes"] == first["graphs.nodes"]
    replays = [s for s in snap.spans if s.name == "bsm.graphs.replay"]
    assert len(replays) == 2
    assert all(s.attrs["device_ms"] > 0 for s in replays)
    torch.testing.assert_close(x, solver.solve(b))


@pytest.mark.cuda
def test_a_fifth_key_evicts_a_graph(cuda):
    from basic_sparse_matrix_tpu_torch.runtime import graphs

    l = _lap2(8, device=cuda)
    sched = pst.build_schedule(
        P.CSR.from_dense(np.tril(l.todense().cpu().numpy()), device=cuda),
        lower=True)
    with prof.recording():
        for k in range(graphs.MAX_GRAPHS_PER_OWNER + 1):
            pst.solve_triangular_sparse(None, torch.ones(64, k + 1,
                                                         device=cuda), sched)
    c = prof.snapshot().counters
    assert c["graphs.captures"] == graphs.MAX_GRAPHS_PER_OWNER + 1
    assert c["graphs.evictions"] == 1
    assert graphs.count(sched) == graphs.MAX_GRAPHS_PER_OWNER
