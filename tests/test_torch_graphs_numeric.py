"""The port's numeric phases as compiled programs (``runtime/graphs.py``):
the supernodal and the scatter-list factorizations, captured as one CUDA
graph per schedule and value shape on their second call and replayed on
every later one.

On the CPU ``graphs.run`` calls its function directly, so these cases hold
the restructured entry points against the JAX package, each called twice on
one schedule with different values (the second call is the one that would
capture on the card), inputs from a seed with numpy:

* ``factorize_supernodal`` on the ND-ordered 9², 16² and 8³ Laplacians at
  relax 8 (relax 0 in ``test_torch_graphs_numeric_relax0.py``), and a
  batch of 3 systems on the 8³ one, against JAX's
  ``factorize_supernodal`` (its Pallas kernels in interpret mode) within
  ``rtol=1e-5`` and ``atol=1e-5·max|ref|`` (float32 products summed in
  another order);
* the scatter-list ``factorize`` on a 200-node tree Laplacian against JAX's
  ``factorize`` under the same bounds;
* the tag: a change of ``supernodal_scatter``, ``supernodal_gather``,
  ``matmul_precision`` or torch's deterministic-algorithms flag changes the
  key of the numeric graph;
* ``capture_on`` counting: a CPU call builds no graph and counts no call.

The ``cuda``-marked cases run on the card (the JAX package is imported only
by the CPU cases, since the card's machine has no jax): the first call runs
eagerly and builds no graph, the second captures, the third replays and
equals the eager loop within ``1e-5·max|ref|``; a configuration change
captures anew; deterministic algorithms; dropping the schedule frees its
graphs; K3 and the add-back's rect entry launch inside the captured phase
(counted by kernel name under ``torch.profiler``); a ``DirectSolver``'s own
factorization captures nothing.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as psc
from basic_sparse_matrix_tpu_torch.models import supernodal as psn
from basic_sparse_matrix_tpu_torch.ops import reorder as pr
from basic_sparse_matrix_tpu_torch.runtime import graphs
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_OF_MAX = 1e-5
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


@pytest.fixture
def port_config():
    old = pcfg.get_config()
    yield lambda **kw: pcfg.set_config(dataclasses.replace(old, **kw))
    pcfg.set_config(old)


def _lap(k, dim):
    """The (2·dim+1)-point Laplacian on a k^dim grid as COO arrays."""
    n = k ** dim
    idx = np.arange(n).reshape((k,) * dim)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 2.0 * dim)]
    for ax in range(dim):
        a = np.take(idx, range(k - 1), axis=ax).ravel()
        b = np.take(idx, range(1, k), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    return (n, np.concatenate(r), np.concatenate(c),
            np.concatenate(v).astype(np.float32))


def _nd_lap(k, dim, device="cpu"):
    """The ND-ordered Laplacian (port CSR) and its COO arrays in that
    order."""
    n, r, c, v = _lap(k, dim)
    a = P.CSR.from_coo_arrays((n, n), r, c, v, device=device)
    return pr.permute_symmetric(a, pr.nd_permutation(a))


def _value_sets(a, count, seed):
    """``count`` value sets of ``a``'s pattern, ``s·A + c·I`` with ``s`` in
    [1, 2) and ``c`` in [0, 1) from the seed (every system SPD):
    (count, nnz) float32 numpy."""
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    rng = np.random.default_rng(seed)
    s = (1.0 + rng.random(count)).astype(np.float32)
    c = rng.random(count).astype(np.float32)
    return (s[:, None] * values[None, :]
            + c[:, None] * (indices == rows)[None, :]).astype(np.float32)


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


def _close(got, want, rtol=RTOL, atol_of_max=ATOL_OF_MAX):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_of_max * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def _jax_csr(jax_pkg, a):
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    return jax_pkg.CSR.from_coo_arrays(a.dims, rows, indices, values)


# ---- supernodal: two value sets on one schedule against JAX ---------------
_GRIDS = {"lap2d_9": (9, 2), "lap2d_16": (16, 2), "lap3d_8": (8, 3)}


def supernodal_twice_against_jax(jax_pkg, grid, relax):
    """Two value sets through one schedule, each against JAX's factor."""
    from basic_sparse_matrix_tpu.models import supernodal as jsn

    pa = _nd_lap(*_GRIDS[grid])
    ja = _jax_csr(jax_pkg, pa)
    ps = psn.analyze_supernodal(pa, relax=relax)
    js = jsn.analyze_supernodal(ja, relax=relax)
    assert ps.nnz_l == js.nnz_l
    firsts = []
    for vals in _value_sets(pa, 2, seed=len(grid) + relax):
        got = psn.factorize_supernodal(ps, torch.as_tensor(vals))
        _close(got, jsn.factorize_supernodal(js, vals))
        firsts.append(got)
    assert not torch.equal(firsts[0], firsts[1])
    assert graphs.count(ps) == 0 and graphs.calls(ps) == 0


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_supernodal_refactorization_matches_jax(jax_pkg, grid):
    """Relaxed supernodes (relax 8); relax 0 in
    ``test_torch_graphs_numeric_relax0.py``."""
    supernodal_twice_against_jax(jax_pkg, grid, 8)


def test_supernodal_batch_refactorization_matches_jax(jax_pkg):
    """Two batches of 3 systems on one schedule: each system against its
    own JAX factor."""
    from basic_sparse_matrix_tpu.models import supernodal as jsn

    pa = _nd_lap(8, 3)
    ps = psn.analyze_supernodal(pa, relax=8)
    js = jsn.analyze_supernodal(_jax_csr(jax_pkg, pa), relax=8)
    for seed in (30, 31):
        vals = _value_sets(pa, 3, seed)
        got = psn.factorize_supernodal(ps, torch.as_tensor(vals))
        assert got.shape == (3, ps.nnz_l)
        for b in range(3):
            _close(got[b], jsn.factorize_supernodal(js, vals[b]))


# ---- scatter-list: two value sets on one schedule against JAX -------------
@pytest.mark.parametrize("ordering", ["natural", "rcm"])
def test_scatter_list_refactorization_matches_jax(jax_pkg, ordering):
    from basic_sparse_matrix_tpu.models import sparse_cholesky as jsc

    a = P.CSR.from_dense(_tree(200, 5))
    if ordering == "rcm":
        a = pr.permute_symmetric(a, pr.rcm_permutation(a))
    ps = psc.analyze(a)
    js = jsc.analyze(_jax_csr(jax_pkg, a))
    assert ps.n_levels > 5
    for vals in _value_sets(a, 2, seed=7):
        got = psc.factorize(ps, torch.as_tensor(vals))
        _close(got, jsc.factorize(js, vals))
    got = psc.factorize(ps, torch.as_tensor(_value_sets(a, 4, seed=8)))
    assert got.shape == (4, ps.nnz_l)
    assert graphs.count(ps) == 0 and graphs.calls(ps) == 0


# ---- the tag ----------------------------------------------------------------
@pytest.fixture(scope="module")
def sched_8():
    return psn.analyze_supernodal(_nd_lap(8, 3), relax=8)


@pytest.mark.parametrize("field,value", [
    ("supernodal_scatter", "element"), ("supernodal_scatter", "delta"),
    ("supernodal_gather", "element"), ("supernodal_gather", "window"),
    ("matmul_precision", "default"),
])
def test_a_config_change_changes_the_numeric_key(sched_8, port_config, field,
                                                 value):
    before = psn.numeric_tag(sched_8)
    assert before == psn.numeric_tag(sched_8)
    port_config(**{field: value})
    assert psn.numeric_tag(sched_8) != before


def test_the_deterministic_flag_changes_the_numeric_key(sched_8):
    before = psn.numeric_tag(sched_8)
    host = graphs.host_state()
    torch.use_deterministic_algorithms(True)
    try:
        assert psn.numeric_tag(sched_8) != before
        assert graphs.host_state() != host
    finally:
        torch.use_deterministic_algorithms(False)
    assert psn.numeric_tag(sched_8) == before


def test_groups_per_program_keeps_the_key(sched_8, port_config):
    before = psn.numeric_tag(sched_8)
    port_config(supernodal_groups_per_program=1)
    assert psn.numeric_tag(sched_8) == before


# ---- capture_on on the CPU -------------------------------------------------
class _Owner:
    """A graph owner for the counting cases."""


@pytest.mark.parametrize("capture_on", [1, 2, 3])
def test_a_cpu_call_counts_nothing(capture_on):
    owner = _Owner()
    owners = graphs.owners()
    x = torch.arange(6.0)
    for _ in range(4):
        out = graphs.run(owner, "double", lambda t: 2 * t, x,
                         capture_on=capture_on)
        assert torch.equal(out, 2 * x)
    assert graphs.count(owner) == 0 and graphs.calls(owner) == 0
    assert graphs.owners() == owners


def test_a_cpu_numeric_phase_builds_no_graph(sched_8):
    pa = _nd_lap(8, 3)
    vals = torch.as_tensor(_value_sets(pa, 1, 3)[0])
    for _ in range(3):
        psn.factorize_supernodal(sched_8, vals)
    tree = P.CSR.from_dense(_tree(60, 2))
    sc = psc.analyze(tree)
    for _ in range(3):
        psc.factorize(sc, tree.values)
    for owner in (sched_8, sc):
        assert graphs.count(owner) == 0 and graphs.calls(owner) == 0


# ---- on the card ------------------------------------------------------------
def _near(got, want):
    assert got.shape == want.shape and want.numel()
    assert float((got - want).abs().max()) \
        <= REPLAY_ATOL_OF_MAX * float(want.abs().max())


def _card_case(cuda, k=8, dim=3, relax=8, count=3, seed=20):
    """An ND-ordered Laplacian on the card, its schedule and ``count``
    value sets."""
    a = _nd_lap(k, dim, device=cuda)
    sched = psn.analyze_supernodal(a, relax=relax)
    vals = torch.as_tensor(_value_sets(a, count, seed), device=cuda)
    return a, sched, vals


def _eager_supernodal(sched, values):
    return psn._factorize_whole(sched, *psn._numeric_modes(sched), values)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [False, True], ids=["one", "Bt=3"])
def test_the_second_factorization_captures_and_the_third_replays(cuda,
                                                                 batch):
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3

    _, sched, vals = _card_case(cuda, count=9)
    sets = [vals[3 * i: 3 * i + 3] if batch else vals[i] for i in range(3)]
    counts = []
    for i, v in enumerate(sets):
        got = psn.factorize_supernodal(sched, v)
        counts.append(graphs.count(sched))
        before = k3.LAUNCHES
        _near(got, _eager_supernodal(sched, v))
        assert k3.LAUNCHES > before       # the eager loop reads through K3
    assert counts == [0, 1, 1]
    before = k3.LAUNCHES
    again = psn.factorize_supernodal(sched, sets[0])
    assert k3.LAUNCHES == before          # a replay runs no wrapper
    _near(again, _eager_supernodal(sched, sets[0]))


@pytest.mark.cuda
def test_a_config_change_captures_anew(cuda, port_config):
    _, sched, vals = _card_case(cuda)
    for v in vals[:2]:
        psn.factorize_supernodal(sched, v)
    assert graphs.count(sched) == 1
    port_config(supernodal_scatter="element", supernodal_gather="element")
    first = psn.factorize_supernodal(sched, vals[2])
    assert graphs.count(sched) == 1       # the new key's first call: eager
    second = psn.factorize_supernodal(sched, vals[2])
    assert graphs.count(sched) == 2
    want = _eager_supernodal(sched, vals[2])
    _near(first, want)
    _near(second, want)


@pytest.mark.cuda
def test_the_numeric_replay_under_deterministic_algorithms(cuda):
    """The deterministic ``index_add_`` and ``index_put_`` are capturable:
    replays and the eager loop agree bit for bit."""
    _, sched, vals = _card_case(cuda, k=12, dim=2)
    torch.use_deterministic_algorithms(True)
    try:
        outs = [psn.factorize_supernodal(sched, vals[0]) for _ in range(3)]
        eager = _eager_supernodal(sched, vals[0])
    finally:
        torch.use_deterministic_algorithms(False)
    assert graphs.count(sched) == 1
    assert all(torch.equal(o, eager) for o in outs)


@pytest.mark.cuda
def test_dropping_the_schedule_frees_its_numeric_graphs(cuda):
    """What the process keeps once (cuBLAS and cuSOLVER workspaces of the
    warm-up and capture streams) is made by a first schedule's captures;
    a second schedule's graphs then go with it, to the byte."""
    a, sched, vals = _card_case(cuda)
    for v in vals[:2]:
        psn.factorize_supernodal(sched, v)
    del a, sched, vals
    torch.cuda.synchronize()
    gc.collect()
    held = torch.cuda.memory_allocated()
    owners = graphs.owners()
    a, sched, vals = _card_case(cuda)
    for v in vals[:2]:
        psn.factorize_supernodal(sched, v)
    assert graphs.count(sched) == 1 and graphs.owners() == owners + 1
    alive = weakref.ref(sched)
    del sched, a, vals
    gc.collect()
    assert alive() is None and graphs.owners() == owners
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= held


def _kernel_counts(fn):
    """Device kernels of one ``fn()`` under ``torch.profiler`` by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return {"runs_read": sum("runs_read_kernel" in n for n in names),
            "addback_rects": sum("addback_rects_kernel" in n for n in names),
            "all": len(names)}


@pytest.mark.cuda
@pytest.mark.parametrize("scatter", ["vmem", "pallas"])
def test_the_kernels_launch_inside_the_captured_phase(cuda, port_config,
                                                      scatter):
    """Forced K3 reads and add-back routes: a replay holds as many K3 and
    rect-entry launches as the eager loop's wrappers count."""
    from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
    from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3

    port_config(supernodal_gather="kernel", supernodal_scatter=scatter)
    _, sched, vals = _card_case(cuda)
    before = (k3.LAUNCHES, k4.LAUNCHES + k5.LAUNCHES)
    psn.factorize_supernodal(sched, vals[0])          # eager, counted
    want = (k3.LAUNCHES - before[0], k4.LAUNCHES + k5.LAUNCHES - before[1])
    assert want[0] > 0 and want[1] > 0
    psn.factorize_supernodal(sched, vals[1])          # the capture
    got = _kernel_counts(lambda: psn.factorize_supernodal(sched, vals[2]))
    assert (got["runs_read"], got["addback_rects"]) == want


@pytest.mark.cuda
def test_a_direct_solvers_factorization_captures_nothing(cuda, port_config):
    port_config(ordering="nd", banded_max_block=0)
    n, r, c, v = _lap(8, 3)
    a = P.CSR.from_coo_arrays((n, n), r, c, v, device=cuda)
    solver = P.DirectSolver(a)
    assert solver.kind == "supernodal"
    assert graphs.count(solver.sched) == 0
    assert graphs.calls(solver.sched) == 1


@pytest.mark.cuda
def test_the_scatter_list_phase_captures_on_its_second_call(cuda):
    a = P.CSR.from_dense(_tree(300, 9), device=cuda)
    sched = psc.analyze(a)
    vals = torch.as_tensor(_value_sets(a, 6, 4), device=cuda)
    for i, (v, want_count) in enumerate(((vals[0], 0), (vals[1], 1),
                                         (vals[2], 1), (vals[3:], 1),
                                         (vals[3:], 2))):
        got = psc.factorize(sched, v)
        assert graphs.count(sched) == want_count, i
        _near(got, psc._factorize_all(sched, v))
    torch.use_deterministic_algorithms(True)
    try:
        outs = [psc.factorize(sched, vals[4]) for _ in range(3)]
        eager = psc._factorize_all(sched, vals[4])
    finally:
        torch.use_deterministic_algorithms(False)
    assert graphs.count(sched) == 3
    assert all(torch.equal(o, eager) for o in outs)
