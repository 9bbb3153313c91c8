"""The port's distributed direct programs as compiled programs
(``parallel/comm.py::compiled`` over ``runtime/graphs.py``): the sharded
triangular solve, the sharded scatter-list and supernodal numeric phases
and the sharded BCR solve, each one CUDA graph on the card, and the
communicators' part of a graph's key.

On the CPU ``graphs.run`` calls its function directly, so these cases hold
each restructured entry point against the JAX package: called twice on one
owner (schedule, or the BCR module's) with different seeded numpy inputs,
the second call being the one that would replay on the card, at s ∈ {1, 2,
4} ranks (the JAX functions on ``row_mesh(s)`` of the 8-device simulated
CPU mesh, the port's on ``LocalComm`` meshes). Tolerances, those of
``tests/test_torch_parallel_direct.py`` and ``test_torch_parallel_bcr.py``:

* factors and solves against JAX's: ``rtol=1e-5``, ``atol=1e-6·max|ref|``;
  the BCR solve ``rtol=1e-4``, ``atol=1e-5·max|ref|``;
* the port's distributed scatter-list factor and triangular solves: bit
  for bit its single-device ones.

The communicators: ``LocalComm`` is capturable and keeps its graphs on the
owner; a gloo ``TorchDistComm`` is not capturable and runs op by op; a
sharded key and a single-device key on one schedule differ, and so do the
keys of two meshes.

The ``cuda``-marked cases run on the card (``--noconftest``; the JAX
package is imported only by the CPU cases): each program captures on its
stated call and its replays equal the same call under eager loops within
``1e-5·max|ref|``; the sharded supernodal replay holds the eager loop's K3
and rect-entry launches (by kernel name); over NCCL at world size 1 the
replays of ``TorchDistComm`` equal eager ``LocalComm`` at one shard bit for
bit under deterministic algorithms (the supernodal factor, whose add-back
adds with atomics, within ``1e-6·max|ref|``).
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.models import banded as pbd
from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as psc
from basic_sparse_matrix_tpu_torch.models import sparse_triangular as pst
from basic_sparse_matrix_tpu_torch.models import supernodal as psn
from basic_sparse_matrix_tpu_torch.ops import reorder as pr
from basic_sparse_matrix_tpu_torch.parallel import bcr as ppb
from basic_sparse_matrix_tpu_torch.parallel import cholesky as ppc
from basic_sparse_matrix_tpu_torch.parallel import comm as pcomm
from basic_sparse_matrix_tpu_torch.parallel import mesh as pm
from basic_sparse_matrix_tpu_torch.parallel import supernodal as pps
from basic_sparse_matrix_tpu_torch.parallel import triangular as ppt
from basic_sparse_matrix_tpu_torch.runtime import graphs
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)

SHARDS = [1, 2, 4]
RTOL = 1e-5
ATOL_OF_MAX = 1e-6
REPLAY_ATOL_OF_MAX = 1e-5
NCCL_ATOL_OF_MAX = 1e-6


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
    """The JAX package's modules these cases hold the port to."""
    pytest.importorskip("basic_sparse_matrix_tpu")
    import basic_sparse_matrix_tpu as J
    from basic_sparse_matrix_tpu.models import banded as jbd
    from basic_sparse_matrix_tpu.models import sparse_cholesky as jsc
    from basic_sparse_matrix_tpu.models import sparse_triangular as jst
    from basic_sparse_matrix_tpu.models import supernodal as jsn
    from basic_sparse_matrix_tpu.parallel import bcr as jpb
    from basic_sparse_matrix_tpu.parallel import cholesky as jpc
    from basic_sparse_matrix_tpu.parallel import mesh as jm
    from basic_sparse_matrix_tpu.parallel import supernodal as jps
    from basic_sparse_matrix_tpu.parallel import triangular as jpt

    return types.SimpleNamespace(J=J, jbd=jbd, jsc=jsc, jst=jst, jsn=jsn,
                                 jpb=jpb, jpc=jpc, jm=jm, jps=jps, jpt=jpt)


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
    n, r, c, v = _lap(k, dim)
    a = P.CSR.from_coo_arrays((n, n), r, c, v, device=device)
    return pr.permute_symmetric(a, pr.nd_permutation(a))


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


def _value_sets(a, count, seed):
    """``count`` value sets ``s·A + c·I`` of ``a``'s pattern (s in [1, 2),
    c in [0, 1), every system SPD): (count, nnz) float32 numpy."""
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    rng = np.random.default_rng(seed)
    s = (1.0 + rng.random(count)).astype(np.float32)
    c = rng.random(count).astype(np.float32)
    return (s[:, None] * values[None, :]
            + c[:, None] * (indices == rows)[None, :]).astype(np.float32)


def _banded_spd(rng, n, bw):
    a = np.zeros((n, n), dtype=np.float32)
    for d in range(1, bw + 1):
        vals = rng.standard_normal(n - d).astype(np.float32) * 0.3
        a += np.diag(vals, k=d) + np.diag(vals, k=-d)
    a += (2.0 * bw + 2.0) * np.eye(n, dtype=np.float32)
    return a


def _bcr_blocks(dense, nb):
    """(D, E) of ``dense`` blocked at ``nb``, E padded with a zero last
    coupling (numpy)."""
    D, E = pbd.band_blocks(P.CSR.from_dense(dense), nb)
    return D, np.concatenate([E, np.zeros((1, nb, nb), np.float32)])


def _jax_csr(jax_pkg, a):
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    return jax_pkg.J.CSR.from_coo_arrays(a.dims, rows, indices, values)


def _close(got, want, rtol=RTOL, atol_of_max=ATOL_OF_MAX):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_of_max * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def _mesh(s, device="cpu"):
    return pm.row_mesh(s, comm="local", device=device)


# ---- the triangular solve ---------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_triangular_solves_twice_match_jax(jax_pkg, s):
    """Two right-hand sides through one lower and one mirrored schedule of
    an ND factor: each solve against JAX's and bit for bit the
    single-device solve on the same schedule."""
    pa = _nd_lap(7, 2)
    l = psc.cholesky_sparse(pa)
    jl = _jax_csr(jax_pkg, l)
    pmesh, jmesh = _mesh(s), jax_pkg.jm.row_mesh(s)
    rng = np.random.default_rng(10 + s)
    for lower in (True, False):
        lm, jlm = (l, jl) if lower else (l.transpose(), jl.transpose())
        sched = pst.build_schedule(lm, lower=lower)
        jsched = jax_pkg.jst.build_schedule(jlm, lower=lower)
        for _ in range(2):
            b = rng.standard_normal((l.rows, 3)).astype(np.float32)
            bt = torch.as_tensor(b)
            if lower:
                got = ppt.solve_triangular_sharded(sched, bt, pmesh)
                want = jax_pkg.jpt.solve_triangular_sharded(jsched, b, jmesh)
            else:
                # the mirrored schedule solves the reversed system
                got = torch.flip(ppt.solve_triangular_sharded(
                    sched, torch.flip(bt, (0,)), pmesh), (0,))
                want = jax_pkg.jpt.solve_sparse_distributed(
                    jlm, b, jmesh, lower=False)
            _close(got, want)
            assert torch.equal(got, pst.solve_triangular_sparse(None, bt,
                                                                sched))
        assert graphs.count(sched) == 0 and graphs.calls(sched) == 0


# ---- the scatter-list numeric phase -----------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_scatter_list_refactorization_matches_jax(jax_pkg, s):
    a = P.CSR.from_dense(_tree(150, 5))
    a = pr.permute_symmetric(a, pr.rcm_permutation(a))
    ps = psc.analyze(a)
    js = jax_pkg.jsc.analyze(_jax_csr(jax_pkg, a))
    pmesh, jmesh = _mesh(s), jax_pkg.jm.row_mesh(s)
    firsts = []
    for vals in _value_sets(a, 2, seed=s):
        v = torch.as_tensor(vals)
        got = ppc.factorize_sharded(ps, v, pmesh)
        _close(got, jax_pkg.jpc.factorize_sharded(js, vals, jmesh))
        assert torch.equal(got, psc.factorize(ps, v))
        firsts.append(got)
    assert not torch.equal(firsts[0], firsts[1])
    assert graphs.count(ps) == 0 and graphs.calls(ps) == 0


# ---- the supernodal numeric phase -------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_supernodal_refactorization_matches_jax(jax_pkg, s):
    """Two value sets through one schedule of the ND-ordered 8² Laplacian:
    each against JAX's sharded factor and the port's single-device one."""
    pa = _nd_lap(8, 2)
    ps = psn.analyze_supernodal(pa)
    js = jax_pkg.jsn.analyze_supernodal(_jax_csr(jax_pkg, pa))
    pmesh, jmesh = _mesh(s), jax_pkg.jm.row_mesh(s)
    for vals in _value_sets(pa, 2, seed=20 + s):
        v = torch.as_tensor(vals)
        got = pps.factorize_supernodal_sharded(ps, v, pmesh)
        _close(got, np.asarray(jax_pkg.jps.factorize_supernodal_sharded(
            js, vals, jmesh)))
        _close(got, psn.factorize_supernodal(ps, v))
    assert graphs.count(ps) == 0 and graphs.calls(ps) == 0


def test_long_tables_are_made_once_and_shared():
    """The int64 tables of the numeric phases are the schedule's, made
    once, and the sharded phase reads the same ones."""
    pa = _nd_lap(8, 2)
    sched = psn.analyze_supernodal(pa)
    tabs = psn.long_tables(sched)
    assert psn.long_tables(sched) is tabs
    assert all(t.dtype == (torch.bool if i not in psn._INT_TABLES
                           else torch.int64)
               for g in tabs for i, t in enumerate(g))
    assert all(torch.equal(t.long(), w.long()) for g, h in
               zip(tabs, sched.tabs) for t, w in zip(g, h))
    pps.factorize_supernodal_sharded(sched, pa.values, _mesh(2))
    assert psn.long_tables(sched) is tabs


# ---- the BCR solve ----------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_bcr_twice_matches_jax(jax_pkg, s):
    """Two systems of one shape (the module's owner keys by shape), two
    right-hand sides each: every solve against JAX's."""
    rng = np.random.default_rng(40 + s)
    pmesh, jmesh = _mesh(s), jax_pkg.jm.row_mesh(s)
    for bw in (3, 5):
        D, E = _bcr_blocks(_banded_spd(rng, 128, bw), 8)
        for _ in range(2):
            b = rng.standard_normal((16, 8, 2)).astype(np.float32)
            got = ppb.bcr_solve_sharded(torch.as_tensor(D),
                                        torch.as_tensor(E),
                                        torch.as_tensor(b), pmesh)
            want = np.asarray(jax_pkg.jpb.bcr_solve_sharded(D, E, b, jmesh))
            _close(got, want, rtol=1e-4, atol_of_max=1e-5)
    assert graphs.count(ppb._BCR_SHARDED) == 0


# ---- the communicators' part of a key ---------------------------------------
class _Owner:
    """A graph owner."""


def test_local_comm_is_capturable_and_keeps_graphs_on_the_owner():
    comm = pcomm.LocalComm(4)
    owner = _Owner()
    assert comm.capturable
    assert comm.graph_key == ("local", 4)
    assert pcomm.LocalComm(2).graph_key != comm.graph_key
    assert comm.graph_owner(owner) is owner


@pytest.fixture
def recorded(monkeypatch):
    """Every ``graphs.run`` call's (owner, tag), the function run as it
    is."""
    calls = []

    def run(owner, tag, fn, *operands, **_):
        calls.append((owner, tag))
        return fn(*operands)
    monkeypatch.setattr(graphs, "run", run)
    return calls


def test_sharded_and_single_device_keys_differ_on_one_schedule(recorded):
    """A schedule serves the single-device and the sharded programs: every
    program's tag on it is its own, and one mesh's differs from
    another's."""
    pa = _nd_lap(6, 2)
    sn = psn.analyze_supernodal(pa)
    sc = psc.analyze(pa)
    l = psc.cholesky_sparse(pa)
    tri = pst.build_schedule(l)
    b = torch.ones(pa.rows)
    recorded.clear()
    for mesh in (None, _mesh(1), _mesh(2)):
        if mesh is None:
            psn.factorize_supernodal(sn, pa.values)
            psc.factorize(sc, pa.values)
            pst.solve_triangular_sparse(l, b, tri)
        else:
            pps.factorize_supernodal_sharded(sn, pa.values, mesh)
            ppc.factorize_sharded(sc, pa.values, mesh)
            ppt.solve_triangular_sharded(tri, b, mesh)
    for sched in (sn, sc, tri):
        tags = [tag for owner, tag in recorded if owner is sched]
        assert len(tags) == 3 and len(set(tags)) == 3, tags
    single = [tag for owner, tag in recorded if owner is sn][0]
    assert single == psn.numeric_tag(sn)


@pytest.fixture
def gloo_world(tmp_path):
    """A gloo process group of world size 1 in this process, destroyed
    after the case."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield dist
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_a_gloo_comm_is_not_capturable_and_runs_op_by_op(gloo_world,
                                                         recorded):
    mesh = pm.row_mesh(comm="dist", device="cpu")
    comm = mesh.axis("rows")
    assert isinstance(comm, pcomm.TorchDistComm)
    assert comm.backend == "gloo" and not comm.capturable
    assert comm.graph_key[:4] == ("dist", "gloo", (0,), 0)
    assert comm.graph_key != _mesh(1).axis("rows").graph_key
    pa = _nd_lap(6, 2)
    sc = psc.analyze(pa)
    recorded.clear()
    got = ppc.factorize_sharded(sc, pa.values, mesh)
    assert recorded == []                 # no graph, not even a count
    assert torch.equal(got, ppc.factorize_sharded(sc, pa.values, _mesh(1)))


def test_a_dist_comm_keeps_its_graph_holders(gloo_world):
    """A ``TorchDistComm`` keeps one holder per owner, which goes with the
    communicator, and refuses a holder once its process group is gone."""
    import gc
    import weakref

    comm = pm.row_mesh(comm="dist", device="cpu").axis("rows")
    owner, other = _Owner(), _Owner()
    holder = comm.graph_owner(owner)
    assert comm.graph_owner(owner) is holder
    assert comm.graph_owner(other) is not holder and holder is not owner
    alive = weakref.ref(holder)
    second = pm.row_mesh(comm="dist", device="cpu").axis("rows")
    assert second.graph_owner(owner) is not holder
    del holder, comm
    gc.collect()
    assert alive() is None
    gloo_world.destroy_process_group()
    with pytest.raises(RuntimeError, match="destroyed"):
        second.graph_owner(owner)


# ---- on the card ------------------------------------------------------------
@contextlib.contextmanager
def _eager():
    """``graphs.run`` calls its function directly: the loops op by op."""
    run = graphs.run
    graphs.run = lambda owner, tag, fn, *operands, **_: fn(*operands)
    try:
        yield
    finally:
        graphs.run = run


def _near(got, want, frac=REPLAY_ATOL_OF_MAX):
    assert got.shape == want.shape and want.numel()
    assert float((got - want).abs().max()) <= frac * float(want.abs().max())


def _direct_case(cuda, path):
    """(owner, call) of one direct program on the card: ``call(i, mesh)``
    runs it on the ``i``-th input."""
    if path == "bcr":
        rng = np.random.default_rng(5)
        D, E = (torch.as_tensor(x, device=cuda)
                for x in _bcr_blocks(_banded_spd(rng, 256, 4), 8))
        bs = torch.as_tensor(rng.standard_normal((4, 32, 8, 2)).astype(
            np.float32), device=cuda)
        return ppb._BCR_SHARDED, lambda i, mesh: ppb.bcr_solve_sharded(
            D, E, bs[i], mesh)
    a = _nd_lap(8, 3, device=cuda)
    vals = torch.as_tensor(_value_sets(a, 4, 3), device=cuda)
    if path == "supernodal":
        sched = psn.analyze_supernodal(a, relax=8)
        return sched, lambda i, mesh: pps.factorize_supernodal_sharded(
            sched, vals[i], mesh)
    if path == "cholesky":
        sched = psc.analyze(a)
        return sched, lambda i, mesh: ppc.factorize_sharded(sched, vals[i],
                                                            mesh)
    sched = pst.build_schedule(psc.cholesky_sparse(a))
    bs = torch.randn((4, a.rows, 3), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    return sched, lambda i, mesh: ppt.solve_triangular_sharded(sched, bs[i],
                                                               mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("path,capture_on", [
    ("triangular", 1), ("cholesky", 2), ("supernodal", 2), ("bcr", 2)])
def test_each_direct_program_captures_on_its_call(cuda, path, capture_on):
    owner, call = _direct_case(cuda, path)
    mesh = _mesh(4, cuda)
    # the BCR module's owner may hold the graphs of earlier card tests, at
    # most MAX_GRAPHS_PER_OWNER: start it empty so a capture shows
    graphs._GRAPHS.pop(owner, None)
    start = graphs.count(owner)
    for i in range(4):
        got = call(i, mesh)
        assert graphs.count(owner) - start == int(i + 1 >= capture_on), i
        with _eager():
            _near(got, call(i, mesh))
    assert graphs.count(owner) - start == 1


@pytest.mark.cuda
@pytest.mark.parametrize("scatter", ["vmem", "pallas"])
def test_the_sharded_supernodal_replay_holds_the_eager_kernels(
        cuda, port_config, scatter):
    """Forced K3 reads and add-back routes at 2 ranks: a replay holds as
    many K3 and rect-entry launches as the eager call's wrappers count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
    from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3

    port_config(supernodal_gather="kernel", supernodal_scatter=scatter)
    _, call = _direct_case(cuda, "supernodal")
    mesh = _mesh(2, cuda)
    before = (k3.LAUNCHES, k4.LAUNCHES + k5.LAUNCHES)
    call(0, mesh)                             # eager, counted
    want = (k3.LAUNCHES - before[0], k4.LAUNCHES + k5.LAUNCHES - before[1])
    assert want[0] > 0 and want[1] > 0
    call(1, mesh)                             # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call(2, mesh)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert (sum("runs_read_kernel" in n for n in names),
            sum("addback_rects_kernel" in n for n in names)) == want


@pytest.fixture
def nccl_world(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield dist
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["triangular", "cholesky", "supernodal",
                                  "bcr"])
def test_nccl_replays_equal_local_comm(cuda, nccl_world, path):
    """World size 1 over NCCL: the capturing call and a replay on
    ``TorchDistComm`` against eager ``LocalComm`` at one shard, under
    deterministic algorithms; the graphs go with the communicator."""
    import gc
    import weakref

    mesh = pm.row_mesh(comm="dist", device=cuda)
    comm = mesh.axis("rows")
    assert comm.capturable and comm.graph_key[:2] == ("dist", "nccl")
    owner, call = _direct_case(cuda, path)
    start = graphs.count(owner)
    local = _mesh(1, cuda)
    torch.use_deterministic_algorithms(True)
    try:
        outs = [call(i, mesh) for i in range(3)]
        holder = comm.graph_owner(owner)
        assert graphs.count(holder) == 1 and graphs.count(owner) == start
        for i in (1, 2):
            with _eager():
                want = call(i, local)
            if path == "supernodal":
                _near(outs[i], want, NCCL_ATOL_OF_MAX)
            else:
                assert torch.equal(outs[i], want), i
    finally:
        torch.use_deterministic_algorithms(False)
    alive = weakref.ref(holder)
    del holder, comm, mesh
    gc.collect()
    assert alive() is None
