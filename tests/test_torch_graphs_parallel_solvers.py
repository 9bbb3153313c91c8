"""The port's distributed iterative programs as compiled programs
(``parallel/comm.py::compiled`` over ``runtime/graphs.py``): CG, block-
Jacobi PCG, Chebyshev and Lanczos on a ``ShardedCSR``, each one CUDA graph
on the card.

On the CPU ``graphs.run`` calls its function directly, so these cases hold
each restructured entry point against the JAX package: called twice on one
``ShardedCSR`` with different seeded numpy inputs (Chebyshev also with two
sets of bounds), the second call being the one that would replay on the
card, at s ∈ {1, 2, 4} ranks (the JAX functions on ``row_mesh(s)`` of the
8-device simulated CPU mesh, the port's on ``LocalComm`` meshes), within
the tolerances of ``tests/test_torch_parallel_solvers.py``: iterates and
Lanczos coefficients ``rtol=1e-4``, ``atol=1e-5·max|ref|``.

The ``cuda``-marked cases run on the card (``--noconftest``; the JAX
package is imported only by the CPU cases): each program captures on its
stated call (CG, PCG, Chebyshev the first, Lanczos the second) and its
replays equal the same call under eager loops within ``1e-5·max|ref|``;
new Chebyshev bounds replay the same graph; over NCCL at world size 1 the
replays of ``TorchDistComm`` equal eager ``LocalComm`` at one shard bit for
bit under deterministic algorithms.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.parallel import cg as pcg_
from basic_sparse_matrix_tpu_torch.parallel import chebyshev as pch
from basic_sparse_matrix_tpu_torch.parallel import lanczos as pl
from basic_sparse_matrix_tpu_torch.parallel import mesh as pm
from basic_sparse_matrix_tpu_torch.parallel import pcg as ppcg
from basic_sparse_matrix_tpu_torch.parallel import sharded as psh
from basic_sparse_matrix_tpu_torch.runtime import graphs
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)

SHARDS = [1, 2, 4]
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
    """The JAX package's modules these cases hold the port to."""
    pytest.importorskip("basic_sparse_matrix_tpu")
    import jax.numpy as jnp

    import basic_sparse_matrix_tpu as J
    from basic_sparse_matrix_tpu.parallel import cg as jcg
    from basic_sparse_matrix_tpu.parallel import chebyshev as jch
    from basic_sparse_matrix_tpu.parallel import lanczos as jl
    from basic_sparse_matrix_tpu.parallel import mesh as jm
    from basic_sparse_matrix_tpu.parallel import pcg as jpcg
    from basic_sparse_matrix_tpu.parallel import sharded as jsh

    return types.SimpleNamespace(J=J, jnp=jnp, jcg=jcg, jch=jch, jl=jl,
                                 jm=jm, jpcg=jpcg, jsh=jsh)


def _lap2d(k):
    n = k * k
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(k):
        for j in range(k):
            r = i * k + j
            a[r, r] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < k and 0 <= jj < k:
                    a[r, ii * k + jj] = -1.0
    return a


def _setup(jax_pkg, d, s):
    """The JAX and the port's sharded ``d`` at ``s`` ranks, with meshes."""
    jmesh = jax_pkg.jm.row_mesh(s)
    pmesh = pm.row_mesh(s, comm="local", device="cpu")
    jsa = jax_pkg.jsh.put_sharded(
        jax_pkg.jsh.shard_csr(jax_pkg.J.CSR.from_dense(d), s), jmesh)
    psa = psh.put_sharded(psh.shard_csr(P.CSR.from_dense(d), s), pmesh)
    return jsa, jmesh, psa, pmesh


def _close(got, want, rtol=1e-4, atol_of_max=1e-5):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * np.abs(want).max())


def _rhs(n, count, seed):
    return np.random.default_rng(seed).standard_normal((count, n)).astype(
        np.float32)


# ---- CG and PCG -------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_cg_twice_matches_jax(jax_pkg, s):
    d = _lap2d(7)
    jsa, jmesh, psa, pmesh = _setup(jax_pkg, d, s)
    outs = []
    for b in _rhs(d.shape[0], 2, 30 + s):
        got = pcg_.cg_solve_sharded(psa, b, pmesh, iters=25)
        _close(got, jax_pkg.jcg.cg_solve_sharded(
            jsa, jax_pkg.jnp.asarray(b), jmesh, iters=25))
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])
    assert graphs.count(psa) == 0 and graphs.calls(psa) == 0


@pytest.mark.parametrize("s", SHARDS)
def test_pcg_twice_matches_jax(jax_pkg, s):
    """Two right-hand sides on one set of block-Jacobi factors, built once
    outside the loop."""
    d = _lap2d(7)
    jsa, jmesh, psa, pmesh = _setup(jax_pkg, d, s)
    lfac = ppcg.build_block_jacobi(psa, pmesh)
    lj = jax_pkg.jpcg.build_block_jacobi(jsa, jmesh)
    for b in _rhs(d.shape[0], 2, 40 + s):
        got = ppcg.pcg_solve_sharded(psa, b, pmesh, iters=30, lfac=lfac)
        _close(got, jax_pkg.jpcg.pcg_solve_sharded(
            jsa, jax_pkg.jnp.asarray(b), jmesh, iters=30, lfac=lj))
    assert graphs.count(psa) == 0


# ---- Chebyshev --------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_chebyshev_two_bounds_and_rhs_match_jax(jax_pkg, s):
    """Two right-hand sides under two sets of bounds on one ShardedCSR."""
    d = _lap2d(7)
    jsa, jmesh, psa, pmesh = _setup(jax_pkg, d, s)
    lam = np.linalg.eigvalsh(d.astype(np.float64))
    bounds = [(0.95 * float(lam[0]), 1.01 * float(lam[-1])),
              (0.9 * float(lam[0]), 1.05 * float(lam[-1]))]
    outs = []
    for b, bd in zip(_rhs(d.shape[0], 2, 50 + s), bounds):
        xp, rp = pch.chebyshev_solve_sharded(psa, b, pmesh, iters=40,
                                             bounds=bd)
        xj, rj = jax_pkg.jch.chebyshev_solve_sharded(
            jsa, jax_pkg.jnp.asarray(b), jmesh, iters=40, bounds=bd)
        _close(xp, xj)
        np.testing.assert_allclose(rp, rj, rtol=1e-3)
        outs.append(xp)
    # the same rhs under the other bounds: another iterate
    again, _ = pch.chebyshev_solve_sharded(psa, _rhs(d.shape[0], 2,
                                                     50 + s)[0],
                                           pmesh, iters=40, bounds=bounds[1])
    assert not torch.equal(again, outs[0])
    assert graphs.count(psa) == 0


# ---- Lanczos ----------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_lanczos_twice_matches_jax(jax_pkg, s):
    d = _lap2d(8)
    n = d.shape[0]
    jsa, jmesh, psa, pmesh = _setup(jax_pkg, d, s)
    lam = float(np.abs(np.linalg.eigvalsh(d)).max())
    for v0 in _rhs(psa.padded_rows, 2, 60 + s):
        ja, jb = jax_pkg.jl._lanczos_sharded_jit(
            jsa, jax_pkg.jnp.asarray(v0), 16, jmesh, n=n)
        pa, pb = pl.lanczos_sharded_from(psa, torch.as_tensor(v0), 16,
                                         pmesh, n=n)
        np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-4,
                                   atol=1e-5 * lam)
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-4,
                                   atol=1e-5 * lam)
    assert graphs.count(psa) == 0 and graphs.calls(psa) == 0


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


def _near(got, want):
    assert got.shape == want.shape and want.numel()
    assert float((got - want).abs().max()) \
        <= REPLAY_ATOL_OF_MAX * float(want.abs().max())


def _solver_case(cuda, path, mesh):
    """(ShardedCSR, call) of one iterative program on ``mesh`` on the
    card: ``call(i)`` runs it on the ``i``-th input."""
    d = _lap2d(12)
    sa = psh.put_sharded(psh.shard_csr(P.CSR.from_dense(d), mesh.shape[
        "rows"]), mesh)
    n = d.shape[0]
    vs = torch.as_tensor(_rhs(sa.padded_rows, 4, 7), device=cuda)
    lam = np.linalg.eigvalsh(d.astype(np.float64))
    if path == "cg":
        return sa, lambda i: pcg_.cg_solve_sharded(sa, vs[i, :n], mesh,
                                                   iters=20)
    if path == "pcg":
        lfac = ppcg.build_block_jacobi(sa, mesh)
        return sa, lambda i: ppcg.pcg_solve_sharded(sa, vs[i, :n], mesh,
                                                    iters=20, lfac=lfac)
    if path == "chebyshev":
        return sa, lambda i: pch.chebyshev_solve_sharded(
            sa, vs[i, :n], mesh, iters=30,
            bounds=((0.9 + 0.02 * i) * lam[0], (1.01 + 0.01 * i)
                    * lam[-1]))[0]
    return sa, lambda i: torch.cat(pl.lanczos_sharded_from(
        sa, vs[i], 16, mesh, n=n))


@pytest.mark.cuda
@pytest.mark.parametrize("path,capture_on", [
    ("cg", 1), ("pcg", 1), ("chebyshev", 1), ("lanczos", 2)])
def test_each_iterative_program_captures_on_its_call(cuda, path,
                                                     capture_on):
    """Four calls on new inputs (and, for Chebyshev, new bounds each time):
    one graph, captured on the stated call; every result equals the call
    under eager loops."""
    mesh = pm.row_mesh(4, comm="local", device=cuda)
    sa, call = _solver_case(cuda, path, mesh)
    for i in range(4):
        got = call(i)
        assert graphs.count(sa) == int(i + 1 >= capture_on), i
        with _eager():
            _near(got, call(i))
    assert graphs.count(sa) == 1


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
@pytest.mark.parametrize("path", ["cg", "pcg", "chebyshev", "lanczos"])
def test_nccl_replays_equal_local_comm(cuda, nccl_world, path):
    """World size 1 over NCCL: the capturing call and the replays on
    ``TorchDistComm`` against eager ``LocalComm`` at one shard, bit for
    bit under deterministic algorithms."""
    mesh = pm.row_mesh(comm="dist", device=cuda)
    comm = mesh.axis("rows")
    assert comm.capturable
    local = pm.row_mesh(1, comm="local", device=cuda)
    sa, call = _solver_case(cuda, path, mesh)
    sl, call_l = _solver_case(cuda, path, local)
    torch.use_deterministic_algorithms(True)
    try:
        outs = [call(i) for i in range(3)]
        assert graphs.count(comm.graph_owner(sa)) == 1
        assert graphs.count(sa) == 0
        for i in (1, 2):
            with _eager():
                assert torch.equal(outs[i], call_l(i)), i
    finally:
        torch.use_deterministic_algorithms(False)
