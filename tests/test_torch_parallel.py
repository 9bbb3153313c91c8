"""The port's distributed layout and products (``parallel/mesh``,
``sharded``, ``spmm``, ``spmm2d``) against the JAX package on the CPU.

The JAX functions run on ``row_mesh(s)`` of the 8-device simulated CPU mesh
that ``tests/conftest.py`` sets up; the port's on ``LocalComm`` meshes of
the same shape; inputs are those of ``tests/test_parallel.py``, made from
the same numpy seeds, at s ∈ {1, 2, 4, 8}. Tolerances:

* ``shard_csr``: the padded arrays equal JAX's exactly (int64 / float32),
  also where ``rows % s != 0`` and where ``rows < s``.
* Products (replicated RHS, all-gather, ring, ELL; SpMV; the 2-D ring at
  (4, 2) and (2, 2)): ``rtol=1e-5``, ``atol=1e-6·max|ref|`` (float32 sums
  in another order: the ring adds panel by panel).
* Carried state: the JAX ``ShardedCSR`` fed through
  ``interop.sharded_csr_from_numpy`` gives the port's products the JAX
  results within the same bound.

Also: no module of ``parallel/`` nor ``chip_smoke.py`` imports JAX or the
JAX package (read from the AST), and ``row_mesh()`` with no card and no CPU
asked for raises ``NoDefaultDevice``.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.ops import ell as jell
from basic_sparse_matrix_tpu.parallel import mesh as jm
from basic_sparse_matrix_tpu.parallel import sharded as jsh
from basic_sparse_matrix_tpu.parallel import spmm as jsp
from basic_sparse_matrix_tpu.parallel import spmm2d as jsp2
from basic_sparse_matrix_tpu_torch.ops import ell as pell
from basic_sparse_matrix_tpu_torch.ops import interop
from basic_sparse_matrix_tpu_torch.parallel import comm as pcomm
from basic_sparse_matrix_tpu_torch.parallel import mesh as pm
from basic_sparse_matrix_tpu_torch.parallel import sharded as psh
from basic_sparse_matrix_tpu_torch.parallel import spmm as psp
from basic_sparse_matrix_tpu_torch.parallel import spmm2d as psp2

torch.set_num_threads(1)

SHARDS = [1, 2, 4, 8]
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _dense(rng, rows, cols, density=0.1):
    return ((rng.random((rows, cols)) < density)
            * rng.standard_normal((rows, cols))).astype(np.float32)


def _meshes(s):
    return jm.row_mesh(s), pm.row_mesh(s, comm="local", device="cpu")


def _both_sharded(d, s, jmesh, pmesh):
    return (jsh.put_sharded(jsh.shard_csr(J.CSR.from_dense(d), s), jmesh),
            psh.put_sharded(psh.shard_csr(P.CSR.from_dense(d), s), pmesh))


def _close(got, want, rtol=1e-5, atol_of_max=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * np.abs(want).max())


# ---- the communicator and the mesh ------------------------------------------
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_local_comm_collectives(s):
    comm = pcomm.LocalComm(s)
    xs = [torch.full((2, 3), float(i)) for i in range(s)]
    gathered = comm.all_gather(xs)
    assert all(g is gathered[0] for g in gathered)
    assert torch.equal(gathered[0], torch.cat(xs))
    assert comm.all_gather(xs, tiled=False)[0].shape == (s, 2, 3)
    assert float(comm.all_reduce(xs)[0][0, 0]) == sum(range(s))
    # member i receives member (i + 1) % s's tensor (JAX's i -> i - 1)
    shifted = comm.ring_shift(xs)
    assert [float(x[0, 0]) for x in shifted] == \
        [float((i + 1) % s) for i in range(s)]


def test_mesh_shapes():
    mesh = pm.make_mesh((4, 2), comm="local", device="cpu")
    assert mesh.axis_names == ("rows", "cols")
    assert mesh.shape == {"rows": 4, "cols": 2}
    assert mesh.axis("rows").size == 4 and mesh.axis("cols").size == 2
    assert mesh.holds_all
    assert pm.row_mesh(device="cpu").shape == {"rows": 1}
    assert pm._lines((2, 3), 0) == [[0, 3], [1, 4], [2, 5]]
    assert pm._lines((2, 3), 1) == [[0, 1, 2], [3, 4, 5]]


def test_row_mesh_without_a_card_raises():
    from basic_sparse_matrix_tpu_torch.utils.config import (
        NoDefaultDevice, use_device)

    if torch.cuda.is_available():
        pytest.skip("a card is present: row_mesh() builds there")
    with use_device("cuda"):
        with pytest.raises(NoDefaultDevice):
            pm.row_mesh()


# ---- shard_csr --------------------------------------------------------------
@pytest.mark.parametrize("rows,cols,s", [
    (100, 64, 1), (100, 64, 2), (100, 64, 4), (100, 64, 8),
    (96, 50, 8),   # rows % s == 0
    (6, 6, 8),     # rows < s: empty trailing shards
])
def test_shard_csr_arrays_equal_jax(rows, cols, s):
    d = _dense(np.random.default_rng(0), rows, cols)
    ja = jsh.shard_csr(J.CSR.from_dense(d), s)
    pa = psh.shard_csr(P.CSR.from_dense(d), s)
    assert (pa.rows, pa.cols, pa.rows_per_shard, pa.num_shards) == \
        (ja.rows, ja.cols, ja.rows_per_shard, ja.num_shards)
    assert pa.padded_rows == ja.padded_rows
    for j, p in ((ja.indptr, pa.indptr), (ja.indices, pa.indices)):
        np.testing.assert_array_equal(p.numpy().astype(np.int64),
                                      np.asarray(j).astype(np.int64))
    np.testing.assert_array_equal(pa.values.numpy(),
                                  np.asarray(ja.values, np.float32))


@pytest.mark.parametrize("s", SHARDS)
def test_shard_local_blocks(s):
    """Each held shard's CSR (padding left out) is its row block."""
    d = _dense(np.random.default_rng(0), 100, 64)
    sa = psh.put_sharded(psh.shard_csr(P.CSR.from_dense(d), s),
                         pm.row_mesh(s, device="cpu"))
    rps = sa.rows_per_shard
    for sh in range(s):
        block = np.zeros((rps, 64), dtype=np.float32)
        r0, r1 = sh * rps, min((sh + 1) * rps, 100)
        if r0 < 100:
            block[: r1 - r0] = d[r0:r1]
        np.testing.assert_array_equal(sa.local(sh).todense().numpy(), block)
        # the entry padding is left out, also where every row is live
        assert sa.local(sh).stored == np.count_nonzero(block)
        kps = -(-64 // s)
        for o in range(s):
            want = np.zeros((rps, kps), dtype=np.float32)
            part = block[:, o * kps: (o + 1) * kps]
            want[:, : part.shape[1]] = part
            np.testing.assert_array_equal(
                sa.col_block(sh, o, kps).todense().numpy(), want)
    assert psh.unshard_rows(torch.zeros(sa.padded_rows, 2), 100).shape == \
        (100, 2)


# ---- products ---------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_spmv_sharded_matches_jax(s):
    rng = np.random.default_rng(1)
    d = _dense(rng, 96, 50)
    x = rng.standard_normal(50).astype(np.float32)
    jmesh, pmesh = _meshes(s)
    jsa, psa = _both_sharded(d, s, jmesh, pmesh)
    _close(psp.spmv_sharded(psa, x, pmesh),
           jsp.spmv_sharded(jsa, jnp.asarray(x), jmesh))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("strategy,seed,shape", [
    ("spmm_sharded", 2, (64, 40, 7)),
    ("spmm_allgather", 3, (64, 100, 5)),   # K = 100 pads to a multiple of s
    ("spmm_ring", 4, (72, 90, 6)),
])
def test_spmm_strategies_match_jax(s, strategy, seed, shape):
    rng = np.random.default_rng(seed)
    rows, cols, n = shape
    d = _dense(rng, rows, cols)
    b = rng.standard_normal((cols, n)).astype(np.float32)
    jmesh, pmesh = _meshes(s)
    jsa, psa = _both_sharded(d, s, jmesh, pmesh)
    want = getattr(jsp, strategy)(jsa, jnp.asarray(b), jmesh)
    got = getattr(psp, strategy)(psa, b, pmesh)
    _close(got, want)
    _close(psh.unshard_rows(got, rows), d @ b, rtol=1e-4, atol_of_max=1e-5)


@pytest.mark.parametrize("s", SHARDS)
def test_spmm_ring_skewed_columns(s):
    """Every entry in the last panel's columns: one owner per ring step
    carries all the work, the others multiply empty blocks."""
    rng = np.random.default_rng(12)
    d = np.zeros((40, 64), dtype=np.float32)
    d[:, 56:] = _dense(rng, 40, 8, 0.5)
    b = rng.standard_normal((64, 3)).astype(np.float32)
    jmesh, pmesh = _meshes(s)
    jsa, psa = _both_sharded(d, s, jmesh, pmesh)
    _close(psp.spmm_ring(psa, b, pmesh),
           jsp.spmm_ring(jsa, jnp.asarray(b), jmesh))


@pytest.mark.parametrize("s", SHARDS)
def test_spmm_sharded_ell_matches_jax(s):
    rng = np.random.default_rng(9)
    d = _dense(rng, 100, 64)
    b = rng.standard_normal((64, 5)).astype(np.float32)
    jmesh, pmesh = _meshes(s)
    want = jsp.spmm_sharded_ell(jell.csr_to_ell(J.CSR.from_dense(d)),
                                jnp.asarray(b), jmesh)
    got = psp.spmm_sharded_ell(pell.csr_to_ell(P.CSR.from_dense(d)), b,
                               pmesh)
    _close(got, want)


@pytest.mark.parametrize("shape,n", [((4, 2), 7), ((2, 2), 6), ((2, 2), 5)])
def test_spmm_ring_2d_matches_jax(shape, n):
    rng = np.random.default_rng(4)
    d = _dense(rng, 72, 90)
    b = rng.standard_normal((90, n)).astype(np.float32)
    jmesh = jm.make_mesh(shape)
    pmesh = pm.make_mesh(shape, comm="local", device="cpu")
    s = shape[0]
    jsa, psa = _both_sharded(d, s, jmesh, pmesh)
    got = psp2.spmm_ring_2d(psa, b, pmesh)
    _close(got, jsp2.spmm_ring_2d(jsa, jnp.asarray(b), jmesh))
    assert got.shape == (psa.padded_rows, n)


# ---- carried state ----------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
def test_jax_shards_fed_to_the_port(s):
    rng = np.random.default_rng(4)
    d = _dense(rng, 72, 90)
    b = rng.standard_normal((90, 6)).astype(np.float32)
    jmesh, pmesh = _meshes(s)
    jsa = jsh.put_sharded(jsh.shard_csr(J.CSR.from_dense(d), s), jmesh)
    psa = interop.sharded_csr_from_numpy(
        np.asarray(jsa.indptr), np.asarray(jsa.indices),
        np.asarray(jsa.values), jsa.rows, jsa.cols, jsa.rows_per_shard,
        pmesh)
    assert psa.nnz == psh.shard_csr(P.CSR.from_dense(d), s).nnz
    for strategy in ("spmm_sharded", "spmm_allgather", "spmm_ring"):
        _close(getattr(psp, strategy)(psa, b, pmesh),
               getattr(jsp, strategy)(jsa, jnp.asarray(b), jmesh))


# ---- the port stands alone --------------------------------------------------
def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    (REPO / "basic_sparse_matrix_tpu_torch" / "parallel").glob("*.py"))
    + [REPO / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "basic_sparse_matrix_tpu")]
    assert not bad, f"{path.name} imports {bad}"
