"""The port's multi-host runtime (``parallel/multihost.py``) in one process,
against the JAX package on the CPU.

The four single-process tests of ``tests/test_multihost.py``, on the same
seeded data: the JAX functions on the simulated 8-device CPU mesh, the
port's without a process group (a world of 1) on ``LocalComm`` meshes.
Tolerances: ``spmm_sharded`` of the assembled operand against the dense
product ``rtol=1e-4``, ``atol=1e-4`` (the JAX test's), and against the JAX
result ``rtol=1e-5``, ``atol=1e-6·max|ref|``; row blocks, the padded shard
arrays and the report equal JAX's exactly. ``initialize`` is also checked
for the arguments it hands ``torch.distributed.init_process_group``
(recorded, no group is started). The two-process run is
``tests/test_torch_parallel_direct_dist.py::test_two_process_spmm``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.parallel import multihost as jmh
from basic_sparse_matrix_tpu.parallel import sharded as jsh
from basic_sparse_matrix_tpu.parallel import spmm as jspmm
from basic_sparse_matrix_tpu_torch.parallel import mesh as pm
from basic_sparse_matrix_tpu_torch.parallel import multihost as pmh
from basic_sparse_matrix_tpu_torch.parallel import sharded as psh
from basic_sparse_matrix_tpu_torch.parallel import spmm as pspmm

torch.set_num_threads(1)

ROWS, COLS = 96, 40


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _operands():
    rng = np.random.default_rng(0)
    dense = ((rng.random((ROWS, COLS)) < 0.2)
             * rng.standard_normal((ROWS, COLS))).astype(np.float32)
    b = rng.standard_normal((COLS, 3)).astype(np.float32)
    return dense, b


def test_initialize_noop_single_process(monkeypatch):
    import torch.distributed as dist

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    pmh.initialize()  # must be a no-op, not raise
    assert not dist.is_initialized()
    jmh.initialize()


@pytest.mark.parametrize("args,env,want", [
    (("localhost:1234", 2, 1), {},
     ("gloo", "tcp://localhost:1234", {"world_size": 2, "rank": 1})),
    (("file:///tmp/pg", 4, 3), {},
     ("gloo", "file:///tmp/pg", {"world_size": 4, "rank": 3})),
    ((), {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1"},
     ("gloo", "env://", {})),
    ((None, 2, 0), {}, ("gloo", "env://", {"world_size": 2, "rank": 0})),
    ((), {"RANK": "0"}, None),
])
def test_initialize_hands_the_process_group_its_rendezvous(
        monkeypatch, args, env, want):
    """A coordinator address becomes ``tcp://`` (a URL passes as it is);
    no arguments read ``env://`` only where RANK, WORLD_SIZE and
    MASTER_ADDR are all set; gloo where the default device is the CPU."""
    import torch.distributed as dist

    calls = []
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, init_method, **kw: calls.append(
                            (backend, init_method, kw)))
    pmh.initialize(*args)
    assert calls == ([want] if want else [])


def test_initialize_never_twice(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append(a))
    pmh.initialize("localhost:1234", 2, 0)
    assert calls == []


@pytest.mark.parametrize("rows,procs", [(100, 3), (96, 2), (7, 4), (5, 8)])
def test_local_row_block_partition(rows, procs):
    blocks = [pmh.local_row_block(rows, 60, process_id=i,
                                  process_count=procs)
              for i in range(procs)]
    for i, spec in enumerate(blocks):
        want = jmh.local_row_block(rows, 60, process_id=i,
                                   process_count=procs)
        assert (spec.row_start, spec.row_end, spec.global_rows,
                spec.global_cols) == (want.row_start, want.row_end,
                                      want.global_rows, want.global_cols)
    # all blocks cover [0, rows) without overlap
    covered = sorted((b.row_start, b.row_end) for b in blocks)
    assert covered[0][0] == 0 and covered[-1][1] == rows
    for (s1, e1), (s2, e2) in zip(covered, covered[1:]):
        assert e1 == s2
    if (rows, procs) == (100, 3):
        assert (blocks[1].row_start, blocks[1].row_end) == (34, 68)
    # this process, without a group: the whole matrix
    spec = pmh.local_row_block(rows, 60)
    assert (spec.row_start, spec.row_end) == (0, rows)


@pytest.mark.parametrize("s", [None, 1, 2, 4, 8])
def test_build_global_sharded_csr_single_host(s):
    dense, b = _operands()
    spec = pmh.local_row_block(ROWS, COLS)
    mesh = pmh.global_row_mesh() if s is None else \
        pm.row_mesh(s, comm="local", device="cpu")
    sa = pmh.build_global_sharded_csr(
        spec, lambda sp: P.CSR.from_dense(dense[sp.row_start:sp.row_end]),
        mesh)
    assert sa.shards == tuple(range(mesh.shape["rows"]))
    y = psh.unshard_rows(pspmm.spmm_sharded(sa, b, mesh), ROWS).numpy()
    assert np.allclose(y, dense @ b, rtol=1e-4, atol=1e-4)
    jmesh = jmh.global_row_mesh()
    jsa = jmh.build_global_sharded_csr(
        jmh.local_row_block(ROWS, COLS),
        lambda sp: J.CSR.from_dense(dense[sp.row_start:sp.row_end]), jmesh)
    want = np.asarray(jsh.unshard_rows(
        jspmm.spmm_sharded(jsa, jnp.asarray(b), jmesh), ROWS))
    np.testing.assert_allclose(y, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("nnz_max", [None, 120])
def test_global_shards_equal_jax_arrays(nnz_max):
    """At 8 local ranks the placed arrays are JAX's, entry for entry,
    including the padding to ``nnz_max_per_device``."""
    dense, _ = _operands()
    spec = pmh.local_row_block(ROWS, COLS)
    sa = pmh.build_global_sharded_csr(
        spec, lambda sp: P.CSR.from_dense(dense[sp.row_start:sp.row_end]),
        pm.row_mesh(8, comm="local", device="cpu"), nnz_max)
    jsa = jmh.build_global_sharded_csr(
        jmh.local_row_block(ROWS, COLS),
        lambda sp: J.CSR.from_dense(dense[sp.row_start:sp.row_end]),
        jmh.global_row_mesh(), nnz_max)
    for name in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(sa, name).numpy(),
                                      np.asarray(getattr(jsa, name)),
                                      err_msg=name)
    assert sa.rows_per_shard == jsa.rows_per_shard
    with pytest.raises(ValueError, match="below observed"):
        pmh.build_global_sharded_csr(
            spec, lambda sp: P.CSR.from_dense(dense), pm.row_mesh(
                8, comm="local", device="cpu"), 1)


def test_weak_scaling_report():
    rec = pmh.weak_scaling_report(seconds=2.0, nnz_per_host=1000,
                                  baseline_seconds_1host=1.8)
    assert rec["hosts"] == 1
    assert abs(rec["weak_scaling_efficiency"] - 0.9) < 1e-9
    assert rec == jmh.weak_scaling_report(seconds=2.0, nnz_per_host=1000,
                                          baseline_seconds_1host=1.8)
    assert pmh.weak_scaling_report(0.0, 10, 1.0)[
        "weak_scaling_efficiency"] == 0.0
