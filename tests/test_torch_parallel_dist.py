"""``TorchDistComm`` over gloo gives ``LocalComm``'s results bit for bit.

World sizes 2 and 4, one process per rank, started from
``multiprocessing.get_context("spawn")`` and joined with a timeout (a hung
rank is killed and the test fails); every collective has the process
group's 60 s timeout. The ranks meet through ``file://<tmp_path>/...``, so
tests on several xdist workers cannot collide on a port. Each rank runs
``spmm_ring``, ``spmm_allgather``, ``cg_solve_sharded`` and
``tsqr_sharded`` on a row mesh over the world (and, at 4, ``spmm_ring_2d``
on a 2 × 2 mesh, whose ring runs in the rows subgroup of the rank's
column) from ``tests/torch_parallel_worker.py``; what each rank holds must
equal the same rows of the ``LocalComm`` result exactly. No JAX is
involved.
"""

import multiprocessing

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker

torch.set_num_threads(1)

JOIN_SECONDS = 180


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _spawn(world, tmp_path, target=worker.run, extra=()):
    """Run ``target(rank, world, init_file, out_dir, *extra)`` in ``world``
    spawned processes; each rank's saved ``rank<r>.npz``, in rank order."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, str(tmp_path / "pg_init"),
                               str(tmp_path), *extra))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_SECONDS)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} of {world} ranks did not finish"
    assert all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_equal_local_comm(world, tmp_path):
    from basic_sparse_matrix_tpu_torch.parallel.mesh import make_mesh, row_mesh

    ranks = _spawn(world, tmp_path)
    local = worker.results(
        row_mesh(world, comm="local", device="cpu"),
        make_mesh((2, 2), ("rows", "cols"), comm="local", device="cpu")
        if world == 4 else None)
    for r, got in enumerate(ranks):
        for name in ("spmm_ring", "spmm_allgather", "tsqr_q"):
            rows = got[name].shape[0]
            np.testing.assert_array_equal(
                got[name], local[name][r * rows: (r + 1) * rows],
                err_msg=f"{name}, rank {r}")
        for name in ("cg", "tsqr_r"):
            np.testing.assert_array_equal(got[name], local[name],
                                          err_msg=f"{name}, rank {r}")
        if world == 4:
            row, col = divmod(r, 2)
            blk = got["spmm_ring_2d"]
            width = -(-5 // 2)
            np.testing.assert_array_equal(
                blk, local["spmm_ring_2d"][
                    row * blk.shape[0]: (row + 1) * blk.shape[0],
                    col * width: col * width + blk.shape[1]],
                err_msg=f"spmm_ring_2d, rank {r}")
            assert blk.shape[1] == (3 if col == 0 else 2)
