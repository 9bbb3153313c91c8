"""The distributed direct solvers, BCR and the multi-host bootstrap over
gloo: ``TorchDistComm`` gives ``LocalComm``'s results bit for bit.

World sizes 2 and 4, one process per rank (the spawn helper of
``tests/test_torch_parallel_dist.py``; ranks meet through
``parallel.multihost.initialize`` at ``file://<tmp_path>/...``). Each rank
runs, from ``tests/torch_multihost_worker.py``, ``factorize_sharded``,
``solve_triangular_sharded`` (forward, and backward through
``solve_sparse_distributed(lower=False)``), ``factorize_supernodal_sharded``
and ``bcr_solve_sharded`` (whose boundary blocks cross processes through
``TorchDistComm.shift``) on a row mesh over the world; its replicated
results and its blocks of the BCR solution must equal the ``LocalComm``
results exactly. The two-process SpMM has each process build only its own
row block through ``build_global_sharded_csr`` and checks its rows of
``spmm_sharded`` against the dense product (``rtol=1e-4``, ``atol=1e-4``,
the JAX test's limits). No JAX is involved.
"""

import numpy as np
import pytest
import torch

import torch_multihost_worker as worker
from test_torch_parallel_dist import _spawn

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_direct_solvers_equal_local_comm(world, tmp_path):
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    ranks = _spawn(world, tmp_path, worker.run, ("direct",))
    local = worker.direct_results(row_mesh(world, comm="local",
                                           device="cpu"))
    for r, got in enumerate(ranks):
        for name in ("factorize_sharded", "solve_forward", "solve_backward",
                     "factorize_supernodal_sharded"):
            np.testing.assert_array_equal(got[name], local[name],
                                          err_msg=f"{name}, rank {r}")
        blk = got["bcr_solve_sharded"]
        np.testing.assert_array_equal(
            blk, local["bcr_solve_sharded"][r * blk.shape[0]:
                                            (r + 1) * blk.shape[0]],
            err_msg=f"bcr_solve_sharded, rank {r}")


def test_two_process_spmm(tmp_path):
    ranks = _spawn(2, tmp_path, worker.run, ("spmm",))
    dense, b = worker.spmm_inputs()
    expect = dense.astype(np.float64) @ b
    rows = dense.shape[0]
    for r, got in enumerate(ranks):
        r0, r1 = int(got["row_start"]), int(got["row_end"])
        assert (r0, r1) == (r * rows // 2, (r + 1) * rows // 2)
        # the process holds exactly its own shard, padded to the agreement
        assert list(got["shards"]) == [r] and int(got["held"]) == 1
        assert int(got["nnz"][0]) == int(np.count_nonzero(dense[r0:r1]))
        assert int(got["nnz_max"]) == max(
            int(np.count_nonzero(dense[p * rows // 2:(p + 1) * rows // 2]))
            for p in range(2))
        assert "nnz_max_per_device" in str(got["missing_error"])
        assert int(got["hosts"]) == 2
        np.testing.assert_allclose(got["y"], expect[r0:r1], rtol=1e-4,
                                   atol=1e-4)
