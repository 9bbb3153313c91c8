"""One rank of the gloo runs of ``tests/test_torch_parallel_dist.py``: joins
the process group through a file, runs the port's distributed functions on
a ``TorchDistComm`` mesh at small seeded sizes on the CPU, and saves what
this rank holds to ``<out_dir>/rank<r>.npz``. Imports no JAX."""

import datetime
import os

import numpy as np


def inputs():
    """The seeded operands every rank and the parent build alike."""
    rng = np.random.default_rng(4)
    d = ((rng.random((72, 90)) < 0.1)
         * rng.standard_normal((72, 90))).astype(np.float32)
    b = rng.standard_normal((90, 6)).astype(np.float32)
    m = rng.standard_normal((64, 64)).astype(np.float32)
    spd = (m @ m.T + 64 * np.eye(64, dtype=np.float32)).astype(np.float32)
    rhs = rng.standard_normal(64).astype(np.float32)
    tall = rng.standard_normal((640, 24)).astype(np.float32)
    return d, b, spd, rhs, tall


def results(mesh, mesh2d=None):
    """What ``mesh`` (and the 2 × 2 ``mesh2d``) hold of each function's
    result, by name."""
    import basic_sparse_matrix_tpu_torch as P
    from basic_sparse_matrix_tpu_torch.parallel import cg, sharded, spmm
    from basic_sparse_matrix_tpu_torch.parallel import spmm2d, tsqr

    d, b, spd, rhs, tall = inputs()
    s = mesh.shape["rows"]
    sa = sharded.put_sharded(sharded.shard_csr(P.CSR.from_dense(d), s), mesh)
    sspd = sharded.put_sharded(sharded.shard_csr(P.CSR.from_dense(spd), s),
                               mesh)
    q, r = tsqr.tsqr_sharded(tall, mesh)
    out = {"spmm_ring": spmm.spmm_ring(sa, b, mesh),
           "spmm_allgather": spmm.spmm_allgather(sa, b, mesh),
           "cg": cg.cg_solve_sharded(sspd, rhs, mesh, iters=30),
           "tsqr_q": q, "tsqr_r": r}
    if mesh2d is not None:
        sa2 = sharded.put_sharded(
            sharded.shard_csr(P.CSR.from_dense(d), mesh2d.shape["rows"]),
            mesh2d)
        out["spmm_ring_2d"] = spmm2d.spmm_ring_2d(sa2, b[:, :5], mesh2d)
    return {k: v.numpy() for k, v in out.items()}


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from basic_sparse_matrix_tpu_torch.parallel.mesh import make_mesh, row_mesh
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with use_device("cpu"):
            mesh = row_mesh()
            mesh2d = make_mesh((2, 2), ("rows", "cols")) if world == 4 \
                else None
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                     **results(mesh, mesh2d))
    finally:
        dist.destroy_process_group()
