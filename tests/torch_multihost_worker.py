"""One rank of the gloo runs of ``tests/test_torch_parallel_direct_dist.py``:
joins the process group through ``parallel.multihost.initialize`` (a
``file://`` rendezvous), runs the port's distributed direct and BCR
functions, or the two-process row-block SpMM, on a ``TorchDistComm`` mesh
at small seeded sizes on the CPU, and saves what this rank holds to
``<out_dir>/rank<r>.npz``. Imports no JAX."""

import os

import numpy as np

BCR_NB = 8
SPMM_SHAPE = (96, 40)


def _laplacian_3d(k):
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        lo = np.take(idx, range(k - 1), axis=ax).ravel()
        hi = np.take(idx, range(1, k), axis=ax).ravel()
        r += [lo, hi]
        c += [hi, lo]
        v += [np.full(lo.size, -1.0)] * 2
    return (n, np.concatenate(r), np.concatenate(c),
            np.concatenate(v).astype(np.float32))


def _banded_spd(rng, n, bw):
    a = np.zeros((n, n), dtype=np.float32)
    for d in range(1, bw + 1):
        vals = rng.standard_normal(n - d).astype(np.float32) * 0.3
        a += np.diag(vals, k=d) + np.diag(vals, k=-d)
    return a + (2.0 * bw + 2.0) * np.eye(n, dtype=np.float32)


def direct_inputs():
    """The seeded operands every rank and the parent build alike: the 6³
    Laplacian under nested dissection (several supernodal groups and
    routes at ``relax=8``), two right-hand sides, and a banded SPD system
    of 16 blocks of 8 for BCR."""
    import basic_sparse_matrix_tpu_torch as P
    from basic_sparse_matrix_tpu_torch.models import banded
    from basic_sparse_matrix_tpu_torch.ops import reorder

    n, r, c, v = _laplacian_3d(6)
    a = P.CSR.from_coo_arrays((n, n), r, c, v, device="cpu")
    a = reorder.permute_symmetric(a, reorder.nd_permutation(a))
    rng = np.random.default_rng(11)
    b = rng.standard_normal((n, 2)).astype(np.float32)
    dense = _banded_spd(rng, 128, 3)
    D, E = banded.band_blocks(P.CSR.from_dense(dense, device="cpu"), BCR_NB)
    E = np.concatenate([E, np.zeros((1, BCR_NB, BCR_NB), np.float32)])
    bb = rng.standard_normal((D.shape[0], BCR_NB, 2)).astype(np.float32)
    return a, b, D, E, bb


def direct_results(mesh):
    """What ``mesh``'s process holds of each distributed direct and BCR
    function's result, by name: the replicated factors and solutions, and
    the process's blocks of the BCR solution."""
    import torch

    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.parallel import bcr, cholesky
    from basic_sparse_matrix_tpu_torch.parallel import supernodal, triangular

    a, b, D, E, bb = direct_inputs()
    comm = mesh.axis("rows")
    sched = sc.analyze(a)
    lvals = cholesky.factorize_sharded(sched, a.values, mesh)
    l = sc.csc_to_csr_l(sched, lvals)
    fwd = triangular.solve_triangular_sharded(st.build_schedule(l), b, mesh)
    bwd = triangular.solve_sparse_distributed(l.transpose(), fwd, mesh,
                                              lower=False)
    snl = supernodal.factorize_supernodal_sharded(
        sn.analyze_supernodal(a, relax=8), a.values, mesh)
    per = D.shape[0] // comm.size
    lo, hi = comm.local[0] * per, (comm.local[-1] + 1) * per
    xb = bcr.bcr_solve_sharded(torch.as_tensor(D[lo:hi]),
                               torch.as_tensor(E[lo:hi]),
                               torch.as_tensor(bb[lo:hi]), mesh)
    out = {"factorize_sharded": lvals, "solve_forward": fwd,
           "solve_backward": bwd, "factorize_supernodal_sharded": snl,
           "bcr_solve_sharded": xb}
    return {k: v.numpy() for k, v in out.items()}


def spmm_inputs():
    """The global matrix and RHS of the row-block SpMM (every process
    draws them alike: the dense oracle; a process builds its CSR from its
    own rows only)."""
    rows, cols = SPMM_SHAPE
    rng = np.random.default_rng(0)
    dense = ((rng.random((rows, cols)) < 0.25)
             * rng.standard_normal((rows, cols))).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((cols, 3)).astype(
        np.float32)
    return dense, b


def spmm_block(rank: int, world: int) -> dict:
    """This process's row block through ``build_global_sharded_csr``, its
    rows of ``spmm_sharded`` and what it holds."""
    import basic_sparse_matrix_tpu_torch as P
    from basic_sparse_matrix_tpu_torch.parallel import multihost, spmm

    dense, b = spmm_inputs()
    rows, cols = SPMM_SHAPE

    def builder(spec):
        return P.CSR.from_dense(dense[spec.row_start:spec.row_end])

    # a global agreement on the padded entry count (each process derives
    # the same bound from the shared generator)
    nnz_max = max(builder(multihost.local_row_block(
        rows, cols, process_id=p, process_count=world)).stored
        for p in range(world))
    mesh = multihost.global_row_mesh()
    spec = multihost.local_row_block(rows, cols)
    missing = ""
    try:
        multihost.build_global_sharded_csr(spec, builder, mesh)
    except ValueError as err:
        missing = str(err)
    sa = multihost.build_global_sharded_csr(spec, builder, mesh,
                                            nnz_max_per_device=nnz_max)
    y = spmm.spmm_sharded(sa, b, mesh)
    rec = multihost.weak_scaling_report(1.0, int(sa.indices.shape[1]), 1.0)
    return {"y": y.numpy(), "row_start": spec.row_start,
            "row_end": spec.row_end, "shards": np.asarray(sa.shards),
            "nnz": np.asarray(sa.nnz), "held": int(sa.indices.shape[0]),
            "nnz_max": int(sa.indices.shape[1]), "hosts": rec["hosts"],
            "missing_error": missing}


def run(rank: int, world: int, init_file: str, out_dir: str,
        what: str) -> None:
    import torch
    import torch.distributed as dist

    from basic_sparse_matrix_tpu_torch.parallel import multihost
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    torch.set_num_threads(1)
    with use_device("cpu"):
        multihost.initialize(f"file://{init_file}", num_processes=world,
                             process_id=rank)
        multihost.initialize()          # a second call leaves the group
        try:
            assert dist.get_backend() == "gloo", dist.get_backend()
            if what == "direct":
                out = direct_results(row_mesh())
            else:
                out = spmm_block(rank, world)
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        finally:
            dist.destroy_process_group()
