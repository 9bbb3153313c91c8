"""The distributed layer of the port: a row-partitioned CSR on a mesh and
what is served from it (counterpart of ``basic_sparse_matrix_tpu/parallel``).

* ``comm``, ``mesh``: the communicators (``LocalComm``: every rank in this
  process; ``TorchDistComm``: one rank per ``torch.distributed`` process)
  and the mesh that holds one per axis;
* ``sharded``: ``ShardedCSR``, ``shard_csr``, ``put_sharded``,
  ``unshard_rows``;
* ``spmm``, ``spmm2d``: the four SpMM strategies (replicated RHS,
  all-gather, ring, 2-D ring) and the ELL form;
* ``cg``, ``pcg``, ``lanczos``, ``chebyshev``, ``tsqr``: CG, block-Jacobi
  PCG, Lanczos, Chebyshev and TSQR on row-sharded operands;
* ``spgemm_sparse``: SpGEMM with the numeric phase split over the ranks;
* ``operator``: ``DistributedOperator``, the serving wrapper;
* ``cholesky``, ``triangular``, ``supernodal``: the distributed direct
  solve (scatter-list and supernodal Cholesky, level-split triangular
  solves), each level cut into contiguous rank ranges (``levels``);
* ``bcr``: block cyclic reduction with blocks row-sharded;
* ``multihost``: process bootstrap and per-process row blocks;
* ``dryrun``: ``dryrun_multichip``, the pipeline once on logical ranks.
"""

__all__ = ["bcr", "cg", "chebyshev", "cholesky", "comm", "dryrun", "lanczos",
           "levels", "mesh", "multihost", "operator", "pcg", "sharded",
           "spgemm_sparse", "spmm", "spmm2d", "supernodal", "triangular",
           "tsqr"]
