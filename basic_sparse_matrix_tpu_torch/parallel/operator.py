"""DistributedOperator: the mesh-resident serving wrapper.

Counterpart of ``basic_sparse_matrix_tpu/parallel/operator.py`` and the
mesh form of ``models/operator.py::SparseOperator``: shard once, then serve
products, solves and spectral queries from the resident shards and from
what is prepared lazily on them (the block-Jacobi factors, the Chebyshev
bounds, the SpGEMM plans per right operand, the per-shard host plans of
the local products). Results have the matrix's ``rows`` rows, the
partition's padding trimmed as in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops.csr import CSR
from ..ops.elementwise import cached_plan
from .mesh import ROWS, row_mesh
from .sharded import ShardedCSR, put_sharded, shard_csr, unshard_rows


class DistributedOperator:
    """Shard an SPD (for the solves) or general (for the products) CSR
    over a row mesh once (default: ``row_mesh()``); serve repeated calls
    from the resident shards."""

    def __init__(self, a: CSR, mesh=None):
        self.mesh = row_mesh() if mesh is None else mesh
        self.a = a
        self.rows, self.cols = a.rows, a.cols
        self.sa: ShardedCSR = put_sharded(
            shard_csr(a, self.mesh.shape[ROWS]), self.mesh)
        self._lfac = None          # block-Jacobi factors (lazy)
        self._bounds = None        # Chebyshev spectral bounds (lazy)
        self._spgemm_plans = []    # (weakref(rhs), plans), last 4 kept

    def _rows(self, y: torch.Tensor) -> torch.Tensor:
        return unshard_rows(y, self.rows, self.mesh)

    # -- products ---------------------------------------------------------
    def matvec(self, x) -> torch.Tensor:
        from .spmm import spmv_sharded

        return self._rows(spmv_sharded(self.sa, x, self.mesh))

    def matmul(self, b) -> torch.Tensor:
        from .spmm import spmm_sharded

        return self._rows(spmm_sharded(self.sa, b, self.mesh))

    def matmul_sparse(self, other: CSR) -> CSR:
        """Distributed SpGEMM against the resident row blocks; the
        per-block symbolic plans are memoised per right operand."""
        from .spgemm_sparse import plan_spgemm_sharded, spgemm_sharded

        plans = cached_plan(self._spgemm_plans, other,
                            lambda: plan_spgemm_sharded(
                                self.a, other, self.mesh.shape[ROWS]))
        return spgemm_sharded(self.a, other, self.mesh, plans=plans)

    # -- solves -----------------------------------------------------------
    def _ensure_block_jacobi(self) -> torch.Tensor:
        if self._lfac is None:
            from .pcg import build_block_jacobi

            self._lfac = build_block_jacobi(self.sa, self.mesh)
        return self._lfac

    def solve_cg(self, b, iters: int = 100) -> torch.Tensor:
        from .cg import cg_solve_sharded

        x = cg_solve_sharded(self.sa, b, self.mesh, iters=iters)
        return x[: self.rows]

    def solve_pcg(self, b, iters: int = 100) -> torch.Tensor:
        from .pcg import pcg_solve_sharded

        x = pcg_solve_sharded(self.sa, b, self.mesh, iters=iters,
                              lfac=self._ensure_block_jacobi())
        return x[: self.rows]

    def solve_chebyshev(self, b, iters: int = 100) -> torch.Tensor:
        from .chebyshev import chebyshev_solve_sharded

        if self._bounds is None:
            ritz = self.eigen_values(k=32)
            self._bounds = (0.95 * float(ritz[0]), 1.01 * float(ritz[-1]))
        x, _ = chebyshev_solve_sharded(self.sa, b, self.mesh, iters=iters,
                                       bounds=self._bounds, n=self.rows)
        return self._rows(x)

    # -- spectral ---------------------------------------------------------
    def eigen_values(self, k: int = 32) -> torch.Tensor:
        from .lanczos import eigen_values_lanczos_sharded

        return eigen_values_lanczos_sharded(self.sa, self.mesh, k,
                                            n=self.rows)
