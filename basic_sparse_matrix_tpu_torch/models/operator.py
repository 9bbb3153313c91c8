"""Prepared linear operator — the serving-path wrapper.

Counterpart of ``basic_sparse_matrix_tpu/models/operator.py``. Production
use reuses one matrix across many multiplies and solves; a
:class:`SparseOperator` prepares each piece once (format conversions,
factorization and solve schedules, the PCG preconditioner, the Lanczos
set-up) and keeps it for the next call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..ops.csr import CSR
from ..ops.spmm import mul_dense, mul_vector
from ..runtime import profiling


@dataclasses.dataclass(eq=False)
class SparseOperator:
    """Wraps a CSR with memoised fast-path state.

    ``matmul``/``matvec`` reuse the dispatch caches on the CSR instance
    (``mul_dense``'s ladder, so the BSR and streaming kernels run where it
    picks them); ``solve`` builds and caches a :class:`DirectSolver`;
    ``solve_cg`` the IC(0)-PCG set-up, unless ``use_multigrid`` gave it
    HPCG's multigrid preconditioner first; ``solve_chebyshev``,
    ``eigen_values`` and ``condition_estimate`` share one Lanczos set-up.
    ``direct_solver`` and ``pcg_setup`` give the prepared solvers (None
    until built), and with them their set-up ``timings``.

    ``matmul``, ``solve`` and ``solve_cg`` are the requests the recorder
    (``runtime/profiling.py``) roots its spans at: ``bsm.matmul``,
    ``bsm.solve``, ``bsm.solve_cg``.
    """

    a: CSR
    _direct: Optional[object] = None
    _pcg: Optional[object] = None
    _lanczos: Optional[object] = None

    # ------------------------------------------------------------------ #
    @property
    def direct_solver(self):
        """The :class:`DirectSolver` that ``solve`` built, or None."""
        return self._direct

    @property
    def pcg_setup(self):
        """The set-up ``solve_cg`` runs: the IC(0) ``PCGSetup`` it built,
        the ``MultigridSetup`` of :meth:`use_multigrid`, or None."""
        return self._pcg

    def use_multigrid(self, coarse: Sequence[CSR],
                      f2c: Sequence[torch.Tensor]):
        """Build HPCG's multigrid preconditioner now
        (``models/multigrid.MultigridSetup``) over this operator and the
        coarser operators ``coarse``, ``f2c[ℓ]`` giving each row of level
        ℓ+1 its row of level ℓ (``multigrid.injection_map``), and make
        ``solve_cg`` use it in place of IC(0). Returns the set-up."""
        from .multigrid import MultigridSetup

        self._pcg = MultigridSetup.build([self.a, *coarse], f2c)
        return self._pcg

    # ------------------------------------------------------------------ #
    def matmul(self, b) -> torch.Tensor:
        with profiling.span("bsm.matmul"):
            return mul_dense(self.a, b)

    def matvec(self, x) -> torch.Tensor:
        return mul_vector(self.a, x)

    def matmul_sparse(self, other: CSR) -> CSR:
        """Sparse × sparse product (``spgemm``'s dispatch; the planned path
        memoises its symbolic plan on the operand)."""
        from ..ops.spgemm import spgemm

        return spgemm(self.a, other)

    __matmul__ = matmul

    # ------------------------------------------------------------------ #
    def _ensure_direct(self):
        if self._direct is None:
            from .solve import prepare_direct

            self._direct = prepare_direct(self.a)
        return self._direct

    def solve(self, b) -> torch.Tensor:
        """Direct SPD solve; ordering, factorization (banded / BCR /
        supernodal / scatter-list, the :class:`DirectSolver` ladder) and
        solve schedules are computed once and reused for every later
        right-hand side."""
        with profiling.span("bsm.solve"):
            return self._ensure_direct().solve(b)

    def solve_cg(self, b, tol: float = 1e-6, max_iters: int = 1000):
        """Preconditioned CG: IC(0), built once at the first call, or the
        multigrid set-up of :meth:`use_multigrid`. Returns (x, iterations,
        final relative residual)."""
        from .pcg import PCGSetup, pcg_solve

        with profiling.span("bsm.solve_cg"):
            if self._pcg is None:
                self._pcg = PCGSetup.build(self.a)
            return pcg_solve(self.a, b, tol=tol, max_iters=max_iters,
                             setup=self._pcg)

    def solve_chebyshev(self, b, iters: int = 100):
        """Chebyshev semi-iteration (SPD; no inner products in the loop),
        bounds from the shared Lanczos set-up. Returns (x, final relative
        residual)."""
        from .chebyshev import chebyshev_solve

        return chebyshev_solve(self.a, b, iters=iters,
                               setup=self._ensure_lanczos())

    # ------------------------------------------------------------------ #
    def _ensure_lanczos(self):
        if self._lanczos is None:
            from .lanczos import LanczosSetup

            self._lanczos = LanczosSetup.build(self.a)
        return self._lanczos

    def eigen_values(self, k: int = 32) -> torch.Tensor:
        """k Ritz values (ascending; symmetric operand) by Lanczos, without
        densifying."""
        from .lanczos import eigen_values_lanczos

        return eigen_values_lanczos(self.a, k, setup=self._ensure_lanczos())

    def condition_estimate(self, k: int = 32) -> float:
        """2-norm condition estimate (SPD operand)."""
        from .lanczos import condition_estimate

        return condition_estimate(self.a, k, setup=self._ensure_lanczos())
