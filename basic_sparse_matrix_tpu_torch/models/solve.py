"""Linear-system solver: Cholesky → forward → backward substitution.

Counterpart of ``basic_sparse_matrix_tpu/models/solve.py`` and of the
reference's ``solve`` (``A = L·Lᵀ``; ``L y = b``; ``Lᵀ x = y``), with the
right-hand-side columns batched. :func:`solve` densifies; the
:class:`DirectSolver` behind :func:`solve_sparse` orders, factors on the
tier the JAX package's ladder picks (banded, BCR, supernodal or
scatter-list) and solves, all on the matrix's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.csr import CSR
from ..ops.dense import Dense
from ..runtime import profiling
from ..utils.config import get_config, matmul_precision
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check
from .triangular import _as_array


def solve_dense(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve on dense operands in float32. A matrix that is not
    positive definite gives NaN, as ``jnp.linalg.cholesky`` does."""
    from .cholesky import cholesky_dense

    b = b.to(torch.float32)
    with matmul_precision():
        l = cholesky_dense(a)
        y = torch.linalg.solve_triangular(l, b, upper=False)
        return torch.linalg.solve_triangular(l.mT, y, upper=True)


def solve(a: CSR, b) -> torch.Tensor:
    """Solve ``A x = b`` for SPD sparse ``A`` by densifying — the
    reference's ``solve``. ``b`` may be a Dense wrapper, a vector or an
    (n, k) array; returns an (n, k) tensor on ``a``'s device."""
    check(a.rows == a.cols, NonSquareMatrix,
          f"solve requires square A, got {a.dims}")
    rhs = _as_array(b, a.device)
    check(rhs.shape[0] == a.rows, IncorrectDimensions,
          f"solve: A {a.dims} vs b {tuple(rhs.shape)}")
    return solve_dense(a.todense(), rhs)


class DirectSolver:
    """Prepared sparse direct solver: fill-reducing ordering, numeric
    factorization and triangular-solve schedules built once at
    construction; :meth:`solve` then runs only device work. The
    serving-path analogue of scipy's ``factorized``, cached by
    ``SparseOperator`` and used one-shot by :func:`solve_sparse`.

    The tier ladder is the JAX package's, cheapest test first:

    1. ``"banded-bcr"`` (config ``banded_solver="bcr"``) or ``"banded"``
       (any other value: the block scan) when the (reordered) bandwidth
       fits a small block (``banded_block_choice``);
    2. ``"supernodal"`` when the pattern amalgamates into panels of
       average width >= 2;
    3. ``"scatter"``, the scalar scatter-list factorization, otherwise.

    ``timings`` holds the host-clock seconds of each set-up phase, each lap
    synchronised with the device: ``order`` (ordering and permutation) and
    ``analyze`` on every tier (the tier tests, plus the blocks (D, E) on a
    banded tier or the schedule on the others), ``numeric`` (the
    factorization), and on the supernodal and scatter tiers ``assemble``
    (the factor's CSR) and ``schedules`` (the two triangular-solve
    schedules). A banded tier has no ``assemble`` or ``schedules``. The
    laps are also the recorder's ``direct.<phase>``
    (``runtime/profiling.py::Laps``)."""

    def __init__(self, a: CSR, *, reorder: bool = True):
        from ..ops.csr import to_tensor
        from ..ops.reorder import (
            best_permutation,
            nd_permutation,
            permute_symmetric,
            rcm_permutation,
        )
        from . import banded as _bd
        from . import sparse_cholesky as _sc
        from . import supernodal as _sn
        from .bcr import bcr_from_blocks
        from .sparse_triangular import build_schedule

        check(a.rows == a.cols, NonSquareMatrix,
              f"sparse direct solve requires square A, got {a.dims}")
        cfg = get_config()
        self.n = a.rows
        self.device = a.device
        self._set_perm(None)
        self.timings = {}
        self._banded = None
        self._l = self._fwd = self._bwd = None
        clock = profiling.Laps("direct", a.device, self.timings)
        if reorder:
            if cfg.ordering == "auto":
                self._set_perm(best_permutation(a)[0])
            elif cfg.ordering == "rcm":
                self._set_perm(rcm_permutation(a))
            elif cfg.ordering == "nd":
                self._set_perm(nd_permutation(a))
            if self.perm is not None:
                a = permute_symmetric(a, self.perm)
        clock.lap("order")
        nb = _bd.banded_block_choice(a)
        if nb is not None:
            D, E = (to_tensor(x, a.device) for x in _bd.band_blocks(a, nb))
            clock.lap("analyze")
            if cfg.banded_solver == "bcr":
                self.kind = "banded-bcr"
                self._banded = bcr_from_blocks(D, E, a.rows)
            else:
                self.kind = "banded"
                self._banded = _bd.BandedFactor(
                    *_bd.cholesky_banded_blocks(D, E), n=a.rows)
            clock.lap("numeric")
            return
        width, _ = _sn.supernode_stats(a, relax=cfg.supernodal_relax)
        if width >= 2.0:
            self.kind = "supernodal"
            self.sched = _sn.analyze_supernodal(a, relax=cfg.supernodal_relax)
            clock.lap("analyze")
            lvals = _sn.factorize_supernodal(self.sched, a.values)
            clock.lap("numeric")
            self._l = _sn.assemble_factor(a, lvals, self.sched)
        else:
            self.kind = "scatter"
            self.sched = _sc.analyze(a)
            clock.lap("analyze")
            lvals = _sc.factorize(self.sched, a.values)
            clock.lap("numeric")
            self._l = _sc.csc_to_csr_l(self.sched, lvals)
        clock.lap("assemble")
        self._fwd = build_schedule(self._l, lower=True)
        self._bwd = build_schedule(self._l.transpose(), lower=False)
        clock.lap("schedules")

    def _set_perm(self, perm) -> None:
        """Keep the fill-reducing permutation (host, ``perm``) and the
        gathers into and out of permuted space as int64 tensors on the
        solver's device, built once: a solve then uploads and inverts
        nothing."""
        self.perm = perm
        self._gathers = None
        if perm is not None:
            perm = np.asarray(perm, dtype=np.int64)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.shape[0])
            self._gathers = tuple(torch.as_tensor(p, device=self.device)
                                  for p in (perm, inv))

    def solve(self, b) -> torch.Tensor:
        """Solve ``A x = b`` from the prepared factorization; ``b`` may be a
        Dense wrapper, a vector or an (n, k) array. 1-D input returns
        1-D. The permutations are gathers with the solver's device
        tensors."""
        from ..ops.reorder import apply_perm
        from . import banded as _bd
        from .sparse_triangular import solve_triangular_sparse

        squeeze = not isinstance(b, Dense) and (
            b.ndim if isinstance(b, torch.Tensor) else np.ndim(b)) == 1
        rhs = _as_array(b, self.device)
        check(rhs.shape[0] == self.n, IncorrectDimensions,
              f"solve: A n={self.n} vs b {tuple(rhs.shape)}")
        with profiling.span("bsm.direct.solve"):
            if self._gathers is not None:
                rhs = apply_perm(rhs, self._gathers[0])
            if self.kind == "banded-bcr":
                x = self._banded.solve(rhs)
            elif self.kind == "banded":
                x = _bd.solve_factored_banded(self._banded, rhs)
            else:
                y = solve_triangular_sparse(self._l, rhs, self._fwd)
                x = solve_triangular_sparse(self._l, y, self._bwd,
                                            lower=False)
            if self._gathers is not None:
                x = apply_perm(x, self._gathers[1])
        return x[:, 0] if squeeze else x


def prepare_direct(a: CSR, *, reorder: bool = True) -> DirectSolver:
    """Build a reusable :class:`DirectSolver` (ordering + factorization +
    solve schedules, all one-time) for repeated right-hand sides."""
    return DirectSolver(a, reorder=reorder)


def solve_sparse(a: CSR, b, *, reorder: bool = True) -> torch.Tensor:
    """Fully sparse solve: fill-reducing preordering (config ``ordering``;
    the returned x is for the original system) → banded / supernodal /
    scatter-list Cholesky → block or level-scheduled forward/backward
    substitution. The scalable counterpart of :func:`solve` for matrices
    where densifying is wasteful."""
    return DirectSolver(a, reorder=reorder).solve(_as_array(b, a.device))


def solve_auto(a: CSR, b) -> torch.Tensor:
    """The dense pipeline for small or dense-ish ``A``, the sparse one
    otherwise (config ``dense_cholesky_max_n`` and
    ``dense_cholesky_min_density``)."""
    cfg = get_config()
    if (a.rows <= cfg.dense_cholesky_max_n
            or a.get_density() > cfg.dense_cholesky_min_density):
        return solve(a, b)
    return solve_sparse(a, b)
