"""Linear-system solver: Cholesky → forward → backward substitution.

Counterpart of ``basic_sparse_matrix_tpu/models/solve.py`` and of the
reference's ``solve`` (``A = L·Lᵀ``; ``L y = b``; ``Lᵀ x = y``), with the
right-hand-side columns batched. :func:`solve` densifies; the
:class:`DirectSolver` behind :func:`solve_sparse` orders, factors on the
supernodal tier and solves with the level-scheduled sparse triangular
solves, all on the matrix's device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.csr import CSR
from ..ops.dense import Dense
from ..utils.config import get_config, matmul_precision
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check
from .triangular import _as_array


def solve_dense(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve on dense operands in float32. A matrix that is not
    positive definite gives NaN, as ``jnp.linalg.cholesky`` does."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    with matmul_precision():
        l, info = torch.linalg.cholesky_ex(a)
        if int(info) != 0:
            l = torch.full_like(l, float("nan"))
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
    construction; :meth:`solve` then runs only device work.

    The tier ladder is the JAX package's: the banded block-tridiagonal
    tier when the (reordered) bandwidth fits a small block, the supernodal
    tier when the pattern amalgamates into panels of average width >= 2,
    the scalar scatter-list tier otherwise. Only the supernodal tier is
    ported; where the ladder picks another tier the solver raises
    ``NotImplementedError`` (it does not quietly take another tier).

    ``timings`` holds the host-clock seconds of each set-up phase:
    ``order`` (ordering and permutation), ``analyze`` (tier tests and the
    supernodal schedule), ``numeric`` (the factorization, synchronised with
    the device), ``assemble`` (the factor's CSR) and ``schedules`` (the two
    triangular-solve schedules)."""

    def __init__(self, a: CSR, *, reorder: bool = True):
        from ..ops.reorder import (
            best_permutation,
            nd_permutation,
            permute_symmetric,
            rcm_permutation,
        )
        from . import banded as _bd
        from . import supernodal as _sn
        from .sparse_triangular import build_schedule

        check(a.rows == a.cols, NonSquareMatrix,
              f"sparse direct solve requires square A, got {a.dims}")
        cfg = get_config()
        self.n = a.rows
        self.device = a.device
        self.perm = None
        self.timings = {}
        clock = _Clock(a.device, self.timings)
        if reorder:
            if cfg.ordering == "auto":
                self.perm, _ = best_permutation(a)
            elif cfg.ordering == "rcm":
                self.perm = rcm_permutation(a)
            elif cfg.ordering == "nd":
                self.perm = nd_permutation(a)
            if self.perm is not None:
                a = permute_symmetric(a, self.perm)
        clock.lap("order")
        nb = _bd.banded_block_choice(a)
        if nb is not None:
            raise NotImplementedError(
                f"DirectSolver: the banded tier (block {nb}, banded_solver="
                f"{cfg.banded_solver!r}) is not ported yet (ROADMAP.md queue "
                f"1 item 4); set banded_max_block=0 for the supernodal tier")
        width, _ = _sn.supernode_stats(a, relax=cfg.supernodal_relax)
        if width < 2.0:
            raise NotImplementedError(
                f"DirectSolver: average panel width {width:.2f} < 2 selects "
                f"the scatter-list tier (models/sparse_cholesky.py), which is "
                f"not ported yet (ROADMAP.md queue 1 item 5)")
        self.sched = _sn.analyze_supernodal(a, relax=cfg.supernodal_relax)
        clock.lap("analyze")
        lvals = _sn.factorize_supernodal(self.sched, a.values)
        clock.lap("numeric")
        self._l = _sn.assemble_factor(a, lvals, self.sched)
        self.kind = "supernodal"
        clock.lap("assemble")
        self._fwd = build_schedule(self._l, lower=True)
        self._bwd = build_schedule(self._l.transpose(), lower=False)
        clock.lap("schedules")

    def solve(self, b) -> torch.Tensor:
        """Solve ``A x = b`` from the prepared factorization; ``b`` may be a
        Dense wrapper, a vector or an (n, k) array. 1-D input returns
        1-D."""
        from ..ops.reorder import apply_perm
        from .sparse_triangular import solve_triangular_sparse

        squeeze = not isinstance(b, Dense) and (
            b.ndim if isinstance(b, torch.Tensor) else np.ndim(b)) == 1
        rhs = _as_array(b, self.device)
        check(rhs.shape[0] == self.n, IncorrectDimensions,
              f"solve: A n={self.n} vs b {tuple(rhs.shape)}")
        if self.perm is not None:
            rhs = apply_perm(rhs, self.perm)
        y = solve_triangular_sparse(self._l, rhs, self._fwd)
        x = solve_triangular_sparse(self._l, y, self._bwd, lower=False)
        if self.perm is not None:
            x = apply_perm(x, self.perm, inverse=True)
        return x[:, 0] if squeeze else x


class _Clock:
    """Host-clock laps into ``out``, each ended by a device synchronise
    (on a CUDA device) so that a lap holds the device work it queued."""

    def __init__(self, device: torch.device, out: dict):
        self.device, self.out, self.t0 = device, out, time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = now - self.t0
        self.t0 = now


def prepare_direct(a: CSR, *, reorder: bool = True) -> DirectSolver:
    """Build a reusable :class:`DirectSolver` (ordering + factorization +
    solve schedules, all one-time) for repeated right-hand sides."""
    return DirectSolver(a, reorder=reorder)


def solve_sparse(a: CSR, b, *, reorder: bool = True) -> torch.Tensor:
    """Fully sparse solve: fill-reducing preordering (config ``ordering``;
    the returned x is for the original system) → supernodal Cholesky →
    level-scheduled forward/backward substitution. The scalable counterpart
    of :func:`solve` for matrices where densifying is wasteful."""
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
