"""HPCG's multigrid preconditioner: a V-cycle smoothed by symmetric
Gauss–Seidel, for the PCG loop of ``models/pcg.py``.

The JAX package has no counterpart. The mathematics is that of the HPCG
reference code (Dongarra, Heroux, Luszczek, SAND2013-8752; HPCG 3.1's
``ComputeMG_ref``, ``ComputeSYMGS_ref``, ``ComputeRestriction_ref`` and
``ComputeProlongation_ref``):

* **Hierarchy.** Level 0 is A. Each coarser level is an operator the
  caller gives (HPCG regenerates its 27-point operator on the halved grid),
  with an injection map ``f2c``: coarse row i is fine row ``f2c[i]``
  (:func:`injection_map` gives HPCG's on an nx × ny × nz grid).
* **V-cycle** on level ℓ, with x = 0 on entry: ``PRE_STEPS`` SymGS on
  A_ℓ x = r; the residual restricted, rc = (r − A_ℓ x)[f2c]; the V-cycle of
  level ℓ+1 on rc; the correction prolonged, x[f2c] += xc; ``POST_STEPS``
  SymGS. The coarsest level is one SymGS.
* **SymGS** in natural (row) order: the forward sweep x ← (D+L)⁻¹(r − U x),
  then the backward sweep x ← (D+U)⁻¹(r − L x), L and U A's strict
  triangles. Each sweep is a level-scheduled triangular solve
  (``models/sparse_triangular``, K7 on the card, no graph of its own): rows of one level depend
  on no other row of it, so the levels give the sequential sweep exactly.
  U x is skipped where x is zero (a level's first sweep).

:class:`MultigridSetup` has :class:`~.pcg.PCGSetup`'s interface (``a``,
``matvec``, ``apply_m_inv``, ``timings``), so ``pcg_solve`` and
``SparseOperator.solve_cg`` (after ``use_multigrid``) run it through the
same loop: eager on the CPU, chunk graphs on the card. On the card a
V-cycle called on its own (PCG's start) replays one captured graph, owner
the set-up; inside a PCG chunk it is recorded into the chunk's graph.

The recorder (``runtime/profiling.py``) sees each V-cycle as the span
``bsm.mg.apply`` and counts ``mg.applies`` and ``mg.sweeps`` (one a
triangular sweep, two a SymGS); the set-up laps are ``mg.hierarchy`` (the
triangles of every level, the maps checked and placed), ``mg.schedules``
and ``mg.ell``, in ``timings``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.csr import CSR, to_tensor
from ..ops.ell import ELL
from ..runtime import graphs, profiling
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check
from .pcg import ell_view, spmv_with
from .sparse_triangular import TriangularSchedule, _solve, build_schedule


# HPCG's smoothing (MGData.hpp): one SymGS before the coarse-grid
# correction and one after.
PRE_STEPS = 1
POST_STEPS = 1


def injection_map(dims: Tuple[int, int, int], device=None) -> torch.Tensor:
    """HPCG's ``f2c`` from an (nx, ny, nz) grid (row x + nx·(y + ny·z),
    every dimension even) to the (nx/2, ny/2, nz/2) grid: coarse point
    (i, j, k) is fine point (2i, 2j, 2k). int64, on ``device``."""
    nx, ny, nz = (int(d) for d in dims)
    check(min(nx, ny, nz) > 0 and nx % 2 == ny % 2 == nz % 2 == 0,
          IncorrectDimensions, f"injection needs even dimensions, got "
          f"{(nx, ny, nz)}")
    z, y, x = np.meshgrid(np.arange(0, nz, 2), np.arange(0, ny, 2),
                          np.arange(0, nx, 2), indexing="ij")
    return to_tensor((x + nx * (y + ny * z)).ravel().astype(np.int64),
                     device)


@dataclasses.dataclass(eq=False)
class MGLevel:
    """One level of the hierarchy: its operator and ELL view, the schedules
    of D+L (``fwd``) and D+U (``bwd``), the strict triangles L and U with
    their ELL views (the sweeps' right-hand sides), and ``f2c`` to the next
    coarser level (None on the coarsest)."""

    a: CSR
    ell: Optional[ELL]
    fwd: TriangularSchedule
    bwd: TriangularSchedule
    lower: CSR
    lower_ell: Optional[ELL]
    upper: CSR
    upper_ell: Optional[ELL]
    f2c: Optional[torch.Tensor]


@dataclasses.dataclass(eq=False)
class MultigridSetup:
    """HPCG's V-cycle over ``levels`` (finest first) as a PCG
    preconditioner: :meth:`apply_m_inv` is one V-cycle from x = 0.
    ``timings`` holds the set-up laps (host clock, each synchronised with
    the device): ``hierarchy``, ``schedules``, ``ell``."""

    levels: List[MGLevel]
    timings: dict = dataclasses.field(default_factory=dict)
    # PCG iterations a chunk graph on the card (IC(0)'s is pcg.CHUNK, 4): a
    # masked step past a set's end costs a whole V-cycle, far more than a
    # chunk's flag read, and 2 divides HPCG's 50 (PERF.md, PR 18).
    chunk = 2

    @property
    def a(self) -> CSR:
        return self.levels[0].a

    @staticmethod
    def build(levels: Sequence[CSR],
              f2c: Sequence[torch.Tensor]) -> "MultigridSetup":
        """The set-up for the operators ``levels`` (level 0 the system's,
        each later one coarser) and the injections ``f2c``: ``f2c[ℓ]``
        gives, for each row of ``levels[ℓ + 1]``, its row of
        ``levels[ℓ]``. HPCG's hierarchy is its 27-point operator on grids
        halved in every dimension with :func:`injection_map` between
        them."""
        check(len(levels) >= 1 and len(f2c) == len(levels) - 1,
              IncorrectDimensions, f"multigrid: {len(levels)} levels need "
              f"{len(levels) - 1} maps, got {len(f2c)}")
        a0 = levels[0]
        clock = profiling.Laps("mg", a0.device)
        maps = []
        for k, a in enumerate(levels):
            check(a.rows == a.cols, NonSquareMatrix,
                  f"multigrid level {k} is {a.dims}")
            check(a.device == a0.device, IncorrectDimensions,
                  f"multigrid level {k} is on {a.device}, not {a0.device}")
            if k:
                maps.append(_checked_map(f2c[k - 1], levels[k - 1].rows,
                                         a.rows, k - 1, a0.device))
        parts = [(a.triangle(lower=True), a.triangle(lower=False),
                  a.triangle(lower=True, strict=True),
                  a.triangle(lower=False, strict=True)) for a in levels]
        clock.lap("hierarchy")
        scheds = [(build_schedule(dl, lower=True),
                   build_schedule(du, lower=False)) for dl, du, _, _ in parts]
        clock.lap("schedules")
        ells = [(ell_view(a), ell_view(lo), ell_view(up))
                for a, (_, _, lo, up) in zip(levels, parts)]
        clock.lap("ell")
        out = [MGLevel(a=a, ell=ea, fwd=fwd, bwd=bwd, lower=lo, lower_ell=el,
                       upper=up, upper_ell=eu,
                       f2c=maps[k] if k < len(maps) else None)
               for k, (a, (fwd, bwd), (_, _, lo, up), (ea, el, eu))
               in enumerate(zip(levels, scheds, parts, ells))]
        return MultigridSetup(levels=out, timings=clock.out)

    # ------------------------------------------------------------------ #
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        lv = self.levels[0]
        return spmv_with(lv.a, lv.ell, x)

    def apply_m_inv(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle from x = 0 on the residual ``r`` (n,): M⁻¹ r. On the
        card a replayed graph, or recorded into the graph being captured."""
        check(r.shape == (self.a.rows,), IncorrectDimensions,
              f"multigrid: r {tuple(r.shape)} for n={self.a.rows}")
        with profiling.span("bsm.mg.apply"):
            return graphs.run(self, "vcycle", self._cycle, r)

    def _cycle(self, r: torch.Tensor) -> torch.Tensor:
        profiling.count("mg.applies")
        return self._vcycle(0, r.to(torch.float32))

    def _vcycle(self, k: int, r: torch.Tensor) -> torch.Tensor:
        """``ComputeMG_ref`` on level ``k`` from x = 0."""
        lv = self.levels[k]
        if lv.f2c is None:
            return self._symgs(lv, r, None)
        x = None
        for _ in range(PRE_STEPS):
            x = self._symgs(lv, r, x)
        res = r if x is None else r - spmv_with(lv.a, lv.ell, x)
        xc = self._vcycle(k + 1, res.index_select(0, lv.f2c))
        x = self._prolong(lv, torch.zeros_like(r) if x is None else x, xc)
        for _ in range(POST_STEPS):
            x = self._symgs(lv, r, x)
        return x

    @staticmethod
    def _prolong(lv: MGLevel, x: torch.Tensor,
                 xc: torch.Tensor) -> torch.Tensor:
        """``ComputeProlongation_ref``: x[f2c] += xc."""
        return x.index_add(0, lv.f2c, xc)

    def _symgs(self, lv: MGLevel, r: torch.Tensor,
               x: Optional[torch.Tensor]) -> torch.Tensor:
        """``ComputeSYMGS_ref`` on A_ℓ x = r from ``x`` (None: zero)."""
        return self._backward(lv, r, self._forward(lv, r, x))

    @staticmethod
    def _forward(lv: MGLevel, r: torch.Tensor,
                 x: Optional[torch.Tensor]) -> torch.Tensor:
        profiling.count("mg.sweeps")
        b = r if x is None else r - spmv_with(lv.upper, lv.upper_ell, x)
        return _solve(lv.fwd, b)

    @staticmethod
    def _backward(lv: MGLevel, r: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
        profiling.count("mg.sweeps")
        return _solve(lv.bwd, r - spmv_with(lv.lower, lv.lower_ell, x))


def _checked_map(f2c, fine: int, coarse: int, k: int,
                 device) -> torch.Tensor:
    """``f2c`` as int64 on ``device``, checked: one distinct fine row in
    range for each coarse row."""
    m = f2c.detach().cpu().numpy() if isinstance(f2c, torch.Tensor) \
        else np.asarray(f2c)
    m = m.astype(np.int64).ravel()
    s = np.sort(m)
    check(m.shape == (coarse,) and (not s.size or (
        s[0] >= 0 and s[-1] < fine and bool(np.all(s[1:] != s[:-1])))),
        IncorrectDimensions, f"multigrid f2c[{k}] must give {coarse} "
        f"distinct rows of {fine}")
    return to_tensor(m, device)
