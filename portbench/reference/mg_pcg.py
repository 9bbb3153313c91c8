"""HPCG's multigrid-preconditioned CG on the grid: the reference of
``solve_cg`` after ``use_multigrid``.

The hierarchy is the configuration's: ``mg_levels`` grids, each the one
before halved in every dimension, with HPCG's 27-point operator applied as
the stencil on each (``stencil.apply``; HPCG regenerates the operator on
the coarse grid). Coarse point (i, j, k) is fine point (2i, 2j, 2k).

The V-cycle is HPCG 3.1's ``ComputeMG_ref`` from x = 0: ``pre`` SymGS, the
residual restricted by injection, the V-cycle one level down, the
correction prolonged by injection, ``post`` SymGS; one SymGS on the
coarsest level. SymGS is ``ComputeSYMGS_ref``, the forward then the
backward Gauss–Seidel sweep in natural order, run here by wavefronts
x + 2y + 4z: no two neighbours share a wavefront and each neighbour of
higher row number lies on a later one, so a wavefront at a time is the
sequential sweep. PCG is ``ic0_pcg.pcg``'s textbook loop with this
V-cycle as its preconditioner.
"""

from __future__ import annotations

import torch

from . import stencil
from .precision import Precision


def level_configs(config: dict) -> list:
    """The configuration of each level, finest first."""
    nx, ny, nz = stencil.dims(config)
    levels = int(config["mg_levels"])
    for d in (nx, ny, nz):
        if d % (1 << (levels - 1)):
            raise ValueError(f"a dimension {d} does not halve "
                             f"{levels - 1} times")
    return [dict(config, nx=nx >> k, ny=ny >> k, nz=nz >> k)
            for k in range(levels)]


def f2c(config: dict, device) -> torch.Tensor:
    """The fine row of each point of the next coarser grid."""
    nx, ny, _ = stencil.dims(config)
    cx, cy, cz = (d // 2 for d in stencil.dims(config))
    z, y, x = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(cz, device=device), torch.arange(cy, device=device),
        torch.arange(cx, device=device), indexing="ij"))
    return 2 * x + nx * (2 * y + ny * 2 * z)


class Wavefronts:
    """One grid's points in wavefront order, with each point's 26
    neighbours (clamped in range) and whether each is on the grid."""

    def __init__(self, config: dict, device, prec: Precision):
        nx, ny, nz = stencil.dims(config)
        n = nx * ny * nz
        self.config, self.prec = config, prec
        self.diag = prec.cast(torch.tensor(float(config["diagonal"]))).item()
        self.off = prec.cast(torch.tensor(float(config["off_diagonal"]))
                             ).item()
        z, y, x = (t.reshape(-1) for t in torch.meshgrid(
            torch.arange(nz, device=device), torch.arange(ny, device=device),
            torch.arange(nx, device=device), indexing="ij"))
        wave = x + 2 * y + 4 * z
        self.order = torch.argsort(wave, stable=True)
        self.ptr = [0] + torch.cumsum(torch.bincount(wave), 0).tolist()
        zo, yo, xo = z[self.order], y[self.order], x[self.order]
        nbr, valid = [], []
        for dz, dy, dx in stencil.NEIGHBOURS:
            nbr.append((xo + dx + nx * (yo + dy + ny * (zo + dz)))
                       .clamp(0, n - 1))
            valid.append((xo + dx >= 0) & (xo + dx < nx) & (yo + dy >= 0)
                         & (yo + dy < ny) & (zo + dz >= 0) & (zo + dz < nz))
        self.nbr = torch.stack(nbr)
        self.valid = torch.stack(valid).to(prec.dtype)

    def sweep(self, r: torch.Tensor, x: torch.Tensor,
              forward: bool) -> torch.Tensor:
        """One Gauss–Seidel sweep of A x = r (n, k) from ``x``; a new
        tensor."""
        x = x.clone()
        waves = range(len(self.ptr) - 1)
        for w in (waves if forward else reversed(waves)):
            s0, s1 = self.ptr[w], self.ptr[w + 1]
            pts = self.order[s0:s1]
            acc = (self.valid[:, s0:s1, None]
                   * self.prec.rnd(x[self.nbr[:, s0:s1]])).sum(0)
            x[pts] = (r[pts] - self.off * acc) / self.diag
        return x

    def symgs(self, r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.sweep(r, self.sweep(r, x, True), False)


class GridMG:
    """HPCG's V-cycle over the configuration's hierarchy, in ``prec``."""

    def __init__(self, config: dict, device, prec: Precision):
        self.configs = level_configs(config)
        self.grids = [Wavefronts(c, device, prec) for c in self.configs]
        self.maps = [f2c(c, device) for c in self.configs[:-1]]
        self.pre = int(config["pre_smoother_steps"])
        self.post = int(config["post_smoother_steps"])
        self.prec = prec

    def apply_inverse(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle from x = 0 on ``r`` (n, k)."""
        return self._vcycle(0, r.to(self.prec.dtype))

    def _vcycle(self, k: int, r: torch.Tensor) -> torch.Tensor:
        grid = self.grids[k]
        x = torch.zeros_like(r)
        if k == len(self.grids) - 1:
            return grid.symgs(r, x)
        for _ in range(self.pre):
            x = grid.symgs(r, x)
        res = r - stencil.apply(self.configs[k], x, self.prec)
        x[self.maps[k]] += self._vcycle(k + 1, res[self.maps[k]])
        for _ in range(self.post):
            x = grid.symgs(r, x)
        return x
