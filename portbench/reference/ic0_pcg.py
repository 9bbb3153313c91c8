"""IC(0)-preconditioned CG on HPCG's grid: the reference of ``solve_cg``.

The incomplete factor L has the pattern of A's lower triangle: one
coefficient a grid point for each of the 13 neighbours that precede it
(``LOWER``, in ascending column order) and a diagonal. Row p is
``L[p, p+d] = (A[p, p+d] - Σ_e L[p, p+e]·L[p+d, p+e]) / L[p+d, p+d]`` over
the preceding neighbours e < d of p that are also neighbours of p+d, then
``L[p, p] = sqrt(A[p, p] - Σ_d L[p, p+d]²)``: the IC(0) factor, worked out
row by row from the stencil.

Rows depend only on earlier neighbours, so the grid points fall into
levels ``x + 2y + 4z`` (each preceding neighbour lies at least one level
lower): the factor and both triangular solves run level by level, every
point of a level at once. PCG is the textbook loop from x = 0, with the
program's guards (``alpha = rz / max(p·Ap, 1e-30)``, ``beta = rz' /
max(rz, 1e-30)``), for each column of ``b`` on its own.
"""

from __future__ import annotations

import itertools

import torch

from . import stencil
from .precision import Precision

LOWER = tuple(o for o in itertools.product((-1, 0, 1), repeat=3)
              if o < (0, 0, 0))


def _pairs():
    """For each d of ``LOWER``: the (e, e - d) index pairs of the sum."""
    out = []
    for d in LOWER:
        pe, pf = [], []
        for ie, e in enumerate(LOWER):
            f = tuple(a - b for a, b in zip(e, d))
            if e < d and f in LOWER:
                pe.append(ie)
                pf.append(LOWER.index(f))
        out.append((pe, pf))
    return out


class GridIC0:
    """The IC(0) factor of the operator in ``prec``, with level tables for
    the factor and both triangular solves."""

    def __init__(self, config: dict, device, prec: Precision):
        nx, ny, nz = stencil.dims(config)
        n = nx * ny * nz
        self.n, self.prec = n, prec
        dt = prec.dtype
        z, y, x = (t.reshape(-1) for t in torch.meshgrid(
            torch.arange(nz, device=device), torch.arange(ny, device=device),
            torch.arange(nx, device=device), indexing="ij"))
        level = x + 2 * y + 4 * z
        self.lin = [dx + nx * (dy + ny * dz) for dz, dy, dx in LOWER]

        def inside(dz, dy, dx):
            return ((z + dz >= 0) & (z + dz < nz) & (y + dy >= 0)
                    & (y + dy < ny) & (x + dx >= 0) & (x + dx < nx))

        valid = torch.stack([inside(*d) for d in LOWER])
        p = torch.arange(n, device=device)
        for i, step in enumerate(self.lin):
            dep = (p + step).clamp(0, n - 1)
            if not bool((level[dep] < level)[valid[i]].all()):
                raise AssertionError("levels x + 2y + 4z do not order IC(0)")
        order = torch.argsort(level, stable=True)
        counts = torch.bincount(level)
        self.ptr = [0] + torch.cumsum(counts, 0).tolist()
        self.order = order
        lin = torch.tensor(self.lin, device=device)
        # Per level: the points, and for every one its 13 preceding
        # (forward) and following (backward) neighbours, clamped in range.
        self.fwd_idx = (order[None, :] + lin[:, None]).clamp(0, n - 1)
        self.bwd_idx = (order[None, :] - lin[:, None]).clamp(0, n - 1)
        off = float(config["off_diagonal"])
        diag = float(config["diagonal"])
        lo = torch.zeros((len(LOWER), n), dtype=dt, device=device)
        ld = torch.zeros(n, dtype=dt, device=device)
        pairs = [(torch.tensor(e, device=device),
                  torch.tensor(f, device=device)) for e, f in _pairs()]
        for k in range(len(self.ptr) - 1):
            s0, s1 = self.ptr[k], self.ptr[k + 1]
            pts = order[s0:s1]
            for i, (pe, pf) in enumerate(pairs):
                j = self.fwd_idx[i, s0:s1]
                a = torch.full_like(pts, 1, dtype=dt) * off
                if pe.numel():
                    s = (prec.rnd(lo[pe[:, None], pts[None, :]])
                         * prec.rnd(lo[pf[:, None], j[None, :]])).sum(0)
                    a = a - s
                lo[i, pts] = torch.where(valid[i, pts], a / ld[j],
                                         torch.zeros_like(a))
            sq = (prec.rnd(lo[:, pts]) ** 2).sum(0)
            ld[pts] = torch.sqrt(diag - sq)
        self.lo, self.ld = prec.rnd(lo), prec.rnd(ld)
        # Backward coefficients: L[p - d, p] for each d, 0 off the grid.
        back = torch.stack([
            torch.where(inside(-dz, -dy, -dx),
                        self.lo[i][(p - self.lin[i]).clamp(0, n - 1)], 0.0)
            for i, (dz, dy, dx) in enumerate(LOWER)])
        self.fwd_coef = self.lo[:, order]
        self.bwd_coef = back[:, order]

    def _sweep(self, r, coef, idx, levels):
        prec = self.prec
        out = torch.zeros_like(r)
        for k in levels:
            s0, s1 = self.ptr[k], self.ptr[k + 1]
            pts = self.order[s0:s1]
            acc = (coef[:, s0:s1, None]
                   * prec.rnd(out[idx[:, s0:s1]])).sum(0)
            out[pts] = (r[pts] - acc) / self.ld[pts, None]
        return out

    def apply_inverse(self, r: torch.Tensor) -> torch.Tensor:
        """``(L Lᵀ)⁻¹ r`` for ``r`` (n, k)."""
        nlev = len(self.ptr) - 1
        y = self._sweep(r, self.fwd_coef, self.fwd_idx, range(nlev))
        return self._sweep(y, self.bwd_coef, self.bwd_idx,
                           range(nlev - 1, -1, -1))


def pcg(config: dict, b: torch.Tensor, iters: int, prec: Precision,
        m: GridIC0 = None) -> torch.Tensor:
    """``iters`` IC(0)-PCG iterations from x = 0 for each column of ``b``
    (n, k), in ``prec``; returns the iterates (n, k)."""
    m = m or GridIC0(config, b.device, prec)
    rnd = prec.rnd

    def dot(u, v):
        return (rnd(u) * rnd(v)).sum(0)

    r = b.to(prec.dtype)
    z = m.apply_inverse(r)
    x, p, rz = torch.zeros_like(r), z, dot(r, z)
    for _ in range(iters):
        ap = stencil.apply(config, p, prec)
        alpha = rz / dot(p, ap).clamp_min(1e-30)
        x = x + rnd(alpha) * rnd(p)
        r = r - rnd(alpha) * rnd(ap)
        z = m.apply_inverse(r)
        rz_new = dot(r, z)
        beta = rz_new / rz.clamp_min(1e-30)
        p = z + rnd(beta) * rnd(p)
        rz = rz_new
    return x
