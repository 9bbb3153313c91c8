"""A plain-torch reference of HPCG's multigrid-preconditioned CG, worked
out on the grid, for ``test_torch_multigrid.py``. It imports neither JAX
nor either package of this repository.

HPCG's operator on an nx × ny × nz grid (row x + nx·(y + ny·z)): diagonal
26, each of the up to 26 neighbours −1. Symmetric Gauss–Seidel in natural
order runs by wavefronts x + 2y + 4z: no two neighbours share a wavefront,
and a neighbour of higher row number lies on a later one, so a wavefront at
a time is the sequential sweep. :func:`symgs_sequential` is that sweep
literally, row by row, for the smallest grids. The V-cycle and PCG follow
HPCG 3.1's ``ComputeMG_ref`` and ``CG_ref`` (with the guards ``max(p·Ap,
1e-30)`` and ``max(rz, 1e-30)``), in float64.
"""

import itertools

import numpy as np
import torch

NEIGHBOURS = tuple(o for o in itertools.product((-1, 0, 1), repeat=3)
                   if o != (0, 0, 0))
DIAG, OFF = 26.0, -1.0


def csr(dims):
    """(indptr, indices, values) of the operator, columns ascending."""
    nx, ny, nz = dims
    rows, cols = [], []
    for z, y, x in itertools.product(range(nz), range(ny), range(nx)):
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            if 0 <= x + dx < nx and 0 <= y + dy < ny and 0 <= z + dz < nz:
                rows.append(x + nx * (y + ny * z))
                cols.append(x + dx + nx * (y + dy + ny * (z + dz)))
    rows, cols = np.array(rows), np.array(cols)
    vals = np.where(rows == cols, DIAG, OFF).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=nx * ny * nz))])
    return indptr.astype(np.int32), cols.astype(np.int32), vals


def f2c(dims):
    """Coarse point (i, j, k) → fine point (2i, 2j, 2k), by a loop."""
    nx, ny, nz = dims
    return torch.tensor([2 * i + nx * (2 * j + ny * 2 * k)
                         for k in range(nz // 2) for j in range(ny // 2)
                         for i in range(nx // 2)], dtype=torch.int64)


def hierarchy(dims, levels):
    """The grids of ``levels`` levels, each halved in every dimension."""
    return [tuple(d >> k for d in dims) for k in range(levels)]


class Grid:
    """Neighbour tables and wavefronts of one grid."""

    def __init__(self, dims):
        nx, ny, nz = self.dims = dims
        self.n = n = nx * ny * nz
        z, y, x = (t.reshape(-1) for t in torch.meshgrid(
            torch.arange(nz), torch.arange(ny), torch.arange(nx),
            indexing="ij"))
        wave = x + 2 * y + 4 * z
        self.order = torch.argsort(wave, stable=True)
        self.ptr = [0] + torch.cumsum(torch.bincount(wave), 0).tolist()
        self.nbr = torch.stack([
            (x + dx + nx * (y + dy + ny * (z + dz))).clamp(0, n - 1)
            for dz, dy, dx in NEIGHBOURS])
        self.valid = torch.stack([
            ((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
             & (z + dz >= 0) & (z + dz < nz)) for dz, dy, dx in NEIGHBOURS
        ]).to(torch.float64)

    def apply(self, v):
        """A·v for v (n,) or (n, k)."""
        tail = (1,) * (v.ndim - 1)
        nb = (self.valid.reshape(self.valid.shape + tail) * v[self.nbr]).sum(0)
        return DIAG * v + OFF * nb

    def sweep(self, r, x, forward=True):
        """One Gauss–Seidel sweep of A x = r from ``x``, wavefront by
        wavefront, forward or backward; a new tensor."""
        x = x.clone()
        tail = (1,) * (r.ndim - 1)
        waves = range(len(self.ptr) - 1)
        for k in (waves if forward else reversed(waves)):
            pts = self.order[self.ptr[k]:self.ptr[k + 1]]
            nb = (self.valid[:, pts].reshape((26, -1) + tail)
                  * x[self.nbr[:, pts]]).sum(0)
            x[pts] = (r[pts] - OFF * nb) / DIAG
        return x

    def symgs(self, r, x):
        return self.sweep(r, self.sweep(r, x, True), False)


def symgs_sequential(indptr, indices, values, r, x, forward=True,
                     backward=True):
    """``ComputeSYMGS_ref`` literally: row by row, forward then backward,
    on the CSR triple (float64 numpy)."""
    x = np.array(x, dtype=np.float64)
    n = len(indptr) - 1

    def row(i):
        s, d = r[i], 0.0
        for e in range(indptr[i], indptr[i + 1]):
            if indices[e] == i:
                d = values[e]
            else:
                s -= values[e] * x[indices[e]]
        x[i] = s / d

    if forward:
        for i in range(n):
            row(i)
    if backward:
        for i in reversed(range(n)):
            row(i)
    return x


class MG:
    """HPCG's V-cycle over ``levels`` grids from ``dims``."""

    def __init__(self, dims, levels, pre=1, post=1):
        self.grids = [Grid(d) for d in hierarchy(dims, levels)]
        self.maps = [f2c(g.dims) for g in self.grids[:-1]]
        self.pre, self.post = pre, post

    def vcycle(self, r, k=0):
        g = self.grids[k]
        x = torch.zeros_like(r)
        if k == len(self.grids) - 1:
            return g.symgs(r, x)
        for _ in range(self.pre):
            x = g.symgs(r, x)
        xc = self.vcycle((r - g.apply(x))[self.maps[k]], k + 1)
        x[self.maps[k]] += xc
        for _ in range(self.post):
            x = g.symgs(r, x)
        return x


def pcg(mg, b, iters):
    """``iters`` MG-preconditioned CG iterations from x = 0, float64."""
    a = mg.grids[0]
    r = b.to(torch.float64)
    z = mg.vcycle(r)
    x, p, rz = torch.zeros_like(r), z, r @ z
    for _ in range(iters):
        ap = a.apply(p)
        alpha = rz / (p @ ap).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = mg.vcycle(r)
        rz_new = r @ z
        beta = rz_new / rz.clamp_min(1e-30)
        p = z + beta * p
        rz = rz_new
    return x
