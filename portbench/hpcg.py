"""HPCG's operator (Dongarra, Heroux, Luszczek, SAND2013-8752): the 27-point
stencil on an nx × ny × nz grid, diagonal 26 and every neighbour -1, with
row p = x + nx·(y + ny·z) and each row's columns in ascending order.

This is the benchmark's input generator. It builds the CSR triple on the
host, vectorised with numpy, once per run; the program and the reference
both take the operator from here (the reference through the stencil
itself, :mod:`portbench.reference.stencil`, never through these arrays).
"""

from __future__ import annotations

import itertools

import numpy as np

# (dz, dy, dx) of the 27-point box, in ascending order of linear offset.
OFFSETS = tuple(itertools.product((-1, 0, 1), repeat=3))


def grid(config: dict) -> tuple:
    """(nx, ny, nz) of a configuration."""
    if config.get("stencil_points") != 27:
        raise ValueError(f"only HPCG's 27-point stencil is generated, not "
                         f"{config.get('stencil_points')!r}")
    return int(config["nx"]), int(config["ny"]), int(config["nz"])


def rows(config: dict) -> int:
    nx, ny, nz = grid(config)
    return nx * ny * nz


def linear(off, dims) -> int:
    """The linear offset of (dz, dy, dx) on an (nx, ny, nz) grid."""
    dz, dy, dx = off
    nx, ny, _ = dims
    return dx + nx * (dy + ny * dz)


def csr(config: dict):
    """(indptr int32, indices int32, values float32) of the operator, rows
    and columns in HPCG's order."""
    nx, ny, nz = dims = grid(config)
    n = nx * ny * nz
    z, y, x = (a.ravel() for a in np.meshgrid(
        np.arange(nz, dtype=np.int32), np.arange(ny, dtype=np.int32),
        np.arange(nx, dtype=np.int32), indexing="ij"))
    p = np.arange(n, dtype=np.int32)
    cols = np.empty((n, len(OFFSETS)), dtype=np.int32)
    live = np.empty((n, len(OFFSETS)), dtype=bool)
    for j, off in enumerate(OFFSETS):
        dz, dy, dx = off
        live[:, j] = ((z + dz >= 0) & (z + dz < nz) & (y + dy >= 0)
                      & (y + dy < ny) & (x + dx >= 0) & (x + dx < nx))
        cols[:, j] = p + linear(off, dims)
    diag = np.array([off == (0, 0, 0) for off in OFFSETS])
    vals = np.where(diag, np.float32(config["diagonal"]),
                    np.float32(config["off_diagonal"])).astype(np.float32)
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(live.sum(1, dtype=np.int32), out=indptr[1:])
    indices = cols[live]
    values = np.broadcast_to(vals, live.shape)[live]
    return indptr, indices, np.ascontiguousarray(values)
