"""HPCG's operator applied as the 27-point stencil it is, on the grid: no CSR.

``y[z, y, x] = diag·v[z, y, x] + off·Σ v[z+dz, y+dy, x+dx]`` over the 26
neighbours inside the grid, with row p = x + nx·(y + ny·z).
"""

from __future__ import annotations

import itertools

import torch

from .precision import Precision

NEIGHBOURS = tuple(o for o in itertools.product((-1, 0, 1), repeat=3)
                   if o != (0, 0, 0))


def dims(config: dict) -> tuple:
    if config.get("stencil_points") != 27:
        raise ValueError("the reference knows HPCG's 27-point stencil only")
    return int(config["nx"]), int(config["ny"]), int(config["nz"])


def _span(d: int, n: int) -> tuple:
    """(destination, source) slices of one axis for neighbour offset d."""
    if d < 0:
        return slice(1, n), slice(0, n - 1)
    if d > 0:
        return slice(0, n - 1), slice(1, n)
    return slice(0, n), slice(0, n)


def apply(config: dict, v: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``A·v`` for ``v`` of shape (n,) or (n, k), in ``prec``."""
    nx, ny, nz = dims(config)
    shape = v.shape
    g = prec.cast(v).reshape(nz, ny, nx, -1)
    y = g * prec.cast(torch.tensor(float(config["diagonal"]))).item()
    off = prec.cast(torch.tensor(float(config["off_diagonal"]))).item()
    for dz, dy, dx in NEIGHBOURS:
        (tz, sz), (ty, sy), (tx, sx) = (_span(dz, nz), _span(dy, ny),
                                        _span(dx, nx))
        y[tz, ty, tx].add_(g[sz, sy, sx], alpha=off)
    return y.reshape(shape)


def dense(config: dict, device, block: int = 2048) -> torch.Tensor:
    """The operator as a dense float64 matrix, built column block by column
    block as the stencil applied to the identity's columns."""
    from .precision import FLOAT64

    nx, ny, nz = dims(config)
    n = nx * ny * nz
    a = torch.empty((n, n), dtype=torch.float64, device=device)
    for j0 in range(0, n, block):
        w = min(block, n - j0)
        e = torch.zeros((n, w), dtype=torch.float64, device=device)
        idx = torch.arange(w, device=device)
        e[j0 + idx, idx] = 1.0
        a[:, j0: j0 + w] = apply(config, e, FLOAT64)
    return a
