"""GAP's PageRank product worked out from the graph's edge list:
``y_i = Σ_{j ∈ N(i)} x_j / deg(j)``, and beside it each row's scale
``s_i = Σ_{j ∈ N(i)} |x_j / deg(j)|``, the sum of the magnitudes the row
adds, which the row-relative comparison divides by.

It takes the arcs (row ``i``, neighbour ``j``) as the generator's row
pointer and neighbour list, never the program's values: ``deg(j)`` is
counted here, as the arcs whose row is ``j``. The sums run over blocks of
``BLOCK`` arcs on ``x``'s device. In ``FLOAT64`` (the reference) every
operand and sum is float64; in ``TF32`` (the control) ``1 / deg(j)`` and
``x`` are rounded to TF32 and the products are added in float32.
:func:`row_error` is the row-relative comparison with that scale.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import Precision

BLOCK = 1 << 25


def degrees(indptr: np.ndarray, device) -> torch.Tensor:
    """deg(j) of every vertex, int64 on ``device``."""
    return torch.as_tensor(np.diff(indptr.astype(np.int64)), device=device)


def apply(indptr: np.ndarray, indices: np.ndarray, x: torch.Tensor,
          prec: Precision, scale: bool = False):
    """``P·x`` for ``x`` of shape (n,) or (n, k), in ``prec``; with
    ``scale`` also ``|P|·|x|``, returned as a pair."""
    dev = x.device
    deg = degrees(indptr, dev)
    w = prec.cast(1.0 / deg.clamp(min=1).to(torch.float64))
    xs = prec.cast(x)
    y = torch.zeros(xs.shape, dtype=prec.dtype, device=dev)
    s = torch.zeros(xs.shape, dtype=prec.dtype, device=dev) if scale \
        else None
    ptr = torch.as_tensor(indptr.astype(np.int64), device=dev)
    for e0 in range(0, indices.shape[0], BLOCK):
        e1 = min(e0 + BLOCK, indices.shape[0])
        col = torch.as_tensor(indices[e0:e1], device=dev).long()
        row = torch.searchsorted(ptr, torch.arange(e0, e1, device=dev),
                                 right=True) - 1
        term = xs[col] * (w[col] if xs.ndim == 1 else w[col, None])
        y.index_add_(0, row, term)
        if scale:
            s.index_add_(0, row, term.abs())
        del col, row, term
    return (y, s) if scale else y


def row_error(answer: torch.Tensor, ref: torch.Tensor,
              scale: torch.Tensor) -> float:
    """max over rows with entries (``scale`` > 0) of |answer − ref| ÷ scale;
    infinite where an empty row is not exactly 0 or a row is not finite."""
    live = scale > 0
    ans = answer.to(torch.float64)
    if bool((ans[~live] != 0).any()):
        return float("inf")
    err = float(((ans[live] - ref[live]).abs() / scale[live]).max()) \
        if bool(live.any()) else 0.0
    return err if err == err and err != float("inf") else float("inf")
