"""2-D mesh SpMM: rows of A over ``"rows"``, RHS columns over ``"cols"``,
the K panels ring-rotated along ``"rows"`` as in ``spmm.spmm_ring``.

Counterpart of ``basic_sparse_matrix_tpu/parallel/spmm2d.py``. Each
``"cols"`` rank holds one column strip of B (N padded up to a multiple of
the axis, as JAX pads it); the ring runs along ``"rows"`` within each
strip's column of the mesh: on a local mesh as a loop over the strips, on a
``torch.distributed`` mesh in the rows subgroup of the process's column.
The result is trimmed to ``[:, :n]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mesh import COLS, ROWS
from .sharded import ShardedCSR, held_rows
from .spmm import _on, _pad_k, ring_products


def spmm_ring_2d(sa: ShardedCSR, b, mesh) -> torch.Tensor:
    """The held ``(rows, columns)`` block of the row-sharded, column-split
    product; the whole ``(padded_rows, n)`` array on a local mesh."""
    rows_comm, cols_comm = mesh.axis(ROWS), mesh.axis(COLS)
    num, n_strips = rows_comm.size, cols_comm.size
    b = _pad_k(_on(b, sa), num)
    n = b.shape[1]
    if n % n_strips:
        b = F.pad(b, (0, n_strips - n % n_strips))
    kps, width = b.shape[0] // num, b.shape[1] // n_strips
    strips = []
    for c in cols_comm.local:
        panels = [b[s * kps: (s + 1) * kps, c * width: (c + 1) * width]
                  .contiguous() for s in rows_comm.local]
        strips.append(held_rows(ring_products(sa, panels, rows_comm),
                                rows_comm.local, sa.rows_per_shard))
    out = torch.cat(strips, dim=1) if len(strips) > 1 else strips[0]
    if cols_comm.local[-1] == n_strips - 1:
        keep = n - cols_comm.local[0] * width
        out = out[:, :keep]
    return out
