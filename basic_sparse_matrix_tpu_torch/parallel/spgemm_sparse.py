"""Distributed sparse × sparse multiply (SpGEMM) over the row mesh.

Counterpart of ``basic_sparse_matrix_tpu/parallel/spgemm_sparse.py``.
C = A·B row-partitions A, so each rank owns an independent Gustavson
product ``C_s = A_s · B``. The symbolic phase runs per row block on the
host, one port ``_SpgemmPlan`` (``ops/spgemm.py``) per block, reusable
across numeric calls with the same patterns. The numeric phase: every
rank's gather maps are padded to common shapes (padded contributions go to
the discard slot ``nnz_max``), one gather-multiply-``index_add_`` per rank,
then one untiled all-gather of the per-rank values, from which every rank
assembles the global CSR from the per-block exact patterns. B is
replicated.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.csr import CSR
from ..ops.spgemm import _SpgemmPlan
from ..utils.errors import IncorrectDimensions, check
from .mesh import ROWS


def _row_block(a: CSR, r0: int, r1: int) -> CSR:
    ia, xa, va = a.numpy()
    lo, hi = int(ia[r0]), int(ia[r1])
    return CSR.from_host(ia[r0: r1 + 1] - lo, xa[lo:hi], va[lo:hi],
                         (r1 - r0, a.cols), device=a.device)


def plan_spgemm_sharded(a: CSR, b: CSR, num_shards: int
                        ) -> List[_SpgemmPlan]:
    """Host symbolic phase: one exact Gustavson plan per row block of A
    (an empty ``(1, cols)`` block where the block has no rows)."""
    check(a.cols == b.rows, IncorrectDimensions,
          f"spgemm_sharded: {a.dims} × {b.dims}")
    rps = -(-a.rows // num_shards)
    plans = []
    for s in range(num_shards):
        r0, r1 = s * rps, min((s + 1) * rps, a.rows)
        block = CSR.empty((1, a.cols), dtype=a.dtype, device=a.device) \
            if r0 >= r1 else _row_block(a, r0, r1)
        plans.append(_SpgemmPlan(block, b))
    return plans


def _padded(t: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    out = torch.full((size,), fill, dtype=torch.long, device=t.device)
    out[: t.shape[0]] = t
    return out


def spgemm_sharded(a: CSR, b: CSR, mesh,
                   plans: Optional[List[_SpgemmPlan]] = None) -> CSR:
    """C = A·B with the numeric phase run by the mesh's row ranks; returns
    the assembled global CSR (exact pattern, as ``spgemm_planned``)."""
    comm = mesh.axis(ROWS)
    num = comm.size
    if plans is None:
        plans = plan_spgemm_sharded(a, b, num)
    rps = -(-a.rows // num)
    exp_max = max(max(int(p.dst.shape[0]) for p in plans), 1)
    nnz_max = max(max(p.nnz_c for p in plans), 1)
    ia = a.numpy()[0]
    bounds = []
    for s in range(num):
        r0, r1 = s * rps, min((s + 1) * rps, a.rows)
        bounds.append((int(ia[r0]), int(ia[r1])) if r0 < a.rows else (0, 0))
    va = a.values.to(torch.float32)
    vb = b.values.to(torch.float32)
    outs = []
    for s in comm.local:
        p, (lo, hi) = plans[s], bounds[s]
        dst = _padded(p.dst, exp_max, nnz_max)
        prod = va[lo:hi][_padded(p.src_a, exp_max, 0)] \
            if hi > lo else torch.zeros(exp_max, device=va.device)
        prod = prod * vb[_padded(p.src_b, exp_max, 0)] if b.stored \
            else torch.zeros_like(prod)
        out = torch.zeros(nnz_max + 1, dtype=torch.float32,
                          device=va.device)
        outs.append(out.index_add_(0, dst, prod)[:nnz_max])
    stacked = comm.all_gather(outs, tiled=False)[0]

    vals, indices, ptrs = [], [], [np.zeros(1, dtype=np.int64)]
    base = 0
    for s, p in enumerate(plans):
        r0, r1 = s * rps, min((s + 1) * rps, a.rows)
        if r0 >= r1:
            continue
        vals.append(stacked[s, : p.nnz_c])
        indices.append(p._host_indices)
        ptrs.append(p._host_indptr[1: r1 - r0 + 1] + base)
        base += p.nnz_c
    dev = stacked.device
    indptr = np.concatenate(ptrs).astype(np.int32)
    idx = np.concatenate(indices) if indices else np.zeros(0, np.int32)
    return CSR(indptr=torch.as_tensor(indptr, device=dev),
               indices=torch.as_tensor(idx, device=dev),
               values=torch.cat(vals) if vals
               else torch.zeros(0, dtype=torch.float32, device=dev),
               rows=a.rows, cols=b.cols)
