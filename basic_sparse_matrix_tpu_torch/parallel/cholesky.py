"""Distributed level-scheduled sparse Cholesky (the scatter-list tier).

Counterpart of ``basic_sparse_matrix_tpu/parallel/cholesky.py``. Within one
level of :mod:`~..models.sparse_cholesky`'s schedule the update triples and
the column finalisations are independent, so each ``"rows"`` rank takes a
contiguous range of the level's triples and one of its columns (with those
columns' below-diagonal entries). The merges gather instead of summing:

* the ranks' update products, gathered in rank order, are the level's
  products in schedule order, and one ``index_add_`` of them into the
  replicated ``lvals`` is the single-device step;
* the finalised diagonals and scaled columns are disjoint, gathered and
  written back.

The JAX package pads each level to a multiple of the mesh size and merges
by ``psum`` of per-device delta vectors; here the schedule is ragged
(:func:`~.levels.split_levels`) and a rank may hold an empty range. The
guard ``where(diag > 0, 1/max(diag, 1e-30), 0)`` and the zeroed scratch
slot are ``factor_levels``'. On the CPU the factor equals
``models.sparse_cholesky.factorize`` bit for bit; on the card the
``index_add_`` adds with atomics, in no fixed order.

On the card the level loop is one CUDA graph per schedule, mesh, value
shape, matmul precision and deterministic-algorithms flag
(``comm.compiled``), captured on the second call, as the single-device
``factorize`` is: the first call on a schedule runs op by op.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..models.sparse_cholesky import (
    CholeskySchedule,
    analyze,
    csc_to_csr_l,
    initial_lvals,
)
from ..ops.csr import CSR, to_tensor
from ..runtime import graphs
from .comm import compiled
from .levels import gather_ragged, range_starts, split_levels
from .mesh import ROWS


@dataclasses.dataclass(eq=False)
class CholeskyShards:
    """A schedule's levels split over ``num`` ranks: rank ``r`` of level
    ``l`` applies the triples ``upd[l, r]:upd[l, r + 1]`` and finalises the
    level-ordered columns ``col[l, r]:col[l, r + 1]``, whose below-diagonal
    entries are ``off[l, r]:off[l, r + 1]``; ``seg`` is each such entry's
    column slot inside its rank's columns (on the schedule's device)."""

    upd: np.ndarray
    col: np.ndarray
    off: np.ndarray
    seg: torch.Tensor
    num: int


def shard_levels(sched: CholeskySchedule, num: int) -> CholeskyShards:
    """Split each level over ``num`` ranks (host); built once per schedule
    and rank count."""
    cache = sched.__dict__.setdefault("_shards", {})
    if num not in cache:
        col = split_levels(sched.col_ptr, num)
        off_ptr = np.asarray(sched.off_ptr)
        level = np.repeat(np.arange(sched.n_levels), np.diff(off_ptr))
        # each entry's column in level order: non-decreasing
        ecol = np.asarray(sched.col_ptr)[level] + sched.col_seg.cpu().numpy()
        seg = ecol - range_starts(col, sched.n)[ecol]
        cache[num] = CholeskyShards(
            upd=split_levels(sched.upd_ptr, num), col=col,
            off=np.searchsorted(ecol, col),
            seg=to_tensor(seg.astype(np.int64), sched.col_seg.device),
            num=num)
    return cache[num]


def factorize_sharded(sched: CholeskySchedule, a_values, mesh
                      ) -> torch.Tensor:
    """Distributed numeric phase on ``a_values``' device: L's CSC value
    array (length ``nnz_l``), replicated."""
    comm = mesh.axis(ROWS)
    sh = shard_levels(sched, comm.size)
    a_values = torch.as_tensor(a_values, device=sched.upd_dst.device)
    return compiled(comm, sched, ("numeric_sharded",) + graphs.host_state(),
                    functools.partial(_factorize_levels, sched, sh, comm),
                    a_values, capture_on=2)


def _factorize_levels(sched: CholeskySchedule, sh: CholeskyShards, comm,
                      a_values: torch.Tensor) -> torch.Tensor:
    lvals = initial_lvals(sched, a_values)
    for ub, cb, ob in zip(sh.upd, sh.col, sh.off):
        if ub[-1] > ub[0]:
            deltas = [lvals[sched.upd_a[ub[r]: ub[r + 1]]]
                      * lvals[sched.upd_b[ub[r]: ub[r + 1]]]
                      for r in comm.local]
            lvals.index_add_(0, sched.upd_dst[ub[0]: ub[-1]],
                             gather_ragged(comm, deltas, np.diff(ub)),
                             alpha=-1)
        diags, offs = [], []
        for r in comm.local:
            diag = lvals[sched.col_diag[cb[r]: cb[r + 1]]].sqrt()
            inv = torch.where(diag > 0, 1.0 / diag.clamp_min(1e-30), 0.0)
            o0, o1 = ob[r], ob[r + 1]
            diags.append(diag)
            offs.append(lvals[sched.col_off[o0:o1]] * inv[sh.seg[o0:o1]])
        lvals[sched.col_diag[cb[0]: cb[-1]]] = gather_ragged(
            comm, diags, np.diff(cb))
        if ob[-1] > ob[0]:
            lvals[sched.col_off[ob[0]: ob[-1]]] = gather_ragged(
                comm, offs, np.diff(ob))
    # fill_, not "= 0.0": a Python float assigned to a CUDA tensor is an
    # upload, a host synchronisation that a graph capture refuses
    lvals[-1].fill_(0.0)
    return lvals[:-1]


def cholesky_sparse_distributed(a: CSR, mesh) -> CSR:
    """End-to-end distributed sparse Cholesky (symbolic phase on the host,
    numeric phase across the mesh), on ``a``'s device."""
    sched = analyze(a)
    return csc_to_csr_l(sched, factorize_sharded(sched, a.values, mesh))
