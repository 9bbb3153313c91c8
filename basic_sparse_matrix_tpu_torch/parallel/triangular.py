"""Distributed level-scheduled sparse triangular solve.

Counterpart of ``basic_sparse_matrix_tpu/parallel/triangular.py``: the
rows of one level of :class:`~..models.sparse_triangular.TriangularSchedule`
depend only on earlier levels, so they are split over the ``"rows"``
ranks; each rank solves its rows from the replicated solution and one
gather per level puts the level's rows back in order on every rank.

The JAX package pads each level's row batch to a multiple of the mesh size
on its padded (levels, max rows, max entries) schedule, which at n = 35,937
would take 233 GB. Here the port's ragged schedule is cut: a level's rows
are one contiguous slice of the level-ordered unknowns, rank ``r`` takes a
contiguous sub-range of them (:func:`~.levels.split_levels`), and its
entries are the matching sub-range of the level's entries (entries are
sorted by row slot). Each rank's per-row arithmetic is the single-device
solve's, so on the CPU the result equals ``solve_triangular_sparse`` bit
for bit.

On the card the level loop is one CUDA graph per schedule, mesh and
right-hand-side shape (``comm.compiled``), captured on the first call and
replayed on every later one, as the single-device solve is; the rank
splits are host numbers fixed per schedule, so they are part of the
recorded program.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..models.sparse_triangular import TriangularSchedule, build_schedule
from ..ops.csr import CSR, to_tensor
from ..utils.errors import IncorrectDimensions, check
from .comm import compiled
from .levels import gather_ragged, range_starts, split_levels
from .mesh import ROWS


@dataclasses.dataclass(eq=False)
class TriangularShards:
    """A schedule's levels split over ``num`` ranks: rank ``r`` solves the
    level-ordered rows ``rows[l, r]:rows[l, r + 1]`` of level ``l`` with the
    entries ``ents[l, r]:ents[l, r + 1]``; ``seg`` is each entry's row slot
    inside its rank's rows (on the schedule's device)."""

    rows: np.ndarray     # (levels, num + 1)
    ents: np.ndarray     # (levels, num + 1)
    seg: torch.Tensor    # (nnz_off,) int64
    num: int


def shard_schedule(sched: TriangularSchedule, num: int) -> TriangularShards:
    """Split each level's rows over ``num`` ranks (host); built once per
    schedule and rank count."""
    cache = sched.__dict__.setdefault("_shards", {})
    if num not in cache:
        rows = split_levels(sched.row_ptr, num)
        ent_ptr = np.asarray(sched.ent_ptr)
        level = np.repeat(np.arange(sched.n_levels), np.diff(ent_ptr))
        # each entry's row in level order: non-decreasing over all entries
        erow = np.asarray(sched.row_ptr)[level] + sched.seg.cpu().numpy()
        seg = erow - range_starts(rows, sched.n)[erow]
        cache[num] = TriangularShards(
            rows=rows, ents=np.searchsorted(erow, rows),
            seg=to_tensor(seg.astype(np.int64), sched.seg.device), num=num)
    return cache[num]


def solve_triangular_sharded(sched: TriangularSchedule, b,
                             mesh) -> torch.Tensor:
    """Distributed solve of the lower-triangular system encoded by
    ``sched`` (a mirrored schedule solves the reversed system, as on one
    device). ``b`` (n,) or (n, k) is replicated; returns the replicated
    solution on the schedule's device."""
    comm = mesh.axis(ROWS)
    sh = shard_schedule(sched, comm.size)
    dev = sched.rows.device
    b = torch.as_tensor(b).to(device=dev, dtype=torch.float32)
    check(b.shape[0] == sched.n, IncorrectDimensions,
          f"triangular solve: n={sched.n} vs b {tuple(b.shape)}")
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    x = compiled(comm, sched, ("solve_sharded",),
                 functools.partial(_solve_levels, sched, sh, comm), b)
    return x[:, 0] if squeeze else x


def _solve_levels(sched: TriangularSchedule, sh: TriangularShards, comm,
                  b: torch.Tensor) -> torch.Tensor:
    """The level loop on (n, k) ``b``."""
    # y holds the unknowns in level order: level l is y[row_ptr[l]:...]
    y = b.index_select(0, sched.rows)
    vals = sched.vals[:, None]
    inv_diag = sched.inv_diag[:, None]
    for rb, eb in zip(sh.rows, sh.ents):
        parts = []
        for r in comm.local:
            r0, r1, e0, e1 = rb[r], rb[r + 1], eb[r], eb[r + 1]
            if r1 == r0:
                parts.append(y[r0:r0])
                continue
            part = y[r0:r1].clone()
            if e1 > e0:
                prod = y.index_select(0, sched.cols[e0:e1]) * vals[e0:e1]
                part.index_add_(0, sh.seg[e0:e1], prod, alpha=-1)
            parts.append(part.mul_(inv_diag[r0:r1]))
        y[rb[0]: rb[-1]] = gather_ragged(comm, parts, np.diff(rb))
    return torch.empty_like(y).index_copy_(0, sched.rows, y)


def solve_sparse_distributed(l: CSR, b, mesh, *,
                             lower: bool = True) -> torch.Tensor:
    """Build the schedule of ``l`` (on ``l``'s device), then solve across
    the mesh. ``lower=False`` solves through the mirrored schedule with
    ``b`` and the solution reversed, as the JAX package does."""
    sched = build_schedule(l, lower=lower)
    b = torch.as_tensor(b).to(sched.rows.device)
    if not sched.lower:
        rev = torch.flip(b, (0,))
        return torch.flip(solve_triangular_sharded(sched, rev, mesh), (0,))
    return solve_triangular_sharded(sched, b, mesh)
