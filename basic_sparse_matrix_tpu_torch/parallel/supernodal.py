"""Distributed supernodal Cholesky (panel-granular).

Counterpart of ``basic_sparse_matrix_tpu/parallel/supernodal.py``. Within
a fan-in level of :mod:`~..models.supernodal`'s schedule the panel updates
and the panel finalisations are independent, so each ``"rows"`` rank takes
a contiguous range of the level's update batch and one of its panel batch
(:func:`~.levels.split_levels`; a rank may hold none) and runs the
single-device level step's pieces on them:

* the reads (windows through K3 where the group has a ``kread`` class,
  else element positions) and the batched product;
* the merge of the updates: on groups routed to a rect formulation
  (``delta``, ``rects``) each rank merges its updates into the level's
  (St, Rd, Wt) target rects (its ``seg`` indexes the level's full target
  table), the ranks' rects are summed in rank order (``all_reduce``) and
  added back ONCE, by the masked scatter or through ``addback_rects`` (the
  add-back kernel's rect entry on the card), as on one device. (Summing
  per-rank delta vectors of the factor's length instead would move
  ``nnz_l`` floats a rank and a level, and launch the add-back once a
  rank.) On ``element`` groups the ranks' products are gathered and
  scattered once, as on one device;
* the panel factorisations (``cholesky_ex``, ``_nan_failed``, the
  ``isfinite`` guard), whose results are gathered, not summed, and written
  back at the level's positions.

Routing stays per group under the config's ``supernodal_gather`` and
``supernodal_scatter`` (``_group_read``, ``_group_delta``), and ``lvals``
gets ``factorize_supernodal``'s tail padding, so K3 windows never clamp
into live data. The JAX package pads each level's batch to a multiple of
the mesh size and merges every phase by ``psum``.

On the card the whole phase is one CUDA graph per schedule, mesh, value
shape and configuration (``comm.compiled``; the tag is the single-device
``numeric_tag`` with ``"sharded"`` and the communicator's key), captured
on the second call as ``factorize_supernodal`` is. K3 and the rect entry
launch inside it. The int64 tables are the schedule's
(``supernodal.long_tables``), shared with the single-device phase.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models import supernodal as sn
from ..models.supernodal import (
    SupernodalSchedule,
    analyze_supernodal,
    assemble_factor,
)
from ..ops.csr import CSR
from ..utils.config import matmul_precision
from .comm import compiled
from .levels import gather_ragged, split_levels
from .mesh import ROWS


def _level_sharded(lvals, tabs, comm, R: int, Rd: int, scratch: int,
                   window: bool, smode: str, kread):
    """One level across the ranks of ``comm``; updates the replicated
    ``lvals`` in place."""
    (base, meta, irows, ibelow, jrows, jcp, cp, r_tab, tv,
     tcp, tnr, twd, seg) = tabs
    U, I = irows.shape
    J = jrows.shape[1]
    St, Wt = tcp.shape
    ub = split_levels((0, U), comm.size)[0]
    sb = split_levels((0, cp.shape[0]), comm.size)[0]

    # 1) each rank's slice of the update batch
    prods = []
    for r in comm.local:
        s = slice(ub[r], ub[r + 1])
        if ub[r + 1] == ub[r]:
            prods.append(None)
            continue
        prods.append(sn._update_products(
            lvals, base[s], meta[s], irows[s], ibelow[s], jrows[s], jcp[s],
            scratch, window, kread))
    if smode in ("delta", "rects"):
        rects = []
        for r, u3 in zip(comm.local, prods):
            s = slice(ub[r], ub[r + 1])
            rects.append(
                torch.zeros((St, Rd, Wt), dtype=lvals.dtype,
                            device=lvals.device) if u3 is None
                else sn._merge_rects(u3, meta[s], irows[s], ibelow[s],
                                     jrows[s], seg[s], St, Rd, Wt))
        sn._apply_rects(lvals, comm.all_reduce(rects)[0], tcp, tnr, twd,
                        scratch, smode)
    else:
        prods = [lvals.new_zeros((0, I, J)) if u3 is None else u3
                 for u3 in prods]
        sn._element_scatter(lvals, gather_ragged(comm, prods, np.diff(ub)),
                            base, meta, irows, ibelow, jrows, jcp, scratch)
    # fill_, not "= 0.0": assigning a Python float to a CUDA tensor uploads
    # it, a host synchronisation that a graph capture refuses
    lvals[scratch].fill_(0.0)

    # 2) each rank's slice of the panel batch, gathered in rank order
    tp, bp = sn._panel_positions(cp, r_tab, tv, R, scratch)
    tops, belows = [], []
    for r in comm.local:
        s = slice(sb[r], sb[r + 1])
        if sb[r + 1] == sb[r]:
            tops.append(lvals.new_zeros((0,) + tuple(tp.shape[1:])))
            belows.append(lvals.new_zeros((0,) + tuple(bp.shape[1:])))
            continue
        T, Bp = sn._panel_reads(lvals, cp[s], r_tab[s], tv[s], R, tp[s],
                                bp[s], window, kread)
        top, below = sn._panel_factors(T, Bp, tv[s])
        tops.append(top)
        belows.append(below)
    counts = np.diff(sb)
    lvals[tp] = gather_ragged(comm, tops, counts)
    lvals[bp] = gather_ragged(comm, belows, counts)
    lvals[scratch].fill_(0.0)


def factorize_supernodal_sharded(sched: SupernodalSchedule, a_values,
                                 mesh, *, chunk_groups: int = 0
                                 ) -> torch.Tensor:
    """Distributed numeric phase on the schedule's device: L's flat CSC
    value array (length ``nnz_l``), replicated. ``chunk_groups`` bounds
    each compiled XLA program to that many schedule groups in the JAX
    package; a CUDA graph has no such limit, so it is accepted and changes
    nothing (the phase is one graph on the card, op by op elsewhere)."""
    comm = mesh.axis(ROWS)
    a_values = torch.as_tensor(a_values, device=sched.a_src_pos.device)
    sn.long_tables(sched)
    return compiled(comm, sched, sn.numeric_tag(sched) + ("sharded",),
                    functools.partial(_factorize_levels, sched, comm,
                                      *sn._numeric_modes(sched)),
                    a_values, capture_on=2)


def _factorize_levels(sched: SupernodalSchedule, comm, window, mode: str,
                      pad: int, a_values: torch.Tensor) -> torch.Tensor:
    scratch = sched.nnz_l
    tables = sn.long_tables(sched)
    with matmul_precision():
        lvals = sn._init_lvals(sched, a_values, pad)
        for gi in range(sched.n_groups):
            smode = sn._group_delta(sched, gi, mode)
            win, kread = sn._group_read(sched, gi, window)
            tabs = tables[gi]
            for li in range(tabs[0].shape[0]):
                _level_sharded(lvals, tuple(t[li] for t in tabs), comm,
                               sched.panel_rmax[gi], sched.delta_rmax[gi],
                               scratch, win, smode, kread)
    return lvals[: sched.nnz_l]


def cholesky_supernodal_distributed(a: CSR, mesh, *, relax: int = 0,
                                    chunk_groups: int = 0) -> CSR:
    """End-to-end distributed supernodal Cholesky (host analysis, numeric
    phase across the mesh, host assembly), on ``a``'s device."""
    sched = analyze_supernodal(a, relax=relax)
    lvals = factorize_supernodal_sharded(sched, a.values, mesh,
                                         chunk_groups=chunk_groups)
    return assemble_factor(a, lvals, sched)
