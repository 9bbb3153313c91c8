"""Distributed conjugate gradient.

Counterpart of ``basic_sparse_matrix_tpu/parallel/cg.py``: each rank
applies its row block of A to the replicated search direction, one tiled
all-gather assembles the product, and the scalars (dot products) are
computed redundantly by every rank from the replicated vectors, with the
JAX package's ``1e-30`` floors.

The iteration count is fixed, as in the JAX package (``fori_loop(0,
iters)``); ``tol`` is accepted and unused there and here. Nothing is read
back to the host inside the loop, so on the card the loop is one CUDA
graph per ``ShardedCSR``, mesh, ``iters`` and shape (``comm.compiled``),
captured on the first call and replayed on every later one.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .comm import compiled
from .mesh import ROWS
from .sharded import ShardedCSR
from .spmm import _on, local_spmv, prepare_local_spmv


def gathered_matvec(sa: ShardedCSR, comm, ps):
    """``A p`` for each rank's replicated ``p``: the local row block's
    SpMV, then one tiled all-gather."""
    return comm.all_gather([local_spmv(sa.local(s), p)
                            for s, p in zip(comm.local, ps)])


def padded_rhs(sa: ShardedCSR, b) -> torch.Tensor:
    b = _on(b, sa)
    return F.pad(b, (0, sa.padded_rows - b.shape[0]))


def cg_solve_sharded(sa: ShardedCSR, b, mesh, iters: int = 50,
                     tol: float = 0.0) -> torch.Tensor:
    """Solve ``A x = b`` (SPD, row-sharded A) by ``iters`` CG steps. ``b``
    replicated (its padded tail is zero); returns the replicated ``x`` of
    length ``padded_rows``."""
    comm = mesh.axis(ROWS)
    prepare_local_spmv(sa, comm)
    return compiled(comm, sa, ("cg", int(iters)),
                    functools.partial(_cg_loop, sa, comm, int(iters)),
                    padded_rhs(sa, b))


def _cg_loop(sa: ShardedCSR, comm, iters: int, b_full: torch.Tensor
             ) -> torch.Tensor:
    m = len(comm.local)
    xs = [torch.zeros_like(b_full)] * m
    rs = [b_full] * m
    ps = [b_full] * m
    rrs = [torch.dot(b_full, b_full)] * m
    for _ in range(iters):
        aps = gathered_matvec(sa, comm, ps)
        for i in range(m):
            x, r, p, rr, ap = xs[i], rs[i], ps[i], rrs[i], aps[i]
            alpha = rr / torch.dot(p, ap).clamp_min(1e-30)
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = torch.dot(r, r)
            beta = rr_new / rr.clamp_min(1e-30)
            xs[i], rs[i], ps[i], rrs[i] = x, r, r + beta * p, rr_new
    return xs[0]
