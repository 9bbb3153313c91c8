"""Distributed preconditioned CG: block-Jacobi with one dense Cholesky
factor per row block.

Counterpart of ``basic_sparse_matrix_tpu/parallel/pcg.py``. Every rank
densifies its diagonal block ``A[s·rps:(s+1)·rps, same]`` (entries outside
the local column range dropped, duplicates added as JAX's ``.at[].add``
adds them, a unit diagonal on rows without one, such as the partition's
padding rows), factors it once (:func:`build_block_jacobi`) and applies two
local triangular solves per iteration: the preconditioner needs no
collective, so a step's only communication stays the matvec's all-gather.
The factor and the solves are ``torch.linalg.cholesky`` and
``solve_triangular`` (XLA-level ops in the JAX package), run under
:func:`~..utils.config.matmul_precision` (TF32 off).

On the card the iterations are one CUDA graph per ``ShardedCSR``, mesh,
``iters`` and shape (``comm.compiled``), captured on the first call, with
``lfac`` an operand; the factors themselves are built once, outside it.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..utils.config import matmul_precision
from .cg import gathered_matvec, padded_rhs
from .comm import compiled
from .mesh import ROWS
from .sharded import ShardedCSR
from .spmm import prepare_local_spmv


def _local_diag_block(sa: ShardedCSR, s: int) -> torch.Tensor:
    """Shard ``s``'s diagonal block as a dense ``(rps, rps)`` float32
    matrix, unit diagonal where the block has none."""
    a = sa.local(s)
    rps = sa.rows_per_shard
    col = a.indices.long() - s * rps
    keep = (col >= 0) & (col < rps)
    block = torch.zeros((rps, rps), dtype=torch.float32, device=sa.device)
    block.index_put_((a.row_ids().long()[keep], col[keep]),
                     a.values.float()[keep], accumulate=True)
    diag = torch.diagonal(block)
    return block + torch.diag((diag == 0.0).float())


def build_block_jacobi(sa: ShardedCSR, mesh) -> torch.Tensor:
    """Factor every held diagonal block once: the stacked lower Cholesky
    factors ``(len(held), rps, rps)`` in the order of the ranks this
    process runs, for :func:`pcg_solve_sharded`'s ``lfac``."""
    with matmul_precision():
        return torch.stack([torch.linalg.cholesky(_local_diag_block(sa, s))
                            for s in mesh.axis(ROWS).local])


def pcg_solve_sharded(sa: ShardedCSR, b, mesh, iters: int = 50,
                      lfac: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``A x = b`` (SPD, row-sharded A) by ``iters`` block-Jacobi PCG
    steps. ``b`` replicated; returns the replicated ``x`` of length
    ``padded_rows`` (trim with ``unshard_rows``). Pass ``lfac`` from
    :func:`build_block_jacobi` to reuse the factors across solves."""
    if lfac is None:
        lfac = build_block_jacobi(sa, mesh)
    comm = mesh.axis(ROWS)
    prepare_local_spmv(sa, comm)
    return compiled(comm, sa, ("pcg", int(iters)),
                    functools.partial(_pcg_loop, sa, comm, int(iters)),
                    padded_rhs(sa, b), lfac)


def _pcg_loop(sa: ShardedCSR, comm, iters: int, b_full: torch.Tensor,
              lfac: torch.Tensor) -> torch.Tensor:
    rps = sa.rows_per_shard
    m = len(comm.local)

    def apply_m_inv(rs):
        zs = []
        for i, (s, r) in enumerate(zip(comm.local, rs)):
            r_loc = r[s * rps: (s + 1) * rps, None]
            y = torch.linalg.solve_triangular(lfac[i], r_loc, upper=False)
            zs.append(torch.linalg.solve_triangular(
                lfac[i].T, y, upper=True)[:, 0])
        return comm.all_gather(zs)

    with matmul_precision():
        rs = [b_full] * m
        zs = apply_m_inv(rs)
        xs = [torch.zeros_like(b_full)] * m
        rzs = [torch.dot(r, z) for r, z in zip(rs, zs)]
        ps = list(zs)
        for _ in range(iters):
            aps = gathered_matvec(sa, comm, ps)
            for i in range(m):
                alpha = rzs[i] / torch.dot(ps[i], aps[i]).clamp_min(1e-30)
                xs[i] = xs[i] + alpha * ps[i]
                rs[i] = rs[i] - alpha * aps[i]
            zs = apply_m_inv(rs)
            for i in range(m):
                rz_new = torch.dot(rs[i], zs[i])
                beta = rz_new / rzs[i].clamp_min(1e-30)
                ps[i] = zs[i] + beta * ps[i]
                rzs[i] = rz_new
    return xs[0]
