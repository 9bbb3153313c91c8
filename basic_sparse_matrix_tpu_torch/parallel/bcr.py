"""Distributed block cyclic reduction: a multi-rank banded direct solver.

Counterpart of ``basic_sparse_matrix_tpu/parallel/bcr.py``, distributing
:mod:`~..models.bcr` over the ``"rows"`` ranks. Block rows are contiguous
per rank. Each reduction level is a batched elimination on every rank's
blocks plus ONE boundary block per rank, the previous rank's last odd-block
state, brought by three non-cyclic ``shift(+1)`` per level (the open edge
receives zeros: no block before 0). After log2(m / ranks) local levels each
rank holds one block; the survivors are all-gathered and the last levels
run redundantly from them (``factor_bcr`` / ``solve_bcr``, padded to a
power of two for 3 or 6 ranks through ``_pad_pow2``). Back-substitution
mirrors it with one ``shift(-1)`` a level (no block after m - 1). Every
product runs under :func:`matmul_precision` (TF32 off). No refinement step
follows, as in the JAX package (the single-device ``BCRSolver`` adds one).

On the card :func:`bcr_solve_sharded` (factorization and solve together,
the JAX package's one jitted ``shard_map``) is one CUDA graph per mesh,
operand shapes and matmul precision (``comm.compiled``; one owner for the
module, keyed as ``jax.jit`` caches), captured on the second call.
:func:`bcr_solve_sharded_csr` blocks the matrix on the host at every call
and then replays that graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..models import bcr as _bcr
from ..models.banded import band_blocks, bandwidth, block_size_for
from ..models.cholesky import cholesky_dense
from ..ops.csr import CSR, to_tensor
from ..runtime import graphs
from ..utils.config import matmul_precision
from ..utils.errors import IncorrectDimensions, check
from .comm import compiled
from .mesh import ROWS


class _Programs:
    """The owner of the sharded BCR graphs (one for the module)."""


_BCR_SHARDED = _Programs()


def _shift_from_prev_rank(comm, xs):
    """Global ``x[k - 1]`` over rank-contiguous blocks: each rank's blocks
    shifted down one, the previous rank's last block first (zeros on rank
    0)."""
    recv = comm.shift([x[-1:] for x in xs], 1)
    return [torch.cat([p, x[:-1]]) for p, x in zip(recv, xs)]


def bcr_solve_sharded(D: torch.Tensor, E: torch.Tensor, b: torch.Tensor,
                      mesh) -> torch.Tensor:
    """Solve the block-tridiagonal SPD system whose blocks are row-sharded
    over ``"rows"``. ``D``/``E``/``b`` hold the blocks of the ranks this
    process runs (all ``m`` on a local mesh), consecutive: ``D``/``E``
    (m, nb, nb) with ``E[i]`` coupling block i+1 to block i and ``E[m-1] =
    0``, ``b`` (m, nb, k). ``m`` must be ranks·2^q. Returns the held
    (·, nb, k) blocks of the solution."""
    comm = mesh.axis(ROWS)
    ndev, held, rows = comm.size, len(comm.local), int(D.shape[0])
    m, per = rows * ndev // held, rows // held
    check(rows % held == 0 and per >= 1 and per & (per - 1) == 0,
          IncorrectDimensions,
          f"bcr_solve_sharded: m={m} must be ndev·2^q (ndev={ndev})")
    return compiled(comm, _BCR_SHARDED,
                    ("bcr_sharded",) + graphs.host_state(),
                    functools.partial(_bcr_levels, comm, per), D, E,
                    b.to(D.dtype), capture_on=2)


def _bcr_levels(comm, per: int, D: torch.Tensor, E: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    ndev = comm.size
    dls = list(D.split(per))
    els = list(E.split(per))
    bls = list(b.split(per))
    saved = []
    with matmul_precision():
        # local reduction: batched elimination + boundary shifts
        while int(dls[0].shape[0]) > 1:
            ls = [cholesky_dense(d[1::2]) for d in dls]
            wl = [_bcr._chol_solve(l, e[0::2]) for l, e in zip(ls, els)]
            wr = [_bcr._chol_solve(l, e[1::2].mT) for l, e in zip(ls, els)]
            z = [_bcr._chol_solve(l, x[1::2]) for l, x in zip(ls, bls)]
            er_prev = _shift_from_prev_rank(comm, [e[1::2] for e in els])
            wr_prev = _shift_from_prev_rank(comm, wr)
            z_prev = _shift_from_prev_rank(comm, z)
            elt = [e[0::2].mT for e in els]
            dls = [d[0::2] - _bcr._mm(erp, wrp) - _bcr._mm(et, w)
                   for d, erp, wrp, et, w in zip(dls, er_prev, wr_prev, elt,
                                                 wl)]
            bls = [x[0::2] - _bcr._mm(erp, zp) - _bcr._mm(et, zz)
                   for x, erp, zp, et, zz in zip(bls, er_prev, z_prev, elt,
                                                 z)]
            # E'_k = -E_{2k+1}·Wl_k; the last global coupling stays zero
            els = [-_bcr._mm(e[1::2], w) for e, w in zip(els, wl)]
            saved.append((wl, wr, z))
        # cross-rank tail: the survivors gathered, finished redundantly
        # (once per process: the gathered tensors are replicated)
        dg, eg, bg = (comm.all_gather(xs)[0] for xs in (dls, els, bls))
        fac = _bcr.factor_bcr(*_bcr._pad_pow2(dg, eg))
        bg = F.pad(bg, (0, 0, 0, 0, 0, fac.m_padded - ndev))
        xg = _bcr.solve_bcr(fac, bg)
        xs = [xg[r: r + 1] for r in comm.local]
        # local back-substitution with the opposite boundary
        for wl, wr, z in reversed(saved):
            nxt = comm.shift([x[:1] for x in xs], -1)
            xs = [torch.stack([x, zz - _bcr._mm(w, x) - _bcr._mm(
                      v, torch.cat([x[1:], n]))], dim=1).reshape(
                      2 * x.shape[0], *x.shape[1:])
                  for x, n, w, v, zz in zip(xs, nxt, wl, wr, z)]
    return torch.cat(xs)


def padded_band_blocks(a: CSR, ndev: int, nb: int | None = None):
    """The diagonal and coupling blocks ``(D, E)`` of a banded CSR (host
    numpy), its block rows padded to ``ndev``·2^q with identity blocks and
    zero couplings: :func:`bcr_solve_sharded`'s operands for ``ndev``
    ranks."""
    if nb is None:
        nb = block_size_for(bandwidth(a), a.rows)
    D, E = band_blocks(a, nb)
    m = D.shape[0]
    mp = ndev
    while mp < m:
        mp *= 2
    if mp != m:
        pad = np.zeros((mp - m, nb, nb), dtype=D.dtype)
        pad[:, np.arange(nb), np.arange(nb)] = 1.0
        D = np.concatenate([D, pad])
    E = np.concatenate([E, np.zeros((mp - E.shape[0], nb, nb), D.dtype)])
    return D, E


def bcr_solve_sharded_csr(a: CSR, b, mesh, nb: int | None = None
                          ) -> torch.Tensor:
    """Block a banded SPD CSR (host), pad its block rows to ranks·2^q with
    identity blocks, place each rank's blocks on the mesh's device and
    solve. Returns the whole (n, k) solution (or (n,) for a vector ``b``)
    on every process."""
    comm = mesh.axis(ROWS)
    ndev = comm.size
    D, E = padded_band_blocks(a, ndev, nb)
    mp, nb = D.shape[0], D.shape[1]
    b = torch.as_tensor(b).to(device=mesh.device, dtype=torch.float32)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    check(b.shape[0] == a.rows, IncorrectDimensions,
          f"bcr_solve_sharded: A n={a.rows} vs b {tuple(b.shape)}")
    bb = F.pad(b, (0, 0, 0, mp * nb - a.rows)).reshape(mp, nb, b.shape[1])
    per = mp // ndev
    lo, hi = comm.local[0] * per, (comm.local[-1] + 1) * per
    x = bcr_solve_sharded(to_tensor(D[lo:hi], mesh.device),
                          to_tensor(E[lo:hi], mesh.device), bb[lo:hi], mesh)
    if len(comm.local) < ndev:
        (x,) = comm.all_gather([x])
    x = x.reshape(mp * nb, -1)[: a.rows]
    return x[:, 0] if squeeze else x
