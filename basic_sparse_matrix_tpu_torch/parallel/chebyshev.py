"""Distributed Chebyshev semi-iteration: no reduction inside the loop.

Counterpart of ``basic_sparse_matrix_tpu/parallel/chebyshev.py``.
Chebyshev's scalars follow a fixed recurrence from the spectral bounds, so
x, r and d stay row-sharded end to end: one all-gather of d per step (the
matvec's operand), and one all-reduce after the loop for the residual
norm. The bounds come from the sharded Lanczos, ``(0.95·lo, 1.01·hi)``.

On the card the iterations and the residual are one CUDA graph per
``ShardedCSR``, mesh, ``iters`` and shape (``comm.compiled``), captured on
the first call; the bounds are a device operand, so new bounds replay the
same graph.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .cg import padded_rhs
from .comm import compiled
from .lanczos import eigen_values_lanczos_sharded
from .mesh import ROWS
from .sharded import ShardedCSR, held_rows
from .spmm import local_spmv, prepare_local_spmv


def chebyshev_sharded(sa: ShardedCSR, b_full: torch.Tensor, lam_min: float,
                      lam_max: float, iters: int, mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` steps from the replicated, padded ``b_full`` with bounds
    taken in float32; returns (the held rows of x, relative residual as a
    0-d tensor)."""
    comm = mesh.axis(ROWS)
    prepare_local_spmv(sa, comm)
    bounds = torch.tensor([lam_min, lam_max], dtype=torch.float32,
                          device=sa.device)
    return compiled(comm, sa, ("chebyshev", int(iters)),
                    functools.partial(_cheby_loop, sa, comm, int(iters)),
                    b_full, bounds)


def _cheby_loop(sa: ShardedCSR, comm, iters: int, b_full: torch.Tensor,
                bounds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    rps = sa.rows_per_shard
    lo, hi = bounds[0], bounds[1]
    theta = (hi + lo) / 2.0
    delta = ((hi - lo) / 2.0).clamp_min(1e-30)
    sigma1 = theta / delta
    b_locs = [b_full[s * rps: (s + 1) * rps] for s in comm.local]
    xs = [torch.zeros_like(b) for b in b_locs]
    rs = list(b_locs)
    ds = [b / theta for b in b_locs]
    rho = 1.0 / sigma1
    for _ in range(iters):
        d_full = comm.all_gather(ds)
        xs = [x + d for x, d in zip(xs, ds)]
        rs = [r - local_spmv(sa.local(s), df)
              for s, r, df in zip(comm.local, rs, d_full)]
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        ds = [rho_new * rho * d + (2.0 * rho_new / delta) * r
              for d, r in zip(ds, rs)]
        rho = rho_new
    (rr,) = comm.all_reduce([torch.dot(r, r) for r in rs])[:1]
    (bb,) = comm.all_reduce([torch.dot(b, b) for b in b_locs])[:1]
    res = torch.sqrt(rr) / torch.sqrt(bb).clamp_min(1e-30)
    return held_rows(xs, comm.local, rps), res


def chebyshev_solve_sharded(sa: ShardedCSR, b, mesh, *, iters: int = 100,
                            bounds: Optional[Tuple[float, float]] = None,
                            lanczos_k: int = 32, n: Optional[int] = None
                            ) -> Tuple[torch.Tensor, float]:
    """Solve SPD row-sharded ``A x = b`` by Chebyshev semi-iteration. ``b``
    replicated; returns (the held rows of x, of length ``padded_rows`` on a
    local mesh, and the final relative residual). ``bounds`` are estimated
    by the sharded Lanczos when omitted; a smallest Ritz value <= 0
    raises."""
    n = sa.rows if n is None else n
    if bounds is None:
        ritz = eigen_values_lanczos_sharded(sa, mesh, lanczos_k, n=n)
        lo, hi = float(ritz[0]), float(ritz[-1])
        if lo <= 0.0:
            raise ValueError(
                f"chebyshev needs SPD: smallest Ritz value {lo} <= 0")
        bounds = (0.95 * lo, 1.01 * hi)
    x, res = chebyshev_sharded(sa, padded_rhs(sa, b), bounds[0], bounds[1],
                               iters, mesh)
    return x, float(res)
