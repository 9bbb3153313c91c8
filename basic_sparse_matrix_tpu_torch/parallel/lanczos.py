"""Distributed Lanczos eigensolver over a row mesh.

Counterpart of ``basic_sparse_matrix_tpu/parallel/lanczos.py``. Per step
one local SpMV and one tiled all-gather (as ``parallel/cg.py``); the Krylov
basis is row-sharded, ``(k, rps)`` a rank, and the full
reorthogonalisation (classical Gram-Schmidt twice) runs as local
``(k, rps)`` products with one all-reduce of the k coefficients each time.
On breakdown (β <= 1e-7·max(|α|, 1)) β is stored as 0 and the basis
restarts from the JAX package's vector ``sin((i + 1)·(1 + j))`` in float32,
masked to the live rows (the partition's padding rows stay out of the
Krylov space) and re-projected. The k steps are a Python loop with nothing
read back to the host.

The start vector: the JAX package draws it from ``PRNGKey(seed)``, which
torch cannot reproduce. :func:`lanczos_sharded` draws it from a
``torch.Generator`` (``generator``, or one seeded with ``seed`` on the
mesh's device); :func:`lanczos_sharded_from` takes a given ``v0``, so the
two packages agree given the same vector.

On the card the k steps are one CUDA graph per ``ShardedCSR``, mesh, k,
``n``, matmul precision and start-vector shape (``comm.compiled``; the JAX
package's ``lax.scan`` under ``jax.jit``), captured on the second call as
the single-device Lanczos is; the Ritz values (``eigvalsh``) are computed
outside it.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from ..runtime import graphs
from ..utils.config import matmul_precision
from .cg import gathered_matvec
from .comm import compiled
from .mesh import ROWS
from .sharded import ShardedCSR
from .spmm import prepare_local_spmv

_EPS = 1e-7


def _reproject(comm, Vs: List[torch.Tensor], ws: List[torch.Tensor]
               ) -> List[torch.Tensor]:
    for _ in range(2):
        cs = comm.all_reduce([V @ w for V, w in zip(Vs, ws)])
        ws = [w - V.T @ c for V, w, c in zip(Vs, ws, cs)]
    return ws


def _norms(comm, ws: List[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.sqrt(q) for q in
            comm.all_reduce([torch.dot(w, w) for w in ws])]


def lanczos_sharded_from(sa: ShardedCSR, v0: torch.Tensor, k: int, mesh,
                         n: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k Lanczos steps from the replicated start vector ``v0`` (length
    ``padded_rows``); returns (alphas (k,), betas (k-1,))."""
    comm = mesh.axis(ROWS)
    n = sa.rows if n is None else n
    prepare_local_spmv(sa, comm)
    v0 = torch.as_tensor(v0, dtype=torch.float32, device=sa.device)
    return compiled(comm, sa, ("lanczos", int(k), int(n))
                    + graphs.host_state(),
                    functools.partial(_lanczos_steps, sa, comm, int(k),
                                      int(n)), v0, capture_on=2)


def _lanczos_steps(sa: ShardedCSR, comm, k: int, n: int, v0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    pr, rps = sa.padded_rows, sa.rows_per_shard
    dev = sa.device
    live = (torch.arange(pr, device=dev) < n).float()
    ramp = torch.arange(pr, dtype=torch.float32, device=dev) + 1.0
    m = len(comm.local)

    def mine(xs):
        return [x[s * rps: (s + 1) * rps] for s, x in zip(comm.local, xs)]

    with matmul_precision():
        v = v0 * live
        v = v / torch.linalg.norm(v).clamp_min(1e-30)
        vjs = [v] * m
        Vs = []
        for s in comm.local:
            V = torch.zeros((k, rps), dtype=torch.float32, device=dev)
            V[0] = v[s * rps: (s + 1) * rps]
            Vs.append(V)
        alphas, betas = [], []
        for j in range(k):
            ws = gathered_matvec(sa, comm, vjs)
            alpha = [torch.dot(vj, w) for vj, w in zip(vjs, ws)]
            w_locs = _reproject(comm, Vs, mine(ws))
            beta = _norms(comm, w_locs)
            broke = [b <= _EPS * a.abs().clamp_min(1.0)
                     for a, b in zip(alpha, beta)]
            fresh = ramp * float(1 + j)
            fresh = torch.sin(fresh) * live
            f_locs = _reproject(comm, Vs, mine([fresh] * m))
            f_locs = [f / q.clamp_min(1e-30)
                      for f, q in zip(f_locs, _norms(comm, f_locs))]
            v_next = [torch.where(br, f, w / b.clamp_min(1e-30))
                      for br, f, w, b in zip(broke, f_locs, w_locs, beta)]
            beta = [torch.where(br, 0.0, b) for br, b in zip(broke, beta)]
            if j + 1 < k:
                for V, x in zip(Vs, v_next):
                    V[j + 1] = x
            vjs = comm.all_gather(v_next)
            alphas.append(alpha[0])
            betas.append(beta[0])
    return torch.stack(alphas), torch.stack(betas)[:-1]


def lanczos_sharded(sa: ShardedCSR, mesh, k: int, *, n: Optional[int] = None,
                    seed: int = 0,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k Lanczos steps on a row-sharded symmetric matrix from a normal
    start vector drawn from ``generator`` (default: seeded with ``seed`` on
    the mesh's device). Returns (alphas (k,), betas (k-1,))."""
    n = sa.rows if n is None else n
    k = int(min(k, n))
    if generator is None:
        generator = torch.Generator(device=sa.device).manual_seed(seed)
    v0 = torch.randn(sa.padded_rows, generator=generator,
                     dtype=torch.float32, device=sa.device)
    return lanczos_sharded_from(sa, v0, k, mesh, n=n)


def ritz_values(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (ascending) of the tridiagonal ``(alphas, betas)``."""
    t = torch.diag(alphas)
    if alphas.shape[0] > 1:
        t = t + torch.diag(betas, 1) + torch.diag(betas, -1)
    return torch.linalg.eigvalsh(t)


def eigen_values_lanczos_sharded(sa: ShardedCSR, mesh, k: int = 32, *,
                                 n: Optional[int] = None, seed: int = 0,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """k Ritz values (ascending) of a row-sharded symmetric matrix:
    extremal values converge first; the exact spectrum at ``k == n``."""
    return ritz_values(*lanczos_sharded(sa, mesh, k, n=n, seed=seed,
                                        generator=generator))
