"""Distributed SpMM / SpMV over a mesh.

Counterpart of ``basic_sparse_matrix_tpu/parallel/spmm.py``, in the
bulk-synchronous form of ``parallel/comm.py``: each step maps over the
ranks this process runs, each collective takes and returns one tensor per
rank.

* :func:`spmv_sharded` / :func:`spmm_sharded`: A row-sharded, operand
  replicated; no communication.
* :func:`spmm_allgather`: B stored K-sharded; one tiled all-gather
  assembles it, then the local product.
* :func:`spmm_ring`: B K-sharded; the panels rotate around the ring while
  each rank multiplies the panel it holds. JAX masks, at every step, the
  entries whose column lies outside the panel in flight; the port instead
  builds once each shard's column block per panel owner
  (:meth:`ShardedCSR.col_block`: S × S sub-CSRs with panel-local column
  ids) and multiplies, at step ``t``, the block of the owner ``(me + t) %
  S``. The same sum, without the masked work.
* :func:`spmm_sharded_ell`: an ELL operand's rows sharded, RHS
  replicated.

The local product: on the CPU the plain gather + ``index_add_`` (the JAX
package's gather + ``segment_sum``, ``ops/spmm.py::spmm``); on the card the
port's ``spmm_auto`` on the shard's CSR, so a shard takes the rung one
device would give it (at 1M × 1M with 32 entries a row, every shard and
every ring block the streaming rung, K2). The local SpMV of the solvers is
the ELL gather + row reduce where the padding overhead permits (as the
port's single-device PCG and Lanczos), else the gather/segment sum: no
atomics, so a rank's product is the same bits on every run.

Results are row-sharded: a function returns the rows this process holds
(``sharded.held_rows``), which on a local mesh is the whole padded
``(padded_rows, n)`` array, as JAX's global array; trim it with
``unshard_rows``.

The ring (the JAX package's ``jax.jit(jax.shard_map(fori_loop))``) runs op
by op on the card, unlike ``parallel/``'s other loops: a CUDA graph of it
must copy B into its static buffers and clone the (rows, n) result, and at
1M × 512 that costs more than the launches it saves (``PERF.md`` §5, phase
24(f) of ``chip_smoke.py``, which times such a graph beside the eager
call).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..ops.csr import CSR
from ..ops.ell import ELL, cached_ell, ell_overhead, spmm_ell, spmv_ell
from ..ops.spmm import spmm, spmm_auto, spmv
from ..utils.config import get_config
from .mesh import ROWS
from .sharded import ShardedCSR, held_rows


def local_spmm(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """One rank's SpMM: ``spmm_auto`` on the card, the plain gather +
    ``index_add_`` on the CPU."""
    return spmm_auto(a, b) if b.is_cuda else spmm(a, b)


def _spmv_ell(a: CSR) -> bool:
    return bool(a.stored) and ell_overhead(a) <= get_config().ell_max_overhead


def local_spmv(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """One rank's SpMV: ELL gather + row reduce where the padding overhead
    permits, else the gather/segment sum."""
    if _spmv_ell(a):
        return spmv_ell(cached_ell(a), x)
    return spmv(a, x)


def prepare_local_spmv(sa: ShardedCSR, comm) -> None:
    """Build, once, what :func:`local_spmv` reads for each held shard: its
    CSR and, where taken, its ELL layout. Both are host work and uploads,
    which a graph's warm-up refuses, so a compiled loop calls this
    first."""
    for s in comm.local:
        a = sa.local(s)
        if _spmv_ell(a):
            cached_ell(a)


def _on(x, sa: ShardedCSR) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=sa.device)


def spmv_sharded(sa: ShardedCSR, x, mesh) -> torch.Tensor:
    """Row-sharded SpMV with a replicated operand vector; the held rows of
    the ``padded_rows`` result (trim with ``unshard_rows``)."""
    x = _on(x, sa)
    comm = mesh.axis(ROWS)
    return held_rows([local_spmv(sa.local(s), x) for s in comm.local],
                     comm.local, sa.rows_per_shard)


def spmm_sharded(sa: ShardedCSR, b, mesh) -> torch.Tensor:
    """Row-sharded SpMM with a replicated dense RHS."""
    b = _on(b, sa)
    comm = mesh.axis(ROWS)
    return held_rows([local_spmm(sa.local(s), b) for s in comm.local],
                     comm.local, sa.rows_per_shard)


def _pad_k(b: torch.Tensor, num_shards: int) -> torch.Tensor:
    """``b`` with zero rows appended up to a multiple of ``num_shards``
    (no copy when it already is one)."""
    k = b.shape[0]
    pad = -(-k // num_shards) * num_shards - k
    if not pad:
        return b
    return F.pad(b, (0, 0) * (b.ndim - 1) + (0, pad))


def _panels(sa: ShardedCSR, b, comm) -> List[torch.Tensor]:
    """The K panels of ``b`` held by this process's ranks (views)."""
    b_padded = _pad_k(_on(b, sa), comm.size)
    kps = b_padded.shape[0] // comm.size
    return [b_padded[s * kps: (s + 1) * kps] for s in comm.local]


def spmm_allgather(sa: ShardedCSR, b, mesh) -> torch.Tensor:
    """B stored K-sharded; one tiled all-gather re-assembles the panels
    (one tensor for every rank of a local mesh), then the local SpMM."""
    comm = mesh.axis(ROWS)
    fulls = comm.all_gather(_panels(sa, b, comm))
    return held_rows([local_spmm(sa.local(s), full[: sa.cols])
                      for s, full in zip(comm.local, fulls)],
                     comm.local, sa.rows_per_shard)


def ring_products(sa: ShardedCSR, panels: List[torch.Tensor], comm
                  ) -> List[torch.Tensor]:
    """The ring of :func:`spmm_ring` over ``panels`` (this process's
    ranks' K panels): ``num`` steps; at step ``t`` rank ``me`` holds the
    panel of owner ``(me + t) % num``, multiplies its column block of that
    owner and passes the panel to rank ``me - 1``. Returns each held rank's
    ``(rows_per_shard, n)`` sum, accumulated in step order."""
    num = comm.size
    kps = int(panels[0].shape[0])
    accs = [None] * len(panels)
    for t in range(num):
        for i, (me, panel) in enumerate(zip(comm.local, panels)):
            part = local_spmm(sa.col_block(me, (me + t) % num, kps), panel)
            accs[i] = part if accs[i] is None else accs[i] + part
        if t + 1 < num:
            panels = comm.ring_shift(panels)
    return accs


def spmm_ring(sa: ShardedCSR, b, mesh) -> torch.Tensor:
    """B K-sharded; the panels rotate around a ring while each rank
    multiplies the local column block of the panel it holds. Memory: one
    panel a rank."""
    comm = mesh.axis(ROWS)
    return held_rows(ring_products(sa, _panels(sa, b, comm), comm),
                     comm.local, sa.rows_per_shard)


def spmm_sharded_ell(ell, b, mesh) -> torch.Tensor:
    """Row-sharded SpMM over an ELL operand with a replicated RHS: the
    rectangular ``(rows, width)`` arrays split over ``"rows"`` (rows padded
    up to a multiple of the axis); the held rows of the ``(padded rows,
    n_rhs)`` product."""
    comm = mesh.axis(ROWS)
    num = comm.size
    rows = ell.n_rows
    rps = -(-rows // num)
    b = torch.as_tensor(b, device=ell.vals.device)
    blocks = []
    for s in comm.local:
        part = ELL(cols=ell.cols[s * rps: (s + 1) * rps],
                   vals=ell.vals[s * rps: (s + 1) * rps], n_cols=ell.n_cols,
                   _cols_ok=ell._cols_ok)
        out = spmm_ell(part, b)
        blocks.append(F.pad(out, (0, 0, 0, rps - out.shape[0])))
    return held_rows(blocks, comm.local, rps)
