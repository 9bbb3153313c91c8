"""Interop: converters to and from PyTorch's own sparse tensors and scipy,
and the bridge that carries state across from the JAX package.

:func:`to_torch_sparse` and :func:`from_torch_sparse` are the port's
counterpart of the JAX package's ``to_bcoo``/``from_bcoo``: the ecosystem's
sparse type there is ``jax.experimental.sparse.BCOO``, here it is
``torch.sparse_csr_tensor`` / ``torch.sparse_coo_tensor``.

``csr_from_numpy``, ``bsr_from_numpy`` and ``stream_plan_from_numpy`` build
the port's :class:`CSR`, ``BSR`` and ``StreamPlan`` from the numpy arrays of
the JAX package's objects (``jax_csr.numpy()``, ``np.asarray(jax_bsr.blocks)``
and so on), so both packages can be fed the identical matrix and the
identical plan. ``banded_factor_from_numpy``, ``bcr_factor_from_numpy``,
``cholesky_schedule_from_numpy`` and ``pcg_setup_from_numpy`` do the same
for solver state (a JAX ``BandedFactor``, ``BCRFactor``,
``CholeskySchedule`` and the IC(0) factor of a JAX ``PCGSetup``), so a test
can feed the port's solve the JAX factor and tell a factor fault from a
solve fault. ``sharded_csr_from_numpy`` and ``block_jacobi_from_numpy``
carry the distributed layer's state: a JAX ``ShardedCSR``'s stacked arrays
and the stacked block-Jacobi factors of ``parallel.pcg.build_block_jacobi``,
each placed on a port mesh (the shards of the ranks the process runs).
Nothing here imports JAX: the caller hands over numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.shapes import DimLike
from .csr import CSR, to_tensor


def to_torch_sparse(a: CSR, layout: str = "csr") -> torch.Tensor:
    """CSR → a PyTorch sparse tensor on ``a``'s device, without going
    through dense: ``layout="csr"`` gives a ``torch.sparse_csr_tensor``
    over ``a``'s own arrays, ``"coo"`` a coalesced
    ``torch.sparse_coo_tensor`` (sorted, unique indices, as the JAX
    package's ``to_bcoo`` states of its BCOO)."""
    if layout == "csr":
        return torch.sparse_csr_tensor(a.indptr, a.indices, a.values,
                                       size=a.shape)
    if layout == "coo":
        idx = torch.stack([a.row_ids().long(), a.indices.long()])
        return torch.sparse_coo_tensor(idx, a.values, size=a.shape,
                                       is_coalesced=True)
    raise ValueError(f"layout must be 'csr' or 'coo', got {layout!r}")


def from_torch_sparse(m: torch.Tensor, device=None) -> CSR:
    """A PyTorch sparse tensor of any layout (2-D) → CSR on ``device``
    (default: the tensor's own). Host conversion; duplicates summed,
    explicit zeros kept, as the JAX package's ``from_bcoo``."""
    if m.layout == torch.strided or m.ndim != 2:
        raise ValueError(f"from_torch_sparse takes a 2-D sparse tensor, got "
                         f"layout {m.layout}, {m.ndim} dimensions")
    coo = m.to_sparse_coo().coalesce()
    rows, cols = coo.indices().cpu().numpy()
    return CSR.from_coo_arrays(
        tuple(m.shape), rows, cols, coo.values().cpu().numpy(),
        sum_duplicates=True, drop_zeros=False,
        device=m.device if device is None else device)


def csr_from_numpy(indptr, indices, values, shape: DimLike,
                   device=None) -> CSR:
    """The port's CSR from a host CSR triple (e.g. ``jax_csr.numpy()``),
    taken as it is: no re-sorting, merging or zero dropping."""
    return CSR.from_host(np.asarray(indptr), np.asarray(indices),
                         np.asarray(values), shape, device=device)


def bsr_from_numpy(blocks, block_rows, block_cols, rows: int, cols: int,
                   device=None):
    """The port's BSR from a JAX ``BSR``'s arrays."""
    from .pallas.spmm_kernel import make_bsr

    return make_bsr(np.asarray(blocks), np.asarray(block_rows),
                    np.asarray(block_cols), rows, cols, device=device)


def stream_plan_from_numpy(ii, kk, vv, *, rows: int, cols: int, tile_m: int,
                           tile_k: int, nnz: int, device=None):
    """The port's StreamPlan from a JAX ``StreamPlan``'s arrays (validated
    on the host, as every plan is)."""
    from .pallas.stream_kernel import make_stream_plan

    return make_stream_plan(np.asarray(ii), np.asarray(kk), np.asarray(vv),
                            rows=rows, cols=cols, tile_m=tile_m,
                            tile_k=tile_k, nnz=nnz, device=device)


def banded_factor_from_numpy(L, F, n: int, device=None):
    """The port's ``BandedFactor`` from a JAX ``BandedFactor``'s ``L``,
    ``F`` and ``n``."""
    from ..models.banded import BandedFactor

    return BandedFactor(L=to_tensor(np.asarray(L, np.float32), device),
                        F=to_tensor(np.asarray(F, np.float32), device), n=n)


def bcr_factor_from_numpy(ls, wls, wrs, elefts, erights, l0, n: int,
                          device=None):
    """The port's ``BCRFactor`` from a JAX ``BCRFactor``'s per-level tuples
    and final factor."""
    from ..models.bcr import BCRFactor

    def up(xs):
        return tuple(to_tensor(np.asarray(x, np.float32), device) for x in xs)
    return BCRFactor(ls=up(ls), wls=up(wls), wrs=up(wrs), elefts=up(elefts),
                     erights=up(erights),
                     l0=to_tensor(np.asarray(l0, np.float32), device), n=n)


def cholesky_schedule_from_numpy(a_src_pos, a_vals_idx, upd_dst, upd_a, upd_b,
                                 col_pos, l_col_ptr, l_row_idx, nnz_l: int,
                                 n: int, device=None):
    """The port's ragged ``CholeskySchedule`` from a JAX one's padded
    tables: entries equal to the scratch slot (``nnz_l``) are padding and
    are dropped; levels and the order inside each level are kept."""
    from ..models.sparse_cholesky import CholeskySchedule

    upd_dst, upd_a, upd_b = (np.asarray(x, np.int64)
                             for x in (upd_dst, upd_a, upd_b))
    col_pos = np.asarray(col_pos, np.int64)
    live = upd_dst != nnz_l                       # (nlev, max_upd)
    live_col = col_pos[:, :, 0] != nnz_l          # (nlev, max_cols)
    below = col_pos[:, :, 1:]
    live_off = (below != nnz_l) & live_col[:, :, None]
    slot = np.broadcast_to(np.arange(col_pos.shape[1])[None, :, None],
                           below.shape)

    def ptr(mask):
        return tuple(int(v) for v in np.concatenate(
            [[0], np.cumsum(mask.reshape(mask.shape[0], -1).sum(1))]))

    def up(x):
        return to_tensor(np.ascontiguousarray(x, dtype=np.int64), device)
    return CholeskySchedule(
        a_src_pos=up(a_src_pos), a_vals_idx=up(a_vals_idx),
        upd_dst=up(upd_dst[live]), upd_a=up(upd_a[live]),
        upd_b=up(upd_b[live]), col_diag=up(col_pos[:, :, 0][live_col]),
        col_off=up(below[live_off]), col_seg=up(slot[live_off]),
        upd_ptr=ptr(live), col_ptr=ptr(live_col), off_ptr=ptr(live_off),
        nnz_l=int(nnz_l), n=int(n), l_col_ptr=np.asarray(l_col_ptr),
        l_row_idx=np.asarray(l_row_idx))


def pcg_setup_from_numpy(a: CSR, l_indptr, l_indices, l_values):
    """The port's ``PCGSetup`` for ``a`` with a given IC(0) factor (the host
    CSR triple of the JAX package's factor: ``csc_to_csr_l(sched,
    factorize(sched, a.values)).numpy()``), on ``a``'s device."""
    from ..models.pcg import PCGSetup

    return PCGSetup.from_factor(a, csr_from_numpy(
        l_indptr, l_indices, l_values, (a.rows, a.rows), device=a.device))


def sharded_csr_from_numpy(indptr, indices, values, rows: int, cols: int,
                           rows_per_shard: int, mesh):
    """The port's ``ShardedCSR`` from a JAX one's stacked ``(S, rps + 1)``,
    ``(S, nnz_max)``, ``(S, nnz_max)`` arrays, taken as they are, placed
    on ``mesh``. A shard's true entry count is its pointer after the last
    live row; where every row is live that pointer is ``nnz_max``, and the
    padding (value 0, column 0, after the last row's sorted columns) is
    counted off the end."""
    from ..parallel.sharded import ShardedCSR, put_sharded

    host = (np.ascontiguousarray(indptr, dtype=np.int32),
            np.ascontiguousarray(indices, dtype=np.int32),
            np.ascontiguousarray(values))
    num, rps = host[0].shape[0], int(rows_per_shard)
    nnz = []
    for s in range(num):
        live = min(max(int(rows) - s * rps, 0), rps)
        end = int(host[0][s, live])
        if live == rps:
            start = int(host[0][s, live - 1])
            pad = (host[1][s, start:end] == 0) & (host[2][s, start:end] == 0)
            while end > start and pad[end - start - 1]:
                end -= 1
        nnz.append(end)
    full = ShardedCSR(indptr=to_tensor(host[0], "cpu"),
                      indices=to_tensor(host[1], "cpu"),
                      values=to_tensor(host[2], "cpu"), rows=int(rows),
                      cols=int(cols), rows_per_shard=rps, num_shards=num,
                      shards=tuple(range(num)), nnz=tuple(nnz), _host=host)
    return put_sharded(full, mesh)


def block_jacobi_from_numpy(lfac, mesh) -> torch.Tensor:
    """The port's stacked block-Jacobi factors (the ``lfac`` of
    ``parallel.pcg.pcg_solve_sharded``) from a JAX ``build_block_jacobi``
    result ``(S, rps, rps)``: the factors of the ranks ``mesh`` runs along
    ``"rows"``, on its device."""
    from ..parallel.mesh import ROWS

    lfac = np.asarray(lfac, dtype=np.float32)[mesh.axis(ROWS).local]
    return to_tensor(lfac, mesh.device)


def to_scipy(a: CSR):
    """CSR → ``scipy.sparse.csr_matrix`` (if scipy is available)."""
    from scipy import sparse as sp  # optional dependency

    indptr, indices, values = a.numpy()
    return sp.csr_matrix((values, indices, indptr), shape=a.shape)


def from_scipy(m, device=None) -> CSR:
    """Any scipy sparse matrix → CSR."""
    m = m.tocsr()
    rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
    return CSR.from_coo_arrays(
        m.shape, rows, m.indices, m.data,
        sum_duplicates=False, drop_zeros=False, device=device,
    )
