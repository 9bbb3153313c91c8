"""Interop: scipy converters and the bridge that carries state across from
the JAX package.

``csr_from_numpy``, ``bsr_from_numpy`` and ``stream_plan_from_numpy`` build
the port's :class:`CSR`, ``BSR`` and ``StreamPlan`` from the numpy arrays of
the JAX package's objects (``jax_csr.numpy()``, ``np.asarray(jax_bsr.blocks)``
and so on), so both packages can be fed the identical matrix and the
identical plan. Nothing here imports JAX: the caller hands over numpy.
"""

from __future__ import annotations

import numpy as np

from ..utils.shapes import DimLike
from .csr import CSR


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
