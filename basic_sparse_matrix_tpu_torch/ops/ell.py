"""ELL (padded-row) sparse format — the hypersparse SpMM path.

Counterpart of ``basic_sparse_matrix_tpu/ops/ell.py``. Every row is padded
to the longest row's length (padding slots ``col = 0, val = 0``), which
turns SpMM into gather + per-row reduce with no scatter.

The JAX package has four formulations of that one function
(``_spmm_ell_direct``, ``_spmm_ell_unrolled``, ``_spmm_ell_barriered``,
``_spmm_ell_chunked``) that steer XLA's fusion on the TPU. The port has one:
gather + reduce over row chunks bounded like ``_chunk_rows``. Config
``ell_gather_bf16`` (a bf16 gather inside the barriered formulation) is
accepted and has no effect: the port always gathers in the operand's dtype.

``spmm_ell_from_csr`` routes wide-RHS float32 operands on a CUDA device to
the streaming kernel (``ops/pallas/stream_kernel.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.config import get_config
from .csr import CSR, compute_dtype, to_tensor
from .pallas.stream_kernel import spmm_stream, stream_plan_from_ell

# The gathered intermediate of one chunk is (chunk, width, n_rhs); chunks
# keep it under this many bytes.
INTERMEDIATE_BUDGET_BYTES = 1 << 30


@dataclasses.dataclass(eq=False)
class ELL:
    """Padded row-major sparse layout: ``cols[r, k]``/``vals[r, k]`` hold the
    k-th stored entry of row r; padding slots have ``col = 0, val = 0``.
    ``_host_cols``/``_host_vals`` are the numpy mirrors the plan builders
    read."""

    cols: torch.Tensor   # (rows, width) int32
    vals: torch.Tensor   # (rows, width)
    n_cols: int
    _host_cols: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    _host_vals: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    _stream_plans: Dict[Tuple[int, int], object] = dataclasses.field(
        default_factory=dict, init=False, repr=False)

    @property
    def n_rows(self) -> int:
        return int(self.cols.shape[0])

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])


def csr_to_ell(a: CSR) -> ELL:
    """Host-side CSR → ELL conversion (O(nnz) numpy), on ``a``'s device."""
    indptr, indices, values = a.numpy()
    lens = np.diff(indptr)
    width = max(int(lens.max()) if a.rows else 0, 1)
    cols = np.zeros((a.rows, width), dtype=np.int32)
    vals = np.zeros((a.rows, width), dtype=values.dtype)
    rows = np.repeat(np.arange(a.rows), lens)
    offs = np.arange(a.stored) - np.repeat(indptr[:-1], lens)
    cols[rows, offs] = indices
    vals[rows, offs] = values
    return ELL(cols=to_tensor(cols, a.device), vals=to_tensor(vals, a.device),
               n_cols=a.cols, _host_cols=cols, _host_vals=vals)


def _chunk_rows(ell: ELL, n_rhs: int) -> int:
    per_row = ell.width * n_rhs * 4
    return max(1, INTERMEDIATE_BUDGET_BYTES // max(per_row, 1))


def spmm_ell(ell: ELL, b: torch.Tensor) -> torch.Tensor:
    """``out[r] = Σ_k vals[r,k]·B[cols[r,k]]`` by gather + per-row reduce,
    in row chunks. Padding slots contribute ``0 · B[0]``. The result has
    ``b``'s dtype."""
    cdt = compute_dtype(b.dtype)
    bc = b.to(cdt)
    n = int(b.shape[1])
    out = torch.empty((ell.n_rows, n), dtype=cdt, device=b.device)
    chunk = _chunk_rows(ell, n)
    for r0 in range(0, ell.n_rows, chunk):
        cols = ell.cols[r0: r0 + chunk]
        vals = ell.vals[r0: r0 + chunk].to(cdt)
        g = bc.index_select(0, cols.reshape(-1)).view(*cols.shape, n)
        out[r0: r0 + chunk] = (vals.unsqueeze(-1) * g).sum(1, dtype=cdt)
    return out.to(b.dtype)


def spmv_ell(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """SpMV over ELL: one gathered product + row reduce."""
    cdt = compute_dtype(x.dtype)
    prod = ell.vals.to(cdt) * x.to(cdt)[ell.cols.long()]
    return prod.sum(1, dtype=cdt).to(x.dtype)


def ell_overhead(a: CSR) -> float:
    """Padding overhead factor: stored slots after padding / true stored."""
    indptr, _, _ = a.numpy()
    lens = np.diff(indptr)
    width = max(int(lens.max()) if a.rows else 0, 1)
    return a.rows * width / max(a.stored, 1)


def cached_ell(a: CSR) -> ELL:
    """``a``'s ELL layout, converted once and memoised on ``a``."""
    if a._ell_cache is None:
        a._ell_cache = csr_to_ell(a)
    return a._ell_cache


def spmm_ell_from_csr(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """CSR entry point with memoised ELL conversion. With config
    ``ell_stream="on"``, a float32 RHS on a CUDA device with at least 128
    columns against a float32 matrix of at least 2**18 stored entries goes
    to the streaming kernel; the plan is memoised on the ELL."""
    ell = cached_ell(a)
    cfg = get_config()
    if (cfg.ell_stream == "on"
            and b.is_cuda
            and b.dtype == torch.float32
            and ell.vals.dtype == torch.float32
            and b.shape[1] >= 128
            and a.stored >= (1 << 18)):
        plan = stream_plan_from_ell(ell, int(b.shape[1]))
        if plan is not None:
            return spmm_stream(plan, b)
    return spmm_ell(ell, b)
