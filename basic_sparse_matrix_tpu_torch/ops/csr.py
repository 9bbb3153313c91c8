"""CSR matrix on an explicit torch device — the core storage type.

Counterpart of ``basic_sparse_matrix_tpu/ops/csr.py``. A :class:`CSR` holds
three tensors (``indptr`` (rows+1,) int32, ``indices`` (nnz,) int32,
``values`` (nnz,)) on one device, plus static ``rows``/``cols``. Host
constructors build the arrays in numpy (sorted row-major, duplicates summed,
explicit zeros dropped, exactly as the JAX package does) and keep that numpy
triple as ``_host``, so format conversions (BSR, ELL, streaming plans) never
copy device → host.

The format memos of the JAX package (``_dense_cache``, ``_bsr_cache``,
``_ell_cache``) are plain attributes here, joined by ``_bsr_fill``, the
block fill the BSR dispatch test computed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.errors import IncorrectDimensions, OutOfBounds, check
from ..utils.shapes import DimLike, MatDim


# JAX runs with 64-bit types off, so its device arrays hold these 64-bit
# host dtypes in 32 bits; the port stores the same dtypes.
_X64_TO_32 = {
    np.dtype(np.float64): np.float32,
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
    np.dtype(np.complex128): np.complex64,
}


def canonical(arr: np.ndarray) -> np.ndarray:
    """``arr`` in the dtype JAX would store it in (64-bit types → 32)."""
    arr = np.asarray(arr)
    return arr.astype(_X64_TO_32.get(arr.dtype, arr.dtype), copy=False)


def to_tensor(arr: np.ndarray, device=None) -> torch.Tensor:
    """numpy → tensor on ``device``. A CPU tensor gets its own copy, so
    the host mirror and the tensor never alias."""
    arr = np.ascontiguousarray(arr)
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cpu" or not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t if dev.type == "cpu" else t.to(dev)


@dataclasses.dataclass(eq=False)
class CSR:
    """CSR sparse matrix: ``indptr`` (rows+1, int32), ``indices`` (nnz,
    int32), ``values`` (nnz, dtype), all on one device."""

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    rows: int
    cols: int
    _host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, repr=False)
    _dense_cache: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False)
    _bsr_cache: object = dataclasses.field(
        default=None, init=False, repr=False)
    _ell_cache: object = dataclasses.field(
        default=None, init=False, repr=False)
    # Block fill bsr_profitable computed for this matrix (host work that
    # grows with nnz, so it is done once).
    _bsr_fill: Optional[float] = dataclasses.field(
        default=None, init=False, repr=False)

    # ------------------------------------------------------------------ #
    # Static metadata
    # ------------------------------------------------------------------ #
    @property
    def dims(self) -> MatDim:
        return MatDim(self.rows, self.cols)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def stored(self) -> int:
        """Number of stored entries."""
        return int(self.values.shape[0])

    def get_nnz(self) -> int:
        return self.stored

    def get_density(self) -> float:
        return self.stored / float(self.rows * self.cols)

    # ------------------------------------------------------------------ #
    # Host constructors (numpy; exact nnz, zeros dropped, sorted row-major)
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_coo_arrays(
        dims: DimLike,
        row_ids: np.ndarray,
        col_ids: np.ndarray,
        vals: np.ndarray,
        *,
        sum_duplicates: bool = True,
        drop_zeros: bool = True,
        dtype=None,
        device=None,
    ) -> "CSR":
        """COO → CSR on the host: lexsort by (row, col), optionally merge
        duplicates and drop zeros, then move the arrays to ``device``."""
        d = MatDim.of(dims)
        row_ids = np.asarray(row_ids, dtype=np.int64)
        col_ids = np.asarray(col_ids, dtype=np.int64)
        vals = np.asarray(vals, dtype=dtype)
        if row_ids.size:
            check(
                bool((row_ids >= 0).all() and (row_ids < d.rows).all()),
                OutOfBounds,
                "row index out of bounds",
            )
            check(
                bool((col_ids >= 0).all() and (col_ids < d.cols).all()),
                OutOfBounds,
                "col index out of bounds",
            )
        order = np.lexsort((col_ids, row_ids))
        row_ids, col_ids, vals = row_ids[order], col_ids[order], vals[order]
        if sum_duplicates and row_ids.size:
            keys = row_ids * d.cols + col_ids
            uniq, inv = np.unique(keys, return_inverse=True)
            merged = np.zeros(uniq.shape[0], dtype=vals.dtype)
            np.add.at(merged, inv, vals)
            row_ids, col_ids, vals = uniq // d.cols, uniq % d.cols, merged
        if drop_zeros and row_ids.size:
            keep = vals != 0
            row_ids, col_ids, vals = row_ids[keep], col_ids[keep], vals[keep]
        indptr = np.zeros(d.rows + 1, dtype=np.int32)
        np.add.at(indptr[1:], row_ids, 1)
        indptr = np.cumsum(indptr, dtype=np.int32)
        indices = col_ids.astype(np.int32)
        return CSR.from_host(indptr, indices, vals, d, device=device)

    @staticmethod
    def from_host(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
                  dims: DimLike, device=None) -> "CSR":
        """Wrap an already-normalised host CSR triple (int32 ``indptr`` of
        length rows+1, int32 ``indices``) and keep it as the host mirror."""
        d = MatDim.of(dims)
        indptr = np.ascontiguousarray(indptr, dtype=np.int32)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        values = np.ascontiguousarray(canonical(values))
        check(indptr.shape == (d.rows + 1,)
              and indices.shape == values.shape
              and int(indptr[-1]) == indices.shape[0],
              IncorrectDimensions, f"inconsistent CSR arrays for {d}")
        return CSR(
            indptr=to_tensor(indptr, device),
            indices=to_tensor(indices, device),
            values=to_tensor(values, device),
            rows=d.rows,
            cols=d.cols,
            _host=(indptr, indices, values),
        )

    @staticmethod
    def from_dense(arr, *, drop_zeros: bool = True, device=None) -> "CSR":
        """Build from a dense array (numpy or tensor), dropping explicit
        zeros — the value-level equivalent of reference ``from_data``."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr)
        check(a.ndim == 2, IncorrectDimensions, "from_dense requires 2D data")
        rows, cols = np.nonzero(a) if drop_zeros else np.unravel_index(
            np.arange(a.size), a.shape
        )
        return CSR.from_coo_arrays(
            a.shape, rows, cols, a[rows, cols], sum_duplicates=False,
            drop_zeros=False, dtype=a.dtype, device=device,
        )

    from_data = from_dense

    @staticmethod
    def eye(dims: DimLike, value=1.0, dtype=None, device=None) -> "CSR":
        """Identity scaled by ``value`` (non-square raises)."""
        d = MatDim.of(dims)
        check(d.rows == d.cols, IncorrectDimensions, "eye requires square dims")
        n = d.rows
        vals = np.full(n, value, dtype=dtype)
        return CSR.from_coo_arrays(d, np.arange(n), np.arange(n), vals,
                                   sum_duplicates=False, device=device)

    @staticmethod
    def empty(dims: DimLike, dtype=np.float32, device=None) -> "CSR":
        d = MatDim.of(dims)
        return CSR.from_host(np.zeros(d.rows + 1, np.int32),
                             np.zeros(0, np.int32), np.zeros(0, dtype), d,
                             device=device)

    # ------------------------------------------------------------------ #
    # Densify / host views
    # ------------------------------------------------------------------ #
    def todense(self) -> torch.Tensor:
        """Scatter stored entries into a dense tensor (duplicates sum).
        Guarded, as in the JAX package, against shapes whose flat index
        would overflow int32."""
        check(self.rows * self.cols < 2**31, IncorrectDimensions,
              f"todense of {self.dims} would overflow int32 flat indexing")
        cdt = compute_dtype(self.dtype)
        flat = torch.zeros(self.rows * self.cols, dtype=cdt,
                           device=self.device)
        pos = self.row_ids().long() * self.cols + self.indices.long()
        flat.index_add_(0, pos, self.values.to(cdt))
        return flat.reshape(self.rows, self.cols).to(self.dtype)

    def row_ids(self) -> torch.Tensor:
        """Expand ``indptr`` into a per-entry int32 row id vector (nnz,)."""
        return torch.repeat_interleave(
            torch.arange(self.rows, dtype=torch.int32, device=self.device),
            torch.diff(self.indptr).long(),
            output_size=self.stored,
        )

    def numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._host is None:
            self._host = (
                self.indptr.cpu().numpy(),
                self.indices.cpu().numpy(),
                self.values.cpu().numpy(),
            )
        return self._host

    def compacted(self) -> "CSR":
        """Host-side re-normalisation: merge duplicate coordinates and drop
        explicit zeros."""
        indptr, indices, values = self.numpy()
        rows = np.repeat(np.arange(self.rows), np.diff(indptr))
        return CSR.from_coo_arrays(self.dims, rows, indices, values,
                                   device=self.device)

    # ------------------------------------------------------------------ #
    def __matmul__(self, other):
        """``A @ B`` for a dense right-hand side: a vector goes to ``spmv``,
        a matrix to the gather/segment ``spmm``, as in the JAX package."""
        from .spmm import spmm, spmv

        if not isinstance(other, torch.Tensor):
            other = torch.as_tensor(np.asarray(other), device=self.device)
        if other.ndim == 1:
            return spmv(self, other)
        return spmm(self, other)

    def __repr__(self) -> str:
        return (
            f"CSR(dims: {self.dims}, stored: {self.stored}, "
            f"dtype: {self.dtype}, device: {self.device})"
        )


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Dtype in which sums of ``dtype`` values are taken. PyTorch has no
    add for the unsigned types above uint8, so they accumulate in int64 and
    are cast back, which wraps modulo 2**bits as JAX's uint32 does."""
    if dtype in (torch.uint16, torch.uint32, torch.uint64):
        return torch.int64
    return dtype
