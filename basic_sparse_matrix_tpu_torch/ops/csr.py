"""CSR matrix on one torch device — the core storage type.

Counterpart of ``basic_sparse_matrix_tpu/ops/csr.py``. A :class:`CSR` holds
three tensors (``indptr`` (rows+1,) int32, ``indices`` (nnz,) int32,
``values`` (nnz,)) on one device, plus static ``rows``/``cols``. Host
constructors build the arrays in numpy (sorted row-major, duplicates summed,
explicit zeros dropped, exactly as the JAX package does) and keep that numpy
triple as ``_host``, so format conversions (BSR, ELL, streaming plans) never
copy device → host.

The format memos of the JAX package (``_dense_cache``, ``_bsr_cache``,
``_ell_cache``) are plain attributes here, joined by ``_bsr_fill``, the
block fill the BSR dispatch test computed, ``_ell_overhead``, the ELL
padding factor the dispatch reads, and ``_split_cache``, the layout of the
card's skewed-row rung.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.config import default_device
from ..utils.errors import (
    IncorrectDimensions,
    OutOfBounds,
    PaddingSizeSmallerThanOriginal,
    check,
)
from ..utils.shapes import DimLike, MatDim


class CsrEntry(NamedTuple):
    """One stored entry, as yielded by iteration (reference ``CsrEntry``)."""

    v: object
    row_index: int
    col_index: int


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
    """numpy → tensor on ``device`` (``None``: the configured default
    device, the card). A CPU tensor gets its own copy, so the host mirror
    and the tensor never alias."""
    arr = np.ascontiguousarray(arr)
    dev = default_device(device)
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
    # The ELL overhead that ell_overhead computed, and the split layout of
    # the skewed-row rung (ops/split.py), each made once.
    _ell_overhead: Optional[float] = dataclasses.field(
        default=None, init=False, repr=False)
    _split_cache: object = dataclasses.field(
        default=None, init=False, repr=False)
    # Memoised symbolic plans of ops.elementwise (add/sub) and ops.spgemm,
    # lists of (weakref to the right operand, plan), at most four each.
    _merge_plans: Optional[list] = dataclasses.field(
        default=None, init=False, repr=False)
    _spgemm_plans: Optional[list] = dataclasses.field(
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

    def count_nonzero(self) -> int:
        """Actual nonzero count (host-side; differs from :meth:`get_nnz`
        only after capacity-padded ops)."""
        return int(np.count_nonzero(self.numpy()[2]))

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
    def create_diagonal(contents: Sequence, device=None) -> "CSR":
        """Diagonal matrix; zero entries dropped (reference
        ``create_diagonal``)."""
        if isinstance(contents, torch.Tensor):
            contents = contents.detach().cpu().numpy()
        v = np.asarray(contents)
        n = v.shape[0]
        return CSR.from_coo_arrays((n, n), np.arange(n), np.arange(n), v,
                                   device=device)

    @staticmethod
    def empty(dims: DimLike, dtype=np.float32, device=None) -> "CSR":
        d = MatDim.of(dims)
        return CSR.from_host(np.zeros(d.rows + 1, np.int32),
                             np.zeros(0, np.int32),
                             np.zeros(0, numpy_dtype(dtype)), d,
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
    # Accessors (host-side, from the numpy mirror; reference
    # ``get_val_at`` .. ``add_padding``). New matrices land on this
    # matrix's device.
    # ------------------------------------------------------------------ #
    def _host_rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.rows), np.diff(self.numpy()[0]))

    def get_val_at(self, at: DimLike):
        """Value at (row, col) or ``None``; duplicates of the coordinate
        are summed."""
        d = MatDim.of(at)
        indptr, indices, values = self.numpy()
        lo, hi = int(indptr[d.rows]), int(indptr[d.rows + 1])
        hit = np.nonzero(indices[lo:hi] == d.cols)[0]
        if hit.size == 0:
            return None
        return values[lo:hi][hit].sum() if hit.size > 1 else values[lo + hit[0]]

    def with_val_at(self, at: DimLike, value) -> "CSR":
        """Functional update of one coordinate: an existing entry is
        replaced, a new coordinate is inserted (host-side rebuild)."""
        d = MatDim.of(at)
        check(0 <= d.rows < self.rows and 0 <= d.cols < self.cols,
              OutOfBounds, f"({d.rows},{d.cols}) outside {self.dims}")
        indptr, indices, values = self.numpy()
        lo, hi = int(indptr[d.rows]), int(indptr[d.rows + 1])
        hit = np.nonzero(indices[lo:hi] == d.cols)[0]
        rows = self._host_rows()
        if hit.size:
            new_vals = values.copy()
            new_vals[lo + hit[0]] = value
            return CSR.from_coo_arrays(
                self.dims, rows, indices, new_vals, sum_duplicates=False,
                drop_zeros=False, device=self.device)
        return CSR.from_coo_arrays(
            self.dims,
            np.concatenate([rows, [d.rows]]),
            np.concatenate([indices, [d.cols]]),
            np.concatenate([values, [value]]),
            sum_duplicates=False, drop_zeros=False, device=self.device)

    def get_row_compact(self, index: int) -> List[CsrEntry]:
        """Stored entries of one row."""
        indptr, indices, values = self.numpy()
        lo, hi = int(indptr[index]), int(indptr[index + 1])
        return [
            CsrEntry(values[k], index, int(indices[k])) for k in range(lo, hi)
        ]

    def get_row_complete(self, index: int) -> np.ndarray:
        """Zero-filled full row (host array)."""
        indptr, indices, values = self.numpy()
        lo, hi = int(indptr[index]), int(indptr[index + 1])
        out = np.zeros(self.cols, dtype=values.dtype)
        np.add.at(out, indices[lo:hi], values[lo:hi])
        return out

    def get_col_compact(self, index: int) -> List[CsrEntry]:
        """Stored entries of one column."""
        _, indices, values = self.numpy()
        rows = self._host_rows()
        hit = np.nonzero(indices == index)[0]
        return [CsrEntry(values[k], int(rows[k]), index) for k in hit]

    def get_col_complete(self, index: int) -> np.ndarray:
        """Zero-filled full column (host array)."""
        _, indices, values = self.numpy()
        rows = self._host_rows()
        out = np.zeros(self.rows, dtype=values.dtype)
        hit = indices == index
        np.add.at(out, rows[hit], values[hit])
        return out

    def get_col(self, index: int) -> "CSR":
        """One column as an (rows × 1) CSR."""
        _, indices, values = self.numpy()
        rows = self._host_rows()
        hit = indices == index
        return CSR.from_coo_arrays(
            (self.rows, 1), rows[hit], np.zeros(int(hit.sum()), dtype=np.int64),
            values[hit], sum_duplicates=False, drop_zeros=False,
            device=self.device)

    def take_submatrix(self, frm: DimLike, to: DimLike) -> "CSR":
        """Window ``[frm, to)`` (plain half-open slicing)."""
        f, t = MatDim.of(frm), MatDim.of(to)
        check(f.cols < t.cols and f.rows < t.rows, IncorrectDimensions,
              "empty submatrix window")
        check(t.rows <= self.rows and t.cols <= self.cols, OutOfBounds,
              "submatrix window exceeds matrix")
        _, indices, values = self.numpy()
        rows = self._host_rows()
        keep = (
            (rows >= f.rows) & (rows < t.rows)
            & (indices >= f.cols) & (indices < t.cols)
        )
        return CSR.from_coo_arrays(
            (t.rows - f.rows, t.cols - f.cols),
            rows[keep] - f.rows, indices[keep] - f.cols, values[keep],
            sum_duplicates=False, drop_zeros=False, device=self.device)

    def triangle(self, *, lower: bool, strict: bool = False) -> "CSR":
        """The lower (``lower``) or upper triangle: the entries with column
        ≤ row (≥ row), without the diagonal when ``strict``. Rows keep
        their storage order."""
        indptr, indices, values = self.numpy()
        rows = self._host_rows()
        if lower:
            keep = indices < rows if strict else indices <= rows
        else:
            keep = indices > rows if strict else indices >= rows
        ptr = np.zeros(self.rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows[keep], minlength=self.rows), out=ptr[1:])
        return CSR.from_host(ptr, indices[keep], values[keep], self.dims,
                             device=self.device)

    def add_padding(self, padded_size: DimLike, at: DimLike) -> "CSR":
        """Embed into a larger zero matrix at offset ``at``."""
        p, off = MatDim.of(padded_size), MatDim.of(at)
        check(self.rows <= p.rows and self.cols <= p.cols,
              PaddingSizeSmallerThanOriginal,
              "padded size smaller than matrix")
        check(
            p.rows >= self.rows + off.rows and p.cols >= self.cols + off.cols,
            IncorrectDimensions, "offset pushes matrix outside padded size",
        )
        _, indices, values = self.numpy()
        return CSR.from_coo_arrays(
            p, self._host_rows() + off.rows, indices + off.cols, values,
            sum_duplicates=False, drop_zeros=False, device=self.device)

    def __iter__(self) -> Iterator[CsrEntry]:
        _, indices, values = self.numpy()
        rows = self._host_rows()
        for k in range(values.shape[0]):
            yield CsrEntry(values[k], int(rows[k]), int(indices[k]))

    # ------------------------------------------------------------------ #
    # Operator sugar (delegates to the ops modules, imported lazily to
    # avoid cycles)
    # ------------------------------------------------------------------ #
    def transpose(self) -> "CSR":
        """The transposed matrix, computed on this matrix's device."""
        from .transpose import transpose as _transpose

        return _transpose(self)

    @property
    def T(self) -> "CSR":
        return self.transpose()

    def pair_with_transpose(self) -> Tuple["CSR", "CSR"]:
        """Reference ``pair_with_tranpose`` [sic]."""
        return self, self.transpose()

    def __matmul__(self, other):
        """``A @ B``: a CSR right-hand side goes to ``spgemm``, a vector
        to ``spmv``, a dense matrix to the gather/segment ``spmm``."""
        if isinstance(other, CSR):
            from .spgemm import spgemm

            return spgemm(self, other)
        from .spmm import spmm, spmv

        if not isinstance(other, torch.Tensor):
            other = torch.as_tensor(np.asarray(other), device=self.device)
        if other.ndim == 1:
            return spmv(self, other)
        return spmm(self, other)

    def __add__(self, other: "CSR") -> "CSR":
        from . import elementwise as _e

        return _e.add(self, other)

    def __sub__(self, other: "CSR") -> "CSR":
        from . import elementwise as _e

        return _e.sub(self, other)

    def __mul__(self, scalar) -> "CSR":
        from . import elementwise as _e

        return _e.mul_scalar(self, scalar)

    __rmul__ = __mul__

    def sum_elements(self) -> torch.Tensor:
        from . import elementwise as _e

        return _e.sum_elements(self)

    def l2_norm(self) -> torch.Tensor:
        from . import elementwise as _e

        return _e.l2_norm(self)

    # ------------------------------------------------------------------ #
    # Display (reference Display/Debug impls)
    # ------------------------------------------------------------------ #
    def __repr__(self) -> str:
        return (
            f"CSR(dims: {self.dims}, stored: {self.stored}, "
            f"dtype: {self.dtype}, device: {self.device})"
        )

    def __str__(self) -> str:
        dense = self.todense().cpu().numpy()
        return "\n".join(
            "|" + " ".join(f"{v:>5}" for v in row) + " |" for row in dense
        )

    def debug_str(self) -> str:
        """Raw-array dump mirroring the reference ``Debug`` impl."""
        indptr, indices, values = self.numpy()
        return (
            f"dims:      {self.dims}\n"
            f"v:         {values.tolist()}\n"
            f"col_index: {indices.tolist()}\n"
            f"row_index: {indptr.tolist()}\n"
        )

    def allclose(self, other: "CSR", rtol=1e-5, atol=1e-6) -> bool:
        """Value-level equality (densified comparison on the host)."""
        if self.shape != other.shape:
            return False
        return bool(
            np.allclose(
                self.todense().cpu().numpy(), other.todense().cpu().numpy(),
                rtol=rtol, atol=atol,
            )
        )


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch (or numpy) dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Dtype in which sums of ``dtype`` values are taken. PyTorch has no
    add for the unsigned types above uint8, so they accumulate in int64 and
    are cast back, which wraps modulo 2**bits as JAX's uint32 does."""
    if dtype in (torch.uint16, torch.uint32, torch.uint64):
        return torch.int64
    return dtype
