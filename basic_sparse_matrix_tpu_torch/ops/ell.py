"""ELL (padded-row) sparse format — the hypersparse SpMM path.

Counterpart of ``basic_sparse_matrix_tpu/ops/ell.py``. Every row is padded
to the longest row's length (padding slots ``col = 0, val = 0``), which
turns SpMM into gather + per-row reduce with no scatter.

The JAX package has four formulations of that one function
(``_spmm_ell_direct``, ``_spmm_ell_unrolled``, ``_spmm_ell_barriered``,
``_spmm_ell_chunked``) that steer XLA's fusion on the TPU. The port has
one function with two versions. On a CUDA device, float32 values and a
float32 operand go to **K8** (``csrc/ell_spmm.cu``): one launch on the
current stream that reads the int32 columns and the values once, gathers
each slot's row of the operand and sums every row in float32 registers,
writing only the result (capturable in a CUDA graph: no host
synchronisation). Everything else (the CPU, integer and float64 products)
runs the plain version: gather + reduce over row chunks bounded like
``_chunk_rows``. The recorder counts ``ell.products`` at every product and
``ell.launches`` (K8) or ``ell.plain`` beside it. K8 reads the operand's
rows unchecked, so an ELL's columns are checked to lie in [0, n_cols) once
(:func:`check_cols`): when :func:`csr_to_ell` builds it, else at its first
K8 product. Config ``ell_gather_bf16`` (a bf16 gather inside the
barriered formulation) is accepted and has no effect: the port always
gathers in the operand's dtype.

``spmm_ell_from_csr`` routes wide-RHS float32 operands on a CUDA device to
the streaming kernel (``ops/pallas/stream_kernel.py``) first.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..runtime import profiling
from ..utils.config import get_config
from .csr import CSR, compute_dtype, to_tensor
from .pallas.stream_kernel import spmm_stream, stream_plan_from_ell

# The gathered intermediate of one chunk of the plain version is (chunk,
# width, n_rhs); chunks keep it under this many bytes.
INTERMEDIATE_BUDGET_BYTES = 1 << 30
# Threads a block of K8: 128 was the fastest of 128, 256, 512 and 1024 at
# each of the benchmark's shapes (``probes/ell_probe.py --threads``).
THREADS = 128
# K8 launches made in this process.
LAUNCHES = 0


@dataclasses.dataclass(eq=False)
class ELL:
    """Padded row-major sparse layout: ``cols[r, k]``/``vals[r, k]`` hold the
    k-th stored entry of row r; padding slots have ``col = 0, val = 0``.
    ``_host_cols``/``_host_vals`` are the numpy mirrors the plan builders
    read. ``_cols_ok`` records that :func:`check_cols` passed (a row slice
    of a checked layout passes it on)."""

    cols: torch.Tensor   # (rows, width) int32
    vals: torch.Tensor   # (rows, width)
    n_cols: int
    _host_cols: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    _host_vals: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    _cols_ok: bool = dataclasses.field(default=False, repr=False)
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
    ell = ELL(cols=to_tensor(cols, a.device), vals=to_tensor(vals, a.device),
              n_cols=a.cols, _host_cols=cols, _host_vals=vals)
    check_cols(ell)
    return ell


def check_cols(ell: ELL) -> None:
    """Raise ``ValueError`` unless every column index of ``ell`` lies in
    [0, n_cols) (column 0 also where ``n_cols`` is 0: the padding), and
    record on ``ell`` that it does. Reads the host mirror where there is
    one, else the device's columns (a host read: not inside a capture)."""
    cols = ell._host_cols if ell._host_cols is not None else ell.cols
    if ell.n_rows and ell.width:
        lo, hi = int(cols.min()), int(cols.max())
        if lo < 0 or hi >= max(ell.n_cols, 1):
            raise ValueError(f"ell: column indices span [{lo}, {hi}], the "
                             f"matrix has {ell.n_cols} columns")
    ell._cols_ok = True


def _chunk_rows(ell: ELL, n_rhs: int) -> int:
    per_row = ell.width * n_rhs * 4
    return max(1, INTERMEDIATE_BUDGET_BYTES // max(per_row, 1))


def _on_k8(ell: ELL, b: torch.Tensor) -> bool:
    """Whether the product of ``ell`` and ``b`` runs on K8: float32 values
    and operand, the operand on a CUDA device."""
    return (b.is_cuda and b.dtype == torch.float32
            and ell.vals.dtype == torch.float32)


def _ell_cuda(ell: ELL, b: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 (``csrc/ell_spmm.cu``): ``ell`` times ``b`` ((K,) or (K, N), any
    strides) as one launch on the current stream, into ``out`` (contiguous
    float32 of shape (rows,) or (rows, N), which may be a view of a larger
    buffer, ``b``'s too where the rows ``b`` holds and those ``out`` covers
    do not meet) or a new tensor. Counts ``ell.products`` and
    ``ell.launches``."""
    global LAUNCHES
    from ..runtime import cuda_kernels

    cols, vals = ell.cols.contiguous(), ell.vals.contiguous()
    if cols.dtype != torch.int32 or cols.device != b.device \
            or vals.device != b.device:
        raise ValueError(f"ell: K8 needs int32 cols and values on "
                         f"{b.device}, got {cols.dtype} on {cols.device} "
                         f"and values on {vals.device}")
    if not ell._cols_ok:
        check_cols(ell)
    if ell.n_rows and ell.width and int(b.shape[0]) < max(ell.n_cols, 1):
        raise ValueError(f"ell: the operand has {b.shape[0]} rows, the "
                         f"matrix {ell.n_cols} columns")
    n = 1 if b.ndim == 1 else int(b.shape[1])
    shape = (ell.n_rows, *b.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=b.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or out.device != b.device or not out.is_contiguous()):
        raise ValueError(f"ell: K8 writes a contiguous float32 {shape} on "
                         f"{b.device}, got {out.dtype} {tuple(out.shape)} "
                         f"on {out.device}")
    if out.numel():
        lib = cuda_kernels.load()
        with torch.cuda.device(b.device):
            stream = torch.cuda.current_stream(b.device).cuda_stream
            status = lib.bsm_ell_spmm(
                cols.data_ptr(), vals.data_ptr(), b.data_ptr(),
                out.data_ptr(), ell.n_rows, ell.width, n, b.stride(0),
                b.stride(1) if b.ndim == 2 else 1, n, THREADS, stream)
        LAUNCHES += 1
        cuda_kernels.check_launch(lib, status, "ell_spmm")
        profiling.count("ell.products")
        profiling.count("ell.launches")
    return out


def spmm_ell(ell: ELL, b: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[r] = Σ_k vals[r,k]·B[cols[r,k]]``; padding slots contribute
    ``0 · B[0]``. The result has ``b``'s dtype. K8 where :func:`_on_k8`
    holds, else :func:`spmm_ell_plain` (:func:`spmv_ell_plain` for a 1-D
    ``b``). With ``out`` (of the result's shape and dtype; on K8 a
    contiguous view, see :func:`_ell_cuda`) the result is written there
    and ``out`` returned."""
    if _on_k8(ell, b):
        return _ell_cuda(ell, b, out)
    y = spmv_ell_plain(ell, b) if b.ndim == 1 else spmm_ell_plain(ell, b)
    if out is None:
        return y
    return out.copy_(y)


def spmm_ell_plain(ell: ELL, b: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`spmm_ell`: gather + per-row reduce, in
    row chunks. Counts ``ell.products`` and ``ell.plain``."""
    profiling.count("ell.products")
    profiling.count("ell.plain")
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
    """SpMV over ELL: K8 for a 1-D ``x`` where :func:`_on_k8` holds, else
    :func:`spmv_ell_plain`."""
    if x.ndim == 1 and _on_k8(ell, x):
        return _ell_cuda(ell, x)
    return spmv_ell_plain(ell, x)


def spmv_ell_plain(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`spmv_ell`: one gathered product + row
    reduce. Counts ``ell.products`` and ``ell.plain``."""
    profiling.count("ell.products")
    profiling.count("ell.plain")
    cdt = compute_dtype(x.dtype)
    prod = ell.vals.to(cdt) * x.to(cdt)[ell.cols.long()]
    return prod.sum(1, dtype=cdt).to(x.dtype)


def ell_overhead(a: CSR) -> float:
    """Padding overhead factor: stored slots after padding / true stored.
    Worked out once from ``a``'s row pointer (the host mirror where there
    is one, else one read of the device's longest row) and memoised on
    ``a``."""
    if a._ell_overhead is None:
        ptr = a._host[0] if a._host is not None else a.indptr
        longest = int((ptr[1:] - ptr[:-1]).max()) if a.rows else 0
        a._ell_overhead = a.rows * max(longest, 1) / max(a.stored, 1)
    return a._ell_overhead


def cached_ell(a: CSR) -> ELL:
    """``a``'s ELL layout, converted once and memoised on ``a`` (the set-up
    lap ``spmm.ell_convert``)."""
    if a._ell_cache is None:
        clock = profiling.Laps("spmm", a.device)
        a._ell_cache = csr_to_ell(a)
        clock.lap("ell_convert")
    return a._ell_cache


def spmm_ell_from_csr(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """CSR entry point with memoised ELL conversion. With config
    ``ell_stream="on"``, a float32 RHS on a CUDA device with at least 128
    columns against a float32 matrix of at least 2**18 stored entries goes
    to the streaming kernel (K2; the plan is memoised on the ELL); every
    other product to :func:`spmm_ell` (K8 on the card in float32). A 1-D
    ``b`` is one column."""
    ell = cached_ell(a)
    cfg = get_config()
    if (cfg.ell_stream == "on"
            and b.is_cuda
            and b.dtype == torch.float32
            and ell.vals.dtype == torch.float32
            and b.ndim == 2 and b.shape[1] >= 128
            and a.stored >= (1 << 18)):
        plan = stream_plan_from_ell(ell, int(b.shape[1]))
        if plan is not None:
            profiling.count("spmm.rung.stream")
            with profiling.span("bsm.spmm.stream"):
                return spmm_stream(plan, b)
    profiling.count("spmm.rung.ell")
    with profiling.span("bsm.spmm.ell"):
        return spmm_ell(ell, b)
