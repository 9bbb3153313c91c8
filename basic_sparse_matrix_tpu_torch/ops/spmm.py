"""SpMM (CSR × dense) and SpMV — the main path of the port.

Counterpart of ``basic_sparse_matrix_tpu/ops/spmm.py`` (reference
``mul_dense``/``mul_vector``, ``src/sparse.rs:426-482``). ``spmm_auto``
keeps the JAX package's dispatch ladder and thresholds:

1. dense: ``torch.matmul`` on the memoised densified operand, when density
   ≥ ``dense_dispatch_density`` and the dense matrix takes at most
   ``dense_dispatch_max_bytes`` (the JAX package leaves this product to XLA);
2. BSR: the K1 CUDA kernel (``ops/pallas/spmm_kernel.py``) when
   ``bsr_profitable``;
3. ELL: gather + per-row reduce, or on the GPU the K2 streaming kernel
   (``ops/ell.py``, ``ops/pallas/stream_kernel.py``);
4. ``spmm``: gather + ``index_add_`` segment sum, any shape.

Dispatch rule for the kernels: the BSR and streaming kernels take float32
only. A matrix or RHS of another dtype on a CUDA device (the integer-dtype
cases) takes the plain rungs 1, 3 (gather + reduce) and 4, chosen before
any launch — never by catching a failed one. On the CPU the kernel rungs
are off, as they are off the TPU in the JAX package, so the ladder picks
the same rung as the JAX package on the CPU.

Result dtypes follow the JAX package: ``spmm``/``spmv`` and the ELL rung
return the RHS's dtype; the dense rung and the kernels return float32.

Batches (``jax.vmap`` in the JAX package): ``spmm_auto``/``mul_dense`` with
``b`` of shape (Bt, K, N) fold the batch into the columns, so the (K, Bt·N)
product takes one pass down the ladder (the kernels at full width), and
unfold the result to (Bt, M, N). ``spmm(a, b, values=V)`` with ``V`` (Bt,
nnz) multiplies ``Bt`` matrices of ``a``'s pattern: the gather rung with a
batch axis, the rung JAX's ``vmap`` over the values takes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..runtime import profiling
from ..utils.config import get_config, matmul_precision
from ..utils.errors import IncorrectDimensions, check
from . import ell as _e
from .csr import CSR, compute_dtype
from .pallas import spmm_kernel as _k


def _as_tensor(x, a: CSR) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=a.device)


# Bytes of gathered rows one chunk of the batched-values gather may hold.
VALUES_CHUNK_BYTES = 1 << 30


def spmm(a: CSR, b: torch.Tensor,
         values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather-based SpMM: ``out[i, :] = Σ_k A[i,k]·B[k, :]``: gather the rows
    of ``B`` by column index, scale by the stored values, and add them into
    their output rows.

    ``values`` (Bt, nnz) replaces ``a.values`` by ``Bt`` value sets of the
    same pattern: ``b`` (K, N), or (Bt, K, N) one per system, gives (Bt, M,
    N), in entry chunks of at most ``VALUES_CHUNK_BYTES`` of gathered rows
    for the whole batch."""
    if values is not None:
        return _spmm_values(a, b, values)
    cdt = compute_dtype(b.dtype)
    gathered = b.to(cdt).index_select(0, a.indices) \
        * a.values.to(cdt).unsqueeze(1)
    out = torch.zeros((a.rows, b.shape[1]), dtype=cdt, device=b.device)
    out.index_add_(0, a.row_ids(), gathered)
    return out.to(b.dtype)


def _spmm_values(a: CSR, b: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    check(values.ndim == 2 and values.shape[1] == a.stored
          and b.ndim in (2, 3) and b.shape[-2] == a.cols
          and (b.ndim == 2 or b.shape[0] == values.shape[0]),
          IncorrectDimensions,
          f"spmm with values: {a.dims}, {a.stored} stored, values "
          f"{tuple(values.shape)}, b {tuple(b.shape)}")
    bt, n = values.shape[0], b.shape[-1]
    cdt = compute_dtype(b.dtype)
    bc, vals = b.to(cdt), values.to(cdt)
    rows = a.row_ids()
    out = torch.zeros((bt, a.rows, n), dtype=cdt, device=b.device)
    per_entry = bt * n * out.element_size()
    chunk = max(1, VALUES_CHUNK_BYTES // max(per_entry, 1))
    for e0 in range(0, a.stored, chunk):
        cols = a.indices[e0: e0 + chunk]
        gathered = bc.index_select(-2, cols) \
            * vals[:, e0: e0 + chunk, None]             # (Bt, e, N)
        out.index_add_(1, rows[e0: e0 + chunk], gathered)
    return out.to(b.dtype)


def spmv(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """Sparse matrix × vector: the N=1 gather/segment sum."""
    cdt = compute_dtype(x.dtype)
    prod = a.values.to(cdt) * x.to(cdt).index_select(0, a.indices)
    out = torch.zeros(a.rows, dtype=cdt, device=x.device)
    out.index_add_(0, a.row_ids(), prod)
    return out.to(x.dtype)


def mul_dense(a: CSR, b) -> torch.Tensor:
    """Checked SpMM entry point — reference ``mul_dense`` including its
    ``IncorrectDimensions`` error. ``b`` (K, N), or a batch (Bt, K, N)."""
    b = _as_tensor(b, a)
    check(b.ndim in (2, 3) and a.cols == b.shape[-2], IncorrectDimensions,
          f"mul_dense: {a.dims} × {tuple(b.shape)}")
    return spmm_auto(a, b)


def mul_vector(a: CSR, x) -> torch.Tensor:
    """Checked SpMV — reference ``mul_vector``."""
    x = _as_tensor(x, a)
    check(x.ndim == 1 and a.cols == x.shape[0], IncorrectDimensions,
          f"mul_vector: {a.dims} × {tuple(x.shape)}")
    return spmv(a, x)


def spmm_to_csr(a: CSR, b) -> CSR:
    """Reference-shaped result: the dense product re-sparsified (exact
    zeros dropped), on ``a``'s device. Host-side."""
    return CSR.from_dense(mul_dense(a, b).cpu().numpy(), device=a.device)


def _rung(a: CSR, b: torch.Tensor) -> str:
    """The ladder's rung for ``a`` × ``b``: ``dense``, ``bsr``, ``ell`` (the
    ELL path, which picks the streaming kernel or the gather + reduce
    itself) or ``gather``."""
    cfg = get_config()
    if (a.get_density() >= cfg.dense_dispatch_density
            and 4 * a.rows * a.cols <= cfg.dense_dispatch_max_bytes):
        return "dense"
    kernels = (b.is_cuda and a.dtype == torch.float32
               and b.dtype == torch.float32)
    if kernels and _k.bsr_profitable(a, b):
        return "bsr"
    if a.stored and _e.ell_overhead(a) <= cfg.ell_max_overhead:
        return "ell"
    return "gather"


def spmm_auto(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """Density-dispatched SpMM (the ladder in the module docstring). A batch
    ``b`` (Bt, K, N) is folded into the columns, (K, Bt·N), multiplied in
    one pass down the ladder and unfolded to (Bt, M, N).

    The recorder (``runtime/profiling.py``) sees the choice as the span
    ``bsm.spmm.dispatch`` and the counter ``spmm.rung.<rung>`` (``dense``,
    ``bsr``, ``ell``, ``stream`` or ``gather``), and the product as the
    span ``bsm.spmm.<rung>``. The memoised dense operand is the set-up lap
    ``spmm.dense_convert``, as the other rungs' layouts are theirs."""
    if b.ndim == 3:
        bt, k, n = b.shape
        folded = b.permute(1, 0, 2).reshape(k, bt * n)
        return spmm_auto(a, folded).reshape(a.rows, bt, n).transpose(0, 1) \
            .contiguous()
    with profiling.span("bsm.spmm.dispatch"):
        rung = _rung(a, b)
    if rung == "ell":
        return _e.spmm_ell_from_csr(a, b)
    profiling.count("spmm.rung." + rung)
    with profiling.span("bsm.spmm." + rung):
        if rung == "bsr":
            return _k.spmm_bsr_from_csr(a, b)
        if rung == "gather":
            return spmm(a, b)
        if a._dense_cache is None:
            clock = profiling.Laps("spmm", a.device)
            a._dense_cache = a.todense().to(torch.float32)
            clock.lap("dense_convert")
        with matmul_precision():
            return torch.matmul(a._dense_cache, b.to(torch.float32))
