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
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import get_config, matmul_precision
from ..utils.errors import IncorrectDimensions, check
from . import ell as _e
from .csr import CSR, compute_dtype
from .pallas import spmm_kernel as _k


def _as_tensor(x, a: CSR) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=a.device)


def spmm(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """Gather-based SpMM: ``out[i, :] = Σ_k A[i,k]·B[k, :]``: gather the rows
    of ``B`` by column index, scale by the stored values, and add them into
    their output rows."""
    cdt = compute_dtype(b.dtype)
    gathered = b.to(cdt).index_select(0, a.indices) \
        * a.values.to(cdt).unsqueeze(1)
    out = torch.zeros((a.rows, b.shape[1]), dtype=cdt, device=b.device)
    out.index_add_(0, a.row_ids(), gathered)
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
    ``IncorrectDimensions`` error."""
    b = _as_tensor(b, a)
    check(b.ndim == 2 and a.cols == b.shape[0], IncorrectDimensions,
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


def spmm_auto(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """Density-dispatched SpMM (the ladder in the module docstring)."""
    cfg = get_config()
    if (a.get_density() >= cfg.dense_dispatch_density
            and 4 * a.rows * a.cols <= cfg.dense_dispatch_max_bytes):
        if a._dense_cache is None:
            a._dense_cache = a.todense().to(torch.float32)
        with matmul_precision():
            return torch.matmul(a._dense_cache, b.to(torch.float32))
    kernels = (b.is_cuda and a.dtype == torch.float32
               and b.dtype == torch.float32)
    if kernels and _k.bsr_profitable(a, b):
        return _k.spmm_bsr_from_csr(a, b)
    if a.stored and _e.ell_overhead(a) <= cfg.ell_max_overhead:
        return _e.spmm_ell_from_csr(a, b)
    return spmm(a, b)
