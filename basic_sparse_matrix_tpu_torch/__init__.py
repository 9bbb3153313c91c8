"""basic_sparse_matrix_tpu_torch — the PyTorch + CUDA port of
``basic_sparse_matrix_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names, so each counterpart is found at the same relative path.
It imports ``torch`` and never ``jax``. Hand-written Hopper kernels live in
``csrc/`` and are built at first use by ``runtime/cuda_kernels.py``.

Ported so far (the CSR × dense SpMM main path):
* ``utils``   — shapes, the ``MatErr`` error types, config, logging
* ``ops``     — COO/CSR/Dense storage, ELL, interop, SpMM/SpMV and the
  ``spmm_auto`` dispatch ladder
* ``ops/pallas`` — the BSR (K1) and streaming (K2) SpMM kernels with their
  plain PyTorch versions (the path keeps the JAX package's name)
* ``runtime`` — CUDA-event timing and the kernel build
"""

from .ops import (
    COO,
    CSR,
    Dense,
    DenseS,
    mul_dense,
    mul_vector,
    spmm,
    spmm_auto,
    spmm_to_csr,
    spmv,
)
from .utils import (
    IncorrectDimensions,
    MatDim,
    MatErr,
    MatrixFinalised,
    MatrixNotFinalised,
    NonSquareMatrix,
    OutOfBounds,
    PaddingSizeSmallerThanOriginal,
)

__version__ = "0.1.0"
