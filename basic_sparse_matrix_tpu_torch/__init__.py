"""basic_sparse_matrix_tpu_torch — the PyTorch + CUDA port of
``basic_sparse_matrix_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names, so each counterpart is found at the same relative path.
It imports ``torch`` and never ``jax``. Hand-written Hopper kernels live in
``csrc/`` and are built at first use by ``runtime/cuda_kernels.py``.

Ported so far (the CSR × dense SpMM path, and every solver of ``models``):
* ``utils``   — shapes, the ``MatErr`` error types, config, logging
* ``ops``     — COO/CSR/Dense storage, transpose, ELL, interop, orderings,
  SpMM/SpMV and the ``spmm_auto`` dispatch ladder
* ``ops/pallas`` — the BSR (K1) and streaming (K2) SpMM kernels, the run
  reads (K3) and the column add-backs (K4, K5) of the supernodal
  factorization, each with its plain PyTorch version (the path keeps the
  JAX package's name)
* ``models``  — dense, banded (scan and BCR), supernodal and scatter-list
  Cholesky, the ``DirectSolver`` ladder behind ``solve_sparse``, dense and
  level-scheduled triangular solves, QR/TSQR and QR-iteration eigenvalues,
  IC(0)-PCG, Lanczos, Chebyshev and the ``SparseOperator`` serving
  wrapper
* ``runtime`` — host symbolic analysis (native C++ with numpy fallbacks),
  CUDA-event timing and the kernel build
"""

from .models import (
    DirectSolver,
    SparseOperator,
    backward_substitution,
    cholesky,
    cholesky_auto,
    cholesky_decomp,
    cholesky_dense,
    cholesky_sparse,
    cholesky_supernodal,
    eigen_values,
    eigen_values_sym,
    forward_substitution,
    pcg_solve,
    prepare_direct,
    qr_decomp,
    solve,
    solve_auto,
    solve_dense,
    solve_sparse,
)
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
    transpose,
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
