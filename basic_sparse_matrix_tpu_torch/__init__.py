"""basic_sparse_matrix_tpu_torch — the PyTorch + CUDA port of
``basic_sparse_matrix_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names, so each counterpart is found at the same relative path.
It imports ``torch`` and never ``jax``. Hand-written Hopper kernels live in
``csrc/`` and are built at first use by ``runtime/cuda_kernels.py``.

Ported so far (the CSR × dense SpMM path and the sparse direct solver):
* ``utils``   — shapes, the ``MatErr`` error types, config, logging
* ``ops``     — COO/CSR/Dense storage, transpose, ELL, interop, orderings,
  SpMM/SpMV and the ``spmm_auto`` dispatch ladder
* ``ops/pallas`` — the BSR (K1) and streaming (K2) SpMM kernels, the run
  reads (K3) and the column add-backs (K4, K5) of the supernodal
  factorization, each with its plain PyTorch version (the path keeps the
  JAX package's name)
* ``models``  — dense and level-scheduled triangular solves, supernodal
  Cholesky and the ``DirectSolver`` behind ``solve_sparse``
* ``runtime`` — host symbolic analysis (native C++ with numpy fallbacks),
  CUDA-event timing and the kernel build
"""

from .models import (
    DirectSolver,
    backward_substitution,
    cholesky_supernodal,
    forward_substitution,
    prepare_direct,
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
