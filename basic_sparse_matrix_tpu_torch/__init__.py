"""basic_sparse_matrix_tpu_torch — the PyTorch + CUDA port of
``basic_sparse_matrix_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names, so each counterpart is found at the same relative path.
It imports ``torch`` and never ``jax``. Hand-written Hopper kernels live in
``csrc/`` and are built at first use by ``runtime/cuda_kernels.py``.

Ported so far (every module of the JAX package except ``parallel``):
* ``utils``   — shapes, the ``MatErr`` error types, config, logging
* ``ops``     — COO/CSR/Dense storage with the full ``CSR`` surface,
  transpose, ELL, interop, orderings, SpMM/SpMV and the ``spmm_auto``
  dispatch ladder, sparse add/sub/scale and reductions, SpGEMM
* ``ops/pallas`` — the BSR (K1) and streaming (K2) SpMM kernels, the run
  reads (K3) and the column add-backs (K4, K5) of the supernodal
  factorization and the per-entry FMA of the streaming SpMM's cost probe
  (K6, ``probes/entry_fma_probe.py``), each with its plain PyTorch version
  (the path keeps the JAX package's name)
* ``models``  — dense, banded (scan and BCR), supernodal and scatter-list
  Cholesky, the ``DirectSolver`` ladder behind ``solve_sparse``, dense and
  level-scheduled triangular solves, QR/TSQR and QR-iteration eigenvalues,
  IC(0)-PCG, Lanczos, Chebyshev and the ``SparseOperator`` serving
  wrapper
* ``runtime`` — host symbolic analysis (native C++ with numpy fallbacks),
  CUDA-event timing, the kernel build, validation, Matrix Market I/O,
  ``.npz`` checkpoints and metrics
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
    CsrEntry,
    Dense,
    DenseS,
    add_sparse,
    l2_norm,
    mul_dense,
    mul_scalar,
    mul_sparse,
    mul_vector,
    spgemm,
    spmm,
    spmm_auto,
    spmm_to_csr,
    spmv,
    sub_sparse,
    sum_elements,
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
