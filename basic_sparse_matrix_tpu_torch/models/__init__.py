from .cholesky import cholesky, cholesky_auto, cholesky_decomp, cholesky_dense
from .sparse_cholesky import cholesky_sparse
from .supernodal import cholesky_supernodal
from .qr import (eigen_values, eigen_values_dense, eigen_values_sym, qr_decomp,
                 qr_dense, tsqr, tsqr_dense)
from .chebyshev import chebyshev_solve, spectral_bounds
from .lanczos import (LanczosSetup, condition_estimate,
                      eigen_values_lanczos, extremal_eigen_values)
from .multigrid import MultigridSetup, injection_map
from .operator import SparseOperator
from .pcg import PCGSetup, pcg_solve
from .solve import (DirectSolver, prepare_direct, solve, solve_auto,
                    solve_dense, solve_sparse)
from .triangular import (
    backward_substitution,
    forward_substitution,
    solve_triangular_dense,
)

__all__ = [
    "cholesky",
    "cholesky_sparse",
    "cholesky_supernodal",
    "cholesky_auto",
    "cholesky_decomp",
    "cholesky_dense",
    "qr_decomp",
    "tsqr",
    "tsqr_dense",
    "qr_dense",
    "eigen_values",
    "eigen_values_sym",
    "eigen_values_dense",
    "eigen_values_lanczos",
    "extremal_eigen_values",
    "condition_estimate",
    "LanczosSetup",
    "chebyshev_solve",
    "spectral_bounds",
    "solve",
    "solve_dense",
    "solve_sparse",
    "solve_auto",
    "prepare_direct",
    "DirectSolver",
    "pcg_solve",
    "PCGSetup",
    "MultigridSetup",
    "injection_map",
    "SparseOperator",
    "forward_substitution",
    "backward_substitution",
    "solve_triangular_dense",
]
