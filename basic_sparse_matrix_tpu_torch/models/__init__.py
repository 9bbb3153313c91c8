from .solve import (DirectSolver, prepare_direct, solve, solve_auto,
                    solve_dense, solve_sparse)
from .supernodal import cholesky_supernodal
from .triangular import (
    backward_substitution,
    forward_substitution,
    solve_triangular_dense,
)

__all__ = [
    "cholesky_supernodal",
    "solve",
    "solve_dense",
    "solve_sparse",
    "solve_auto",
    "prepare_direct",
    "DirectSolver",
    "forward_substitution",
    "backward_substitution",
    "solve_triangular_dense",
]
