from .coo import COO
from .csr import CSR
from .dense import Dense, DenseS
from .ell import ELL, csr_to_ell, spmm_ell, spmv_ell
from .interop import from_scipy, to_scipy
from .spmm import mul_dense, mul_vector, spmm, spmm_auto, spmm_to_csr, spmv

__all__ = [
    "CSR",
    "COO",
    "ELL",
    "csr_to_ell",
    "spmm_ell",
    "spmv_ell",
    "to_scipy",
    "from_scipy",
    "Dense",
    "DenseS",
    "spmm",
    "spmv",
    "spmm_auto",
    "spmm_to_csr",
    "mul_dense",
    "mul_vector",
]
