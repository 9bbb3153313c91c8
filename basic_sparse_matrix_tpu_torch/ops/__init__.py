from .coo import COO
from .csr import CSR, CsrEntry
from .dense import Dense, DenseS
from .elementwise import (
    add,
    add_sparse,
    l2_norm,
    mul_scalar,
    sub,
    sub_sparse,
    sum_elements,
)
from .ell import ELL, csr_to_ell, spmm_ell, spmv_ell
from .interop import (
    from_scipy,
    from_torch_sparse,
    to_scipy,
    to_torch_sparse,
)
from .spgemm import mul_sparse, spgemm, spgemm_bounded, spgemm_dense
from .spmm import mul_dense, mul_vector, spmm, spmm_auto, spmm_to_csr, spmv
from .transpose import transpose

__all__ = [
    "CSR",
    "CsrEntry",
    "COO",
    "ELL",
    "csr_to_ell",
    "spmm_ell",
    "spmv_ell",
    "to_scipy",
    "from_scipy",
    "to_torch_sparse",
    "from_torch_sparse",
    "Dense",
    "DenseS",
    "spmm",
    "spmv",
    "spmm_auto",
    "spmm_to_csr",
    "mul_dense",
    "mul_vector",
    "transpose",
    "add",
    "sub",
    "add_sparse",
    "sub_sparse",
    "mul_scalar",
    "sum_elements",
    "l2_norm",
    "spgemm",
    "spgemm_dense",
    "spgemm_bounded",
    "mul_sparse",
]
