"""Distributed sparse matrices (counterpart of heat_tpu/sparse; heat.sparse)."""

from .arithmetics import add, matmul, mul, sum
from .dcsx_matrix import DCSC_matrix, DCSR_matrix, DCSX_matrix
from .factories import sparse_csc_matrix, sparse_csr_matrix
from .manipulations import to_dense, to_sparse, to_sparse_csc, to_sparse_csr

__all__ = [
    "DCSC_matrix",
    "DCSR_matrix",
    "add",
    "matmul",
    "mul",
    "sum",
    "sparse_csc_matrix",
    "sparse_csr_matrix",
    "to_dense",
    "to_sparse",
    "to_sparse_csc",
    "to_sparse_csr",
]
