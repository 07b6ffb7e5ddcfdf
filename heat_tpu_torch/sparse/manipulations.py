"""Sparse <-> dense conversions (counterpart of
heat_tpu/sparse/manipulations.py; heat's to_dense, to_sparse_csr/csc).

A sparse -> sparse format change keeps the triplets: the planes are
gathered whole, re-keyed by the other axis, sorted and cut again, so no
dense (m, n) buffer is ever made."""

from __future__ import annotations

from ..core.dndarray import DNDarray
from . import _planes as _pl
from .dcsx_matrix import DCSC_matrix, DCSR_matrix, DCSX_matrix
from .factories import sparse_csc_matrix, sparse_csr_matrix

__all__ = ["to_dense", "to_sparse", "to_sparse_csc", "to_sparse_csr"]


def to_dense(sparse_matrix: DCSX_matrix, order=None, out=None) -> DNDarray:
    """A dense DNDarray of a sparse matrix, written into ``out`` if given."""
    if not isinstance(sparse_matrix, DCSX_matrix):
        raise TypeError(f"expected a sparse matrix, got {type(sparse_matrix)}")
    res = sparse_matrix.todense()
    if out is not None:
        out._replace(res.larray_padded)
        return out
    return res


def _convert_format(s: DCSX_matrix, cls, split):
    """CSR <-> CSC without densifying: the planes whole on every rank
    (``rechunk_planes``), re-keyed and sorted by the other axis
    (``recompress_planes``), then cut at ``split``'s chunks."""
    from .arithmetics import _align_split

    extent_old = s.shape[s._compressed_axis]
    if s._dist:
        comp, other, val = _pl.rechunk_planes(s._comp, s._other, s._val, s._lnnz_host, extent_old, False,
                                              s._comp_pad, s.comm)[:3]
    else:
        comp, other, val = s._planes
    extent_new = s.shape[1 - s._compressed_axis]
    gnnz = s.gnnz
    planes = _pl.recompress_planes(comp, other, val, gnnz, extent_old, extent_new)
    mat = cls(planes, (gnnz,), max(gnnz, 1), max(extent_new, 1), s.shape, s.dtype, None, s.device, s.comm)
    return mat if split is None else _align_split(mat, split)


def to_sparse_csr(array) -> DCSR_matrix:
    """A DCSR matrix of a dense DNDarray or of a DCSC matrix (triplets kept)."""
    if isinstance(array, DCSR_matrix):
        return array
    if isinstance(array, DCSC_matrix):
        return _convert_format(array, DCSR_matrix, 0 if array.split is not None else None)
    if not isinstance(array, DNDarray):
        raise TypeError(f"expected a DNDarray or sparse matrix, got {type(array)}")
    return sparse_csr_matrix(array, split=0 if array.split == 0 else None, comm=array.comm)


def to_sparse_csc(array) -> DCSC_matrix:
    """A DCSC matrix of a dense DNDarray or of a DCSR matrix (triplets kept)."""
    if isinstance(array, DCSC_matrix):
        return array
    if isinstance(array, DCSR_matrix):
        return _convert_format(array, DCSC_matrix, 1 if array.split is not None else None)
    if not isinstance(array, DNDarray):
        raise TypeError(f"expected a DNDarray or sparse matrix, got {type(array)}")
    return sparse_csc_matrix(array, split=1 if array.split == 1 else None, comm=array.comm)


to_sparse = to_sparse_csr
