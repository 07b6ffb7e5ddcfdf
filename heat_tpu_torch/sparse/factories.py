"""Sparse factories (counterpart of heat_tpu/sparse/factories.py; heat's
sparse_csr_matrix/sparse_csc_matrix).

Sources: a scipy sparse matrix, a numpy (or nested list) dense array, a
torch sparse tensor (COO, CSR, CSC or a blocked layout), a dense DNDarray,
or another sparse matrix of this package.  Host sources are sorted and cut
into planes on the host, as the dense factories ingest host data.  A torch
tensor, sparse or dense, is packed where it lies, so one on the card never
makes a host round trip, and a DNDarray packs on its device.  The reference's
branch for JAX's ``BCOO``/``BCSR`` has no counterpart in a package without
JAX.  The whole source is given on every rank; ``is_split`` is read as
``split``, as the reference reads it.
"""

from __future__ import annotations

from typing import Optional, Type

import numpy as np
import torch

from ..core import types
from ..core.devices import sanitize_device
from ..core.dndarray import DNDarray
from ..parallel.comm import sanitize_comm
from . import _planes as _pl
from .dcsx_matrix import DCSC_matrix, DCSR_matrix, DCSX_matrix

__all__ = ["sparse_csr_matrix", "sparse_csc_matrix"]


def _host_coo(obj):
    """``(rows, cols, vals, shape, heat type, drop_zeros)``: global COO
    triplets of any supported source as torch tensors (a torch source's on
    its own device).  ``drop_zeros`` is set where the reference's ingestion
    goes through a dense array, which keeps no stored zero."""
    if isinstance(obj, DCSX_matrix):
        idx = obj.indices.to(torch.int64)
        comp_g = torch.repeat_interleave(torch.arange(obj.shape[obj._compressed_axis], device=idx.device),
                                         torch.diff(obj.indptr))
        rows, cols = (comp_g, idx) if obj._compressed_axis == 0 else (idx, comp_g)
        return rows, cols, obj.data, obj.shape, obj.dtype, False
    if isinstance(obj, torch.Tensor) and obj.layout != torch.strided:
        drop_zeros = obj.layout != torch.sparse_coo
        if obj.layout in (torch.sparse_csr, torch.sparse_csc):
            compressed = obj.layout == torch.sparse_csr
            ptr = obj.crow_indices() if compressed else obj.ccol_indices()
            idx = obj.col_indices() if compressed else obj.row_indices()
            comp = torch.repeat_interleave(torch.arange(ptr.numel() - 1, device=ptr.device), torch.diff(ptr))
            rows, cols, vals = (comp, idx, obj.values()) if compressed else (idx, comp, obj.values())
        else:
            coo = obj if obj.layout == torch.sparse_coo else obj.to_sparse_coo()
            (rows, cols), vals = coo._indices(), coo._values()
        return rows, cols, vals, tuple(obj.shape), types.canonical_heat_type(vals.dtype), drop_zeros
    if isinstance(obj, torch.Tensor):  # dense, found where it lies
        if obj.ndim != 2:
            raise ValueError(f"sparse matrices must be 2-dimensional, got {obj.ndim}")
        rows, cols = torch.nonzero(obj, as_tuple=True)
        return rows, cols, obj[rows, cols], tuple(obj.shape), types.canonical_heat_type(obj.dtype), False
    if hasattr(obj, "tocoo") and callable(obj.tocoo):  # scipy sparse
        coo = obj.tocoo()
        rows, cols, vals, shape = np.asarray(coo.row), np.asarray(coo.col), np.asarray(coo.data), tuple(coo.shape)
    else:
        arr = np.asarray(obj)
        if arr.ndim != 2:
            raise ValueError(f"sparse matrices must be 2-dimensional, got {arr.ndim}")
        rows, cols = np.nonzero(arr)
        vals, shape = arr[rows, cols], arr.shape
    heat_type = types.canonical_heat_type(vals.dtype)
    return (torch.from_numpy(rows.astype(np.int64)), torch.from_numpy(cols.astype(np.int64)),
            torch.from_numpy(np.array(types._to_holding(vals, heat_type))), shape, heat_type, False)


def _make(cls: Type[DCSX_matrix], obj, dtype=None, split: Optional[int] = None, is_split: Optional[int] = None,
          device=None, comm=None) -> DCSX_matrix:
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive")
    split = split if split is not None else is_split
    allowed = 0 if cls is DCSR_matrix else 1
    if split is not None and split != allowed:
        raise ValueError(f"{cls.__name__} only supports split={allowed} or None, got {split} "
                         "(matching the reference, dcsx_matrix.py:30)")

    if isinstance(obj, DNDarray):
        if obj.ndim != 2:
            raise ValueError(f"sparse matrices must be 2-dimensional, got {obj.ndim}")
        x = obj if obj.split == split else obj.resplit(split)
        block = x._masked(0) if split is not None else x.larray
        res = cls._from_built(_pl.pack_from_dense(block, x.shape, cls._compressed_axis, split, comm),
                              x.shape, x.dtype, split, x.device, comm)
    else:
        rows, cols, vals, shape, heat_type, drop_zeros = _host_coo(obj)
        if len(shape) != 2:
            raise ValueError(f"sparse matrices must be 2-dimensional, got {len(shape)}")
        built = _pl.build_from_coo(rows, cols, vals, shape, cls._compressed_axis, split, comm, device, drop_zeros)
        res = cls._from_built(built, shape, heat_type, split, device, comm)
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
        if res.dtype != dtype:
            res = res.astype(dtype)
    return res


def sparse_csr_matrix(obj, dtype=None, copy=None, ndmin: int = 0, order=None, split=None, is_split=None, device=None,
                      comm=None) -> DCSR_matrix:
    """A DCSR_matrix from a sparse or dense source (heat/sparse/factories.py:25)."""
    return _make(DCSR_matrix, obj, dtype, split, is_split, device, comm)


def sparse_csc_matrix(obj, dtype=None, copy=None, ndmin: int = 0, order=None, split=None, is_split=None, device=None,
                      comm=None) -> DCSC_matrix:
    """A DCSC_matrix from a sparse or dense source (heat/sparse/factories.py:200)."""
    return _make(DCSC_matrix, obj, dtype, split, is_split, device, comm)
