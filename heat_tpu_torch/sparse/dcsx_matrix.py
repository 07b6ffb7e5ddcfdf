"""Distributed compressed sparse matrices (counterpart of
heat_tpu/sparse/dcsx_matrix.py; heat's DCSR_matrix/DCSC_matrix).

Each rank keeps its shard's padded planes (:mod:`._planes`) as torch
tensors on its device, and the per-rank nnz as a host tuple.  CSR is split
0 or None, CSC split 1 or None.  The local accessors (``lnnz``,
``lindptr``, ``lindices``, ``ldata``, ``lshape``, ``larray``) answer for
this rank's chunk, as heat's do; the global ones (``indptr``, ``indices``,
``data``) gather every rank's part.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import types
from ..core.devices import Device
from ..parallel.comm import Communication
from . import _planes as _pl

__all__ = ["DCSR_matrix", "DCSC_matrix", "DCSX_matrix"]


class DCSX_matrix:
    """Shared base of DCSR/DCSC."""

    _compressed_axis: int = 0

    def __init__(
        self,
        planes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
        lnnz: Tuple[int, ...],
        capacity: int,
        comp_pad: int,
        gshape: Tuple[int, int],
        dtype,
        split: Optional[int],
        device: Device,
        comm: Communication,
    ):
        self._comp, self._other, self._val = planes
        self._lnnz_host = tuple(int(v) for v in lnnz)
        self._capacity = int(capacity)
        self._comp_pad = int(comp_pad)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = types.canonical_heat_type(dtype)
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__by_other = None

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @classmethod
    def _from_built(cls, built, gshape, dtype, split, device, comm) -> "DCSX_matrix":
        comp, other, val, lnnz, capacity, comp_pad = built
        return cls((comp, other, val), lnnz, capacity, comp_pad, gshape, dtype, split, device, comm)

    def _with_planes(self, planes, lnnz, capacity, dtype=None) -> "DCSX_matrix":
        return type(self)(planes, lnnz, capacity, self._comp_pad, self.__gshape, dtype or self.__dtype,
                          self.__split, self.__device, self.__comm)

    @property
    def _dist(self) -> bool:
        return self.__split is not None

    @property
    def _n(self) -> int:
        """This rank's count of real entries."""
        return self._lnnz_host[_pl.shard_index(self._dist, self.__comm)]

    @property
    def _planes(self):
        return self._comp, self._other, self._val

    def _by_other(self) -> torch.Tensor:
        """This rank's real entries ordered by the uncompressed index
        (stable), kept for the products and sums that reduce along it."""
        if self.__by_other is None:
            self.__by_other = _pl.by_other(self._other, self._n)
        return self.__by_other

    # ------------------------------------------------------------------
    @property
    def larray(self) -> torch.Tensor:
        """This rank's chunk as a torch sparse tensor: CSR of its rows for a
        DCSR matrix, CSC of its columns for a DCSC one (heat's layout)."""
        lshape = self.lshape
        ptr = self.lindptr[: lshape[self._compressed_axis] + 1]
        idx = self._other[: self._n].to(torch.int64)
        if self._compressed_axis == 0:
            return torch.sparse_csr_tensor(ptr, idx, self._val[: self._n], size=lshape)
        return torch.sparse_csc_tensor(ptr, idx, self._val[: self._n], size=lshape)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.__gshape

    gshape = shape

    @property
    def lshape(self) -> Tuple[int, int]:
        """True shape of this rank's chunk."""
        return tuple(int(s) for s in self.__comm.chunk(self.__gshape, self.__split)[1])

    @property
    def dtype(self):
        return self.__dtype

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def comm(self) -> Communication:
        return self.__comm

    @property
    def balanced(self) -> bool:
        return True

    @property
    def ndim(self) -> int:
        return 2

    @property
    def gnnz(self) -> int:
        """Global number of stored values."""
        return sum(self._lnnz_host)

    @property
    def nnz(self) -> int:
        return self.gnnz

    @property
    def lnnz(self) -> int:
        """This rank's number of stored values."""
        return self._n

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------
    @property
    def indptr(self) -> torch.Tensor:
        """Global compressed pointers (gathered from every rank)."""
        return _pl.global_indptr(self._comp, self._lnnz_host, self._comp_pad,
                                 self.__gshape[self._compressed_axis], self._dist, self.__comm)

    global_indptr = indptr

    @property
    def gindptr(self) -> torch.Tensor:
        """Alias of :attr:`indptr`."""
        return self.indptr

    @property
    def lindptr(self) -> torch.Tensor:
        """This rank's pointers into its own entries, one per row (CSR) or
        column (CSC) of its padded chunk, plus one."""
        return _pl.lindptr(self._comp, self._comp_pad)

    @property
    def indices(self) -> torch.Tensor:
        """Global uncompressed indices, in global (comp, other) order."""
        return _pl.gather_real(self._other, self._lnnz_host, self._dist, self.__comm)

    @property
    def gindices(self) -> torch.Tensor:
        return self.indices

    @property
    def lindices(self) -> torch.Tensor:
        return self._other[: self._n]

    @property
    def data(self) -> torch.Tensor:
        """Global stored values, in global (comp, other) order."""
        return _pl.gather_real(self._val, self._lnnz_host, self._dist, self.__comm)

    @property
    def gdata(self) -> torch.Tensor:
        return self.data

    @property
    def ldata(self) -> torch.Tensor:
        return self._val[: self._n]

    def is_distributed(self) -> bool:
        """Whether the data is split across more than one rank."""
        return self.__split is not None and self.__comm.size > 1

    def counts_displs_nnz(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank nnz counts and displacements along the compressed axis."""
        counts = self._lnnz_host
        return counts, tuple(int(v) for v in np.cumsum((0,) + counts[:-1]))

    # ------------------------------------------------------------------
    def todense(self):
        """A dense DNDarray, split as the matrix is (CSR rows, CSC columns)."""
        from ..core.dndarray import DNDarray

        ca = self._compressed_axis
        padded = _pl.todense_padded(self._comp, self._other, self._val, self._n, ca, self._comp_pad,
                                    self.__gshape[1 - ca])
        if not self._dist:
            padded = padded[: self.__gshape[0], : self.__gshape[1]]
        return DNDarray(padded, self.__gshape, self.__dtype, self.__split, self.__device, self.__comm)

    to_dense = todense

    def toarray(self) -> np.ndarray:
        return self.todense().numpy()

    def astype(self, dtype) -> "DCSX_matrix":
        dtype = types.canonical_heat_type(dtype)
        return self._with_planes((self._comp, self._other, types._cast(self._val, self.__dtype, dtype)),
                                 self._lnnz_host, self._capacity, dtype=dtype)

    @property
    def T(self):
        """The transpose, CSR <-> CSC: pure metadata, since the planes of A in
        (row, col) order are those of A^T in (col, row) order under the same
        chunking."""
        other_cls = DCSC_matrix if isinstance(self, DCSR_matrix) else DCSR_matrix
        new_split = None if self.__split is None else 1 - self.__split
        return other_cls(self._planes, self._lnnz_host, self._capacity, self._comp_pad,
                         (self.__gshape[1], self.__gshape[0]), self.__dtype, new_split, self.__device, self.__comm)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(gnnz={self.gnnz}, shape={self.__gshape}, "
                f"dtype=ht.{self.__dtype.__name__}, split={self.__split})")

    def __add__(self, other):
        from . import arithmetics

        return arithmetics.add(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        from . import arithmetics

        return arithmetics.mul(self, other)

    __rmul__ = __mul__

    def __matmul__(self, other):
        from . import arithmetics

        return arithmetics.matmul(self, other)

    def __rmatmul__(self, other):
        from . import arithmetics

        return arithmetics.matmul(other, self)

    def sum(self, axis=None):
        from . import arithmetics

        return arithmetics.sum(self, axis=axis)

    def matmul(self, other):
        from . import arithmetics

        return arithmetics.matmul(self, other)


class DCSR_matrix(DCSX_matrix):
    """Row-compressed distributed sparse matrix; split 0 or None."""

    _compressed_axis = 0


class DCSC_matrix(DCSX_matrix):
    """Column-compressed distributed sparse matrix; split 1 or None."""

    _compressed_axis = 1
