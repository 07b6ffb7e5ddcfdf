"""DNDarray: a distributed array held as one padded chunk per rank
(counterpart of heat_tpu/core/dndarray.py).

The JAX package holds one global sharded ``jax.Array``; here each rank holds
its own chunk as a ``torch.Tensor``, as heat itself does, in the canonical
pad-and-mask layout of :mod:`heat_tpu_torch.parallel.comm`: along the split
axis every rank stores ``ceil(extent / size)`` entries, the true ones first.
Pad contents are arbitrary; reductions across the split axis mask them
(:meth:`DNDarray._masked`).  Unsplit arrays are held whole on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.comm import Communication, sanitize_comm
from . import types
from .devices import Device, sanitize_device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]


class DNDarray:
    """Distributed N-dimensional array.

    ``array`` is this rank's PADDED chunk (the whole array when ``split`` is
    None), ``gshape`` the true global shape."""

    def __init__(
        self,
        array: torch.Tensor,
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device: Device,
        comm: Communication,
    ):
        self.__array = array
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = types.canonical_heat_type(dtype)
        self.__split = split
        self.__device = device
        self.__comm = comm

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_dense(
        arr: torch.Tensor,
        split: Optional[int],
        device: Optional[Device] = None,
        comm: Optional[Communication] = None,
    ) -> "DNDarray":
        """Wrap a true-shape global tensor: keep this rank's chunk of the
        canonical layout, padded with zeros, on ``device``."""
        comm = sanitize_comm(comm)
        device = sanitize_device(device)
        arr = arr.to(device.torch_device)
        gshape = tuple(int(s) for s in arr.shape)
        split = sanitize_axis(gshape, split)
        if split is not None:
            _, _, slices = comm.chunk(gshape, split)
            local = arr[slices]
            per = comm.padded_extent(gshape[split]) // comm.size
            pad = per - local.shape[split]
            if pad:
                widths = list(local.shape)
                widths[split] = pad
                local = torch.cat([local, local.new_zeros(widths)], dim=split)
            arr = local.contiguous()
        return DNDarray(arr, gshape, types.canonical_heat_type(arr.dtype), split, device, comm)

    def _like(self, array: torch.Tensor, gshape=None, split="same") -> "DNDarray":
        """A DNDarray on this one's device and comm around a local tensor."""
        return DNDarray(
            array,
            self.__gshape if gshape is None else gshape,
            types.canonical_heat_type(array.dtype),
            self.__split if split == "same" else split,
            self.__device,
            self.__comm,
        )

    def _replace_local(self, dense: torch.Tensor) -> None:
        """Replace the data in place by the true-shape global tensor
        ``dense`` of the same dtype: this rank keeps its chunk of it."""
        self.__array = DNDarray.from_dense(dense, self.__split, self.__device, self.__comm).larray_padded

    # ------------------------------------------------------------------
    # padded / local / dense views
    # ------------------------------------------------------------------
    @property
    def larray_padded(self) -> torch.Tensor:
        """This rank's padded chunk."""
        return self.__array

    @property
    def _pad(self) -> int:
        """Padding entries of this rank's chunk along the split axis."""
        if self.__split is None:
            return 0
        return self.__array.shape[self.__split] - self.lshape[self.__split]

    @property
    def larray(self) -> torch.Tensor:
        """This rank's chunk of the TRUE array (padding sliced off)."""
        if self._pad == 0:
            return self.__array
        return self.__array.narrow(self.__split, 0, self.lshape[self.__split])

    def _masked(self, neutral) -> torch.Tensor:
        """The padded chunk with its padding set to ``neutral``: safe to
        reduce or contract across the split axis."""
        if self._pad == 0:
            return self.__array
        out = self.__array.clone()
        out.narrow(self.__split, self.lshape[self.__split], self._pad).fill_(neutral)
        return out

    def _dense(self) -> torch.Tensor:
        """The true-shape global tensor on every rank (gathers split data)."""
        if self.__split is None or self.__comm.size == 1:
            return self.larray
        full = self.__comm.all_gather(self.__array, axis=self.__split)
        return full.narrow(self.__split, 0, self.__gshape[self.__split])

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def comm(self) -> Communication:
        return self.__comm

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        """Number of true elements."""
        return int(np.prod(self.__gshape, dtype=np.int64)) if self.__gshape else 1

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def T(self) -> "DNDarray":
        """The transpose (2-D arrays): the split moves with its axis."""
        from .linalg import basics

        return basics.transpose(self)

    @property
    def lshape(self) -> Tuple[int, ...]:
        """True shape of this rank's chunk."""
        return tuple(int(s) for s in self.__comm.chunk(self.__gshape, self.__split)[1])

    @property
    def lshape_map(self) -> np.ndarray:
        """(comm.size, ndim) true local shapes per rank: pure metadata."""
        return self.__comm.lshape_map(self.__gshape, self.__split)

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(counts, displacements) along the split axis per rank."""
        if self.__split is None:
            raise ValueError("Non-distributed DNDarray has no counts and displacements")
        counts, displs, _ = self.__comm.counts_displs_shape(self.__gshape, self.__split)
        return tuple(int(c) for c in counts), tuple(int(d) for d in displs)

    # ------------------------------------------------------------------
    # conversion
    # ------------------------------------------------------------------
    def astype(self, dtype) -> "DNDarray":
        """A copy cast to ``dtype``."""
        return self._like(self.__array.to(types.canonical_heat_type(dtype).torch_type()))

    def numpy(self) -> np.ndarray:
        """The full array on the host (a collective when split)."""
        return self._dense().cpu().numpy()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """The full array on the host, for ``np.asarray`` (a collective when split)."""
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self):
        """The value of a one-element array."""
        if self.size != 1:
            raise ValueError(f"only one-element arrays can be converted to Python scalars, got shape {self.__gshape}")
        return self._dense().reshape(()).item()

    def __repr__(self) -> str:
        return f"DNDarray({self.numpy()!r}, dtype=ht.{self.__dtype.__name__}, device={self.__device}, split={self.__split})"

    # ------------------------------------------------------------------
    # operators
    # ------------------------------------------------------------------
    def __add__(self, other):
        from . import arithmetics

        return arithmetics.add(self, other)

    def __radd__(self, other):
        from . import arithmetics

        return arithmetics.add(other, self)

    def __sub__(self, other):
        from . import arithmetics

        return arithmetics.sub(self, other)

    def __rsub__(self, other):
        from . import arithmetics

        return arithmetics.sub(other, self)

    def __mul__(self, other):
        from . import arithmetics

        return arithmetics.mul(self, other)

    def __rmul__(self, other):
        from . import arithmetics

        return arithmetics.mul(other, self)

    def __truediv__(self, other):
        from . import arithmetics

        return arithmetics.div(self, other)

    def __rtruediv__(self, other):
        from . import arithmetics

        return arithmetics.div(other, self)

    def __pow__(self, other):
        from . import arithmetics

        return arithmetics.pow(self, other)

    def __rpow__(self, other):
        from . import arithmetics

        return arithmetics.pow(other, self)

    def __neg__(self):
        from . import arithmetics

        return arithmetics.neg(self)

    def __matmul__(self, other):
        from .linalg import basics

        return basics.matmul(self, other)

    def __eq__(self, other):
        from . import relational

        return relational.eq(self, other)

    def __ne__(self, other):
        from . import relational

        return relational.ne(self, other)

    def __lt__(self, other):
        from . import relational

        return relational.lt(self, other)

    def __le__(self, other):
        from . import relational

        return relational.le(self, other)

    def __gt__(self, other):
        from . import relational

        return relational.gt(self, other)

    def __ge__(self, other):
        from . import relational

        return relational.ge(self, other)

    # element-wise == makes a DNDarray unhashable, as in the reference
    __hash__ = None

    def __bool__(self) -> bool:
        return bool(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __float__(self) -> float:
        return float(self.item())

    def sum(self, axis=None, keepdims: bool = False):
        from . import arithmetics

        return arithmetics.sum(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims: bool = False):
        from . import statistics

        return statistics.mean(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims: bool = False):
        from . import statistics

        return statistics.min(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims: bool = False):
        from . import statistics

        return statistics.max(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims: bool = False):
        from . import statistics

        return statistics.argmin(self, axis=axis, keepdims=keepdims)
