"""DNDarray: a distributed array held as one padded chunk per rank
(counterpart of heat_tpu/core/dndarray.py).

The JAX package holds one global sharded ``jax.Array``; here each rank holds
its own chunk as a ``torch.Tensor``, as heat itself does, in the canonical
pad-and-mask layout of :mod:`heat_tpu_torch.parallel.comm`: along the split
axis every rank stores ``ceil(extent / size)`` entries, the true ones first.
Pad contents are arbitrary; reductions across the split axis mask them
(:meth:`DNDarray._masked`).  Unsplit arrays are held whole on every rank.
The heat type is kept beside the tensor: uint16, uint32 and uint64 are held
in wider signed dtypes (:mod:`.types`).

Indexing follows numpy's rules, and the result's split is the reference's
(:func:`_exact_out_split`).  The reference indexes a dense global view; here
a dense view of split data is a gather, so no key gathers the data:

* a basic key on the split axis (an int, a slice of any step, ``None``,
  ``Ellipsis``) selects each rank's own rows, and one exchange of the
  selected rows (:meth:`Communication.all_to_all_varying`) brings them to
  the canonical layout of the result; an int on the split axis is answered
  by its owner (one broadcast of the selected slice);
* an advanced key (integer arrays, boolean masks, DNDarray keys) is
  gathered: every rank knows the whole key, answers for the positions whose
  rows it owns and sends them to the result's canonical owner in the same
  one exchange.

``__setitem__`` writes in place into each rank's padded chunk, the part of
the key that falls into its own rows, as the reference's fast path
(``_padded_safe_key``) writes into its padded buffer.
"""

from __future__ import annotations

import copy
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..parallel.comm import Communication, _as_bytes, _from_bytes, sanitize_comm
from . import types
from .devices import Device, sanitize_device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]

class _JitArgs(threading.local):
    #: storages of the arguments of the ``ht.jit`` calls running on this
    #: thread
    storages = frozenset()


_JIT_ARGS = _JitArgs()


def _jit_argument_storage(t: torch.Tensor) -> bool:
    """Whether ``t`` shares its storage with an argument of a running
    ``ht.jit`` call (a view of one, or the argument's own tensor)."""
    held = _JIT_ARGS.storages
    return bool(held) and t.untyped_storage().data_ptr() in held


class LocalIndex:
    """The local-index proxy of :attr:`DNDarray.lloc`: indexes this rank's
    chunk of the true array (a torch tensor), and writes into it in place."""

    def __init__(self, arr: "DNDarray"):
        self.__arr = arr

    def __getitem__(self, key):
        return self.__arr.larray[key]

    def __setitem__(self, key, value):
        self.__arr._writable()
        local = self.__arr.larray
        local[key] = torch.as_tensor(value, dtype=local.dtype, device=local.device)


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
        self.__halo_prev = None
        self.__halo_next = None
        self.__target_map = None
        self.__ragged_buffer = None

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_dense(
        arr: torch.Tensor,
        split: Optional[int],
        device: Optional[Device] = None,
        comm: Optional[Communication] = None,
        dtype=None,
    ) -> "DNDarray":
        """Wrap a true-shape global tensor: keep this rank's chunk of the
        canonical layout, padded with zeros, on ``device``.  ``dtype`` is
        the heat type ``arr`` holds (by default its own dtype's).  A tensor
        of torch's own uint16, uint32 or uint64 is stored in its type's
        holding dtype."""
        comm = sanitize_comm(comm)
        device = sanitize_device(device)
        kind = types._TORCH_NAMES.get(arr.dtype)
        if kind is not None:
            arr = arr.view(torch.int64) if kind is types.uint64 else arr.to(kind.torch_type())
            dtype = kind if dtype is None else dtype
        arr = arr.to(device.torch_device)
        gshape = tuple(int(s) for s in arr.shape)
        split = sanitize_axis(gshape, split)
        if split is not None:
            _, _, slices = comm.chunk(gshape, split)
            arr = _pad_along(arr[slices], split, comm.padded_extent(gshape[split]) // comm.size).contiguous()
        dtype = types.canonical_heat_type(arr.dtype) if dtype is None else dtype
        return DNDarray(arr, gshape, dtype, split, device, comm)

    def _like(self, array: torch.Tensor, gshape=None, split="same", dtype=None) -> "DNDarray":
        """A DNDarray on this one's device and comm around a local tensor;
        its heat type is ``dtype``, by default the tensor dtype's own."""
        return DNDarray(
            array,
            self.__gshape if gshape is None else gshape,
            types.canonical_heat_type(array.dtype) if dtype is None else dtype,
            self.__split if split == "same" else split,
            self.__device,
            self.__comm,
        )

    def _replace_local(self, dense: torch.Tensor) -> None:
        """Replace the data in place by the true-shape global tensor
        ``dense`` of the same dtype: this rank keeps its chunk of it.  An
        active ragged layout is dropped."""
        self.__array = DNDarray.from_dense(dense, self.__split, self.__device, self.__comm).larray_padded
        self.__target_map = self.__ragged_buffer = None

    def _unaliased(self) -> "DNDarray":
        """This array, or, where its chunk shares storage with an argument
        of a running ``ht.jit`` call, a copy of it around a clone of that
        chunk (what ``ht.jit`` returns never aliases its arguments)."""
        if not _jit_argument_storage(self.__array):
            return self
        c = copy.copy(self)
        c.__array = self.__array.clone()
        return c

    def _writable(self) -> torch.Tensor:
        """This rank's padded chunk, about to be written in place.  Where it
        shares storage with an argument of a running ``ht.jit`` call (the
        argument itself or any view of it), it is copied first, once;
        any other write into the existing tensor counts as a dispatch
        ``donation``."""
        if _jit_argument_storage(self.__array):
            self.__array = self.__array.clone()
        else:
            from . import dispatch

            dispatch._note_donation()
        return self.__array

    def _replace(self, padded: torch.Tensor, dtype=None) -> None:
        """Replace this rank's padded chunk (same global shape and split).
        New values keep an active ragged layout (``out=`` and in-place
        operations keep the target's distribution) and drop its placed
        rows."""
        self.__array = padded
        self.__ragged_buffer = None
        if dtype is not None:
            self.__dtype = types.canonical_heat_type(dtype)

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
        full = self.__comm.all_gather(_as_bytes(self.__array), axis=self.__split)
        full = _from_bytes(full, self.__array.dtype)
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
    def gnumel(self) -> int:
        """Number of true elements of the global array."""
        return self.size

    @property
    def itemsize(self) -> int:
        """Bytes of one element of the array's type (not of its holding dtype)."""
        return types._itemsize(self.__dtype)

    @property
    def gnbytes(self) -> int:
        """Bytes of the global array's true elements."""
        return self.size * self.itemsize

    @property
    def nbytes(self) -> int:
        return self.gnbytes

    @property
    def lnumel(self) -> int:
        """Number of true elements of this rank's chunk."""
        return int(np.prod(self.lshape, dtype=np.int64)) if self.lshape else 1

    @property
    def lnbytes(self) -> int:
        return self.lnumel * self.itemsize

    @property
    def stride(self) -> Tuple[int, ...]:
        """Element strides of the dense row-major global array."""
        st, acc = [], 1
        for s in reversed(self.__gshape):
            st.append(acc)
            acc *= s
        return tuple(reversed(st))

    @property
    def strides(self) -> Tuple[int, ...]:
        """Byte strides of the dense row-major global array."""
        return tuple(s * self.itemsize for s in self.stride)

    @property
    def lloc(self) -> LocalIndex:
        """Indexing into this rank's chunk of the true array."""
        return LocalIndex(self)

    @property
    def flat(self):
        """An iterator over the global array's elements in row-major order
        (a collective when split)."""
        return iter(self.numpy().ravel())

    def cpu(self) -> "DNDarray":
        """The array on the host: itself where it lies there already."""
        from .devices import cpu

        if self.__device.device_type == "cpu":
            return self
        return DNDarray(self.__array.cpu(), self.__gshape, self.__dtype, self.__split, cpu, self.__comm)

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
        """(comm.size, ndim) true local shapes per rank: pure metadata.  It
        reports an active ragged ``redistribute_`` target."""
        if self.__target_map is not None:
            return self.__target_map.copy()
        return self.__comm.lshape_map(self.__gshape, self.__split)

    def create_lshape_map(self, force_check: bool = False) -> np.ndarray:
        """The (comm.size, ndim) local-shape map: metadata, no communication
        (the layout follows from the global shape, the split, the world and
        an active target map)."""
        return self.lshape_map

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(counts, displacements) along the split axis per rank (those of
        an active ragged target)."""
        if self.__split is None:
            raise ValueError("Non-distributed DNDarray has no counts and displacements")
        if self.__target_map is not None:
            counts = tuple(int(c) for c in self.__target_map[:, self.__split])
            return counts, tuple(int(d) for d in np.cumsum((0,) + counts[:-1]))
        counts, displs, _ = self.__comm.counts_displs_shape(self.__gshape, self.__split)
        return tuple(int(c) for c in counts), tuple(int(d) for d in displs)

    @property
    def balanced(self) -> bool:
        """False while a ragged ``redistribute_`` target is active."""
        return self.__target_map is None

    def is_balanced(self, force_check: bool = False) -> bool:
        """False only while a ragged ``redistribute_`` target is active: the
        compute layout is always the canonical one."""
        return self.__target_map is None

    def is_distributed(self) -> bool:
        """Whether the data lies on more than one rank."""
        return self.__split is not None and self.__comm.size > 1

    # ------------------------------------------------------------------
    # conversion
    # ------------------------------------------------------------------
    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """The array cast to ``dtype`` (in place with ``copy=False``), with
        the reference's values: integers wrap, floats truncate toward zero."""
        dtype = types.canonical_heat_type(dtype)
        cast = types._cast(self.__array, self.__dtype, dtype)
        if not copy:
            self.__array, self.__dtype = cast, dtype
            self.__ragged_buffer = None
            return self
        if cast is self.__array:
            cast = cast.clone()
        return self._like(cast, dtype=dtype)

    def numpy(self) -> np.ndarray:
        """The full array on the host (a collective when split); bfloat16
        comes as float32, which numpy has."""
        dense = self._dense()
        if dense.dtype == torch.bfloat16:
            dense = dense.float()
        return types._from_holding(dense.cpu().numpy(), self.__dtype)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """The full array on the host, for ``np.asarray`` (a collective when split)."""
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def tolist(self) -> list:
        """The full array as nested python lists."""
        return self.numpy().tolist()

    def item(self):
        """The value of a one-element array."""
        if self.size != 1:
            raise ValueError(f"only one-element arrays can be converted to Python scalars, got shape {self.__gshape}")
        return self.numpy().reshape(()).item()

    def copy(self) -> "DNDarray":
        """A copy: the same values, split and type in new memory."""
        return self._like(self.__array.clone(), dtype=self.__dtype)

    def __repr__(self) -> str:
        override = getattr(type(self), "__repr_override__", None)
        if override is not None:  # installed by printing.set_string_function
            return override(self)
        from . import printing

        return printing.__str__(self)

    def __str__(self) -> str:
        override = getattr(type(self), "__str_override__", None)
        if override is not None:
            return override(self)
        return self.__repr__()

    # ------------------------------------------------------------------
    # distribution
    # ------------------------------------------------------------------
    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """Re-split in place along ``axis`` (None: whole on every rank).

        split -> None is one all-gather; None -> split keeps this rank's
        slice; split -> split is one all-to-all: each rank pads the new axis
        to the canonical extent, cuts it into one block per rank, and
        concatenates the blocks it receives along the old axis."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return self
        self.__array = self._resplit_tensor(axis)
        self.__split = axis
        self.__halo_prev = self.__halo_next = None
        self.__target_map = self.__ragged_buffer = None
        return self

    def reshard_(self, comm: Optional[Communication] = None) -> "DNDarray":
        """Move in place onto another communication, keeping the global value
        and the split: the elastic-resume primitive, after
        :meth:`Communication.reshape` replaced the world.

        Onto a communication that ``self.comm.reshape`` made, the rows move
        by one exchange over the old communication, on which every rank is
        still alive and calls this: a rank that leaves hands over its rows
        (and keeps none), a rank that stays receives the rows of its new
        canonical chunk.  An unsplit array stays whole on every rank.  Onto
        any other communication this rank's chunk is cut from the gathered
        value.  No-op onto this array's own communication."""
        comm = sanitize_comm(comm)
        old = self.__comm
        if comm is old:
            return self
        split, gshape = self.__split, self.__gshape
        if split is None:
            pass
        elif comm._origin is not None and comm._origin[0] is old:
            ranks = comm._origin[1]
            new_rank = {r: i for i, r in enumerate(ranks)}
            runs = [old.chunk(gshape, split, rank=r)[:2] for r in range(old.size)]
            runs = [(off, lsh[split]) for off, lsh in runs]
            ranges = []
            for r in range(old.size):
                if r in new_rank:
                    off, lsh, _ = comm.chunk(gshape, split, rank=new_rank[r])
                    ranges.append((off, off + lsh[split]))
                else:
                    ranges.append((gshape[split], gshape[split]))
            rows = _move_rows(old, self.larray, split, runs, ranges)
            per = comm.padded_extent(gshape[split]) // comm.size if comm.is_member else 0
            self.__array = _pad_along(rows, split, per).contiguous()
        else:
            dense = self._dense()
            self.__array = DNDarray.from_dense(dense, split, self.__device, comm, self.__dtype).larray_padded
        self.__comm = comm
        self.__halo_prev = self.__halo_next = None
        self.__target_map = self.__ragged_buffer = None
        return self

    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """A copy re-split along ``axis``; the same data when it is split so."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return DNDarray(self.__array, self.__gshape, self.__dtype, self.__split, self.__device, self.__comm)
        return DNDarray(self._resplit_tensor(axis), self.__gshape, self.__dtype, axis, self.__device, self.__comm)

    def _resplit_tensor(self, axis: Optional[int]) -> torch.Tensor:
        """This rank's padded chunk of the array split along ``axis``."""
        comm, old = self.__comm, self.__split
        if axis is None:
            return self._dense()
        per = comm.padded_extent(self.__gshape[axis]) // comm.size
        if old is None or comm.size == 1:
            whole = self.larray if old is None else self.__array.narrow(old, 0, self.__gshape[old])
            _, _, slices = comm.chunk(self.__gshape, axis)
            return _pad_along(whole[slices], axis, per).contiguous()
        x = _pad_along(self.__array, axis, comm.padded_extent(self.__gshape[axis]))
        got = comm.all_to_all_varying([_as_bytes(b) for b in torch.tensor_split(x, comm.size, dim=axis)],
                                      [x.shape[old]] * comm.size, old)
        full = _from_bytes(torch.cat(got, dim=old), x.dtype)
        return full.narrow(old, 0, self.__gshape[old]).contiguous()

    def collect_(self, target_rank: int = 0) -> "DNDarray":
        """The full array onto every rank: ``resplit_(None)``."""
        return self.resplit_(None)

    # ------------------------------------------------------------------
    # ragged layouts: a target map over the canonical compute layout
    # ------------------------------------------------------------------
    def balance_(self) -> "DNDarray":
        """Back to the canonical (balanced) distribution: drops a ragged
        ``redistribute_`` target.  The canonical chunks never moved, so no
        data moves."""
        self.__target_map = self.__ragged_buffer = None
        return self

    @staticmethod
    def _as_host_int_map(m, name: str) -> np.ndarray:
        """A map argument (DNDarray, tensor, numpy or list) as a host int64
        array; TypeError for anything that is not numeric."""
        if isinstance(m, DNDarray):
            m = m.numpy()
        elif isinstance(m, torch.Tensor):
            m = m.detach().cpu().numpy()
        arr = np.asarray(m)
        if not np.issubdtype(arr.dtype, np.number):
            raise TypeError(f"{name} must be an integer array, got {arr.dtype}")
        return arr.astype(np.int64)

    def redistribute_(self, lshape_map=None, target_map=None) -> "DNDarray":
        """Give the array the layout ``target_map`` ((comm.size, ndim): each
        rank's rows along the split axis; only its split column counts).

        The canonical padded chunks stay the compute layout; the target is
        metadata that ``lshape_map``, ``counts_displs`` and
        ``__partitioned__`` report, and the rows of each rank's target
        block reach that rank only when ``__partitioned__`` reads them (one
        exchange).  No target balances; a canonical target is a no-op that
        drops any ragged layout; an unsplit array stays as it is."""
        ndim = max(self.ndim, 1)
        size = self.__comm.size
        if lshape_map is not None:
            lm = self._as_host_int_map(lshape_map, "lshape_map")
            if lm.shape != (size, ndim):
                raise ValueError(f"lshape_map must have shape ({size}, {self.ndim}), got {lm.shape}")
        if target_map is None:
            return self.balance_()
        tm = self._as_host_int_map(target_map, "target_map")
        if tm.shape != (size, ndim):
            raise ValueError(f"target_map must have shape ({size}, {self.ndim}), got {tm.shape}")
        if self.__split is None:
            return self
        extent = self.__gshape[self.__split]
        counts = tm[:, self.__split]
        if (counts < 0).any() or int(counts.sum()) != extent:
            raise ValueError(f"target_map must distribute all {extent} rows of axis {self.__split}, got counts "
                             f"{counts.tolist()}")
        canonical = self.__comm.lshape_map(self.__gshape, self.__split)
        if (counts == canonical[:, self.__split]).all():
            return self.balance_()
        full = np.tile(np.asarray(self.__gshape, np.int64), (size, 1))
        full[:, self.__split] = counts
        self.__target_map = full
        self.__ragged_buffer = None
        return self

    @property
    def _active_target_map(self) -> Optional[np.ndarray]:
        """The ragged target map, or None when the array is balanced."""
        return self.__target_map

    def _propagate_layout_from(self, *sources) -> "DNDarray":
        """Adopt the layout of the first source of this result's global shape
        and split (the lhs operand first): its ragged target, or its
        balance.  Shape-changing results have no such source and stay
        balanced."""
        for src in sources:
            if not isinstance(src, DNDarray) or src.split != self.__split or src.shape != self.__gshape:
                continue
            tm = src._active_target_map
            if tm is not None:
                self.__target_map = tm.copy()
                self.__ragged_buffer = None
            return self
        return self

    @property
    def _ragged_layout(self):
        """``(target map, this rank's target rows)`` while a ragged target is
        active, else None.  The rows are placed on first use by one
        exchange from the canonical chunks (a collective: every rank asks)
        and kept until the values or the layout change."""
        if self.__target_map is None:
            return None
        if self.__ragged_buffer is None:
            comm, s = self.__comm, self.__split
            counts = self.__target_map[:, s]
            starts = np.concatenate([[0], np.cumsum(counts)])
            runs = [_owned(comm, self.__gshape, s, r) for r in range(comm.size)]
            ranges = [(int(starts[r]), int(starts[r + 1])) for r in range(comm.size)]
            self.__ragged_buffer = _move_rows(comm, self.larray, s, [(lo, hi - lo) for lo, hi in runs], ranges)
        return self.__target_map, self.__ragged_buffer

    def create_partition_interface(self) -> dict:
        """The ``__partitioned__`` dict: start, shape and location of every
        rank's partition (the ragged target's where one is active) and the
        data of this rank's own, as a tensor.  Placing a ragged target's
        rows is a collective: every rank builds the dict."""
        lmap = self.lshape_map
        starts = np.zeros_like(lmap)
        if self.__split is not None:
            starts[1:, self.__split] = np.cumsum(lmap[:-1, self.__split])
        layout = self._ragged_layout
        mine = layout[1] if layout is not None else self.larray
        rest = (0,) * max(self.ndim - 1, 0)
        partitions = {}
        for r in range(self.__comm.size):
            partitions[(r,) + rest] = {
                "start": tuple(int(v) for v in starts[r]),
                "shape": tuple(int(v) for v in lmap[r]),
                "data": mine if r == self.__comm.rank or self.__split is None else None,
                "location": [r],
                "dtype": np.dtype(types.numpy_type(self.__dtype)),
            }
        grid = [1] * max(self.ndim, 1)
        if self.__split is not None:
            grid[self.__split] = self.__comm.size
        return {
            "shape": self.__gshape,
            "partition_tiling": tuple(grid),
            "partitions": partitions,
            "locals": [(self.__comm.rank,) + rest],
            "get": lambda h: h() if callable(h) else h,
        }

    @property
    def __partitioned__(self) -> dict:
        """The partition interface (:meth:`create_partition_interface`)."""
        return self.create_partition_interface()

    # ------------------------------------------------------------------
    # halos
    # ------------------------------------------------------------------
    def get_halo(self, halo_size: int) -> None:
        """Fetch ``halo_size`` rows along the split axis from each neighbour
        rank: the previous rank's last true rows (``halo_prev``) and the
        next rank's first (``halo_next``), each by one ``ppermute`` of the
        edge rows; None where there is no neighbour."""
        if not isinstance(halo_size, int):
            raise TypeError(f"halo_size needs to be an integer, found {type(halo_size)}")
        if halo_size < 0:
            raise ValueError(f"halo_size needs to be a non-negative integer, got {halo_size}")
        self.__halo_prev = self.__halo_next = None
        if self.__split is None:
            return
        s, comm = self.__split, self.__comm
        smallest = int(comm.lshape_map(self.__gshape, s)[:, s].min())  # the canonical chunks, whatever the target
        if halo_size > smallest:
            raise ValueError(f"halo_size {halo_size} needs to be smaller than the smallest local chunk {smallest}")
        start, lshape, _ = comm.chunk(self.__gshape, s)
        stop = start + lshape[s]
        local = self.larray
        n = comm.size
        last = _as_bytes(local.narrow(s, lshape[s] - halo_size, halo_size))
        first = _as_bytes(local.narrow(s, 0, halo_size))
        from_prev = comm.ppermute(last, [(i, i + 1) for i in range(n - 1)])
        from_next = comm.ppermute(first, [(i, i - 1) for i in range(1, n)])
        if start > 0:
            self.__halo_prev = _from_bytes(from_prev, local.dtype)
        if stop < self.__gshape[s]:
            self.__halo_next = _from_bytes(from_next, local.dtype)

    @property
    def halo_prev(self) -> Optional[torch.Tensor]:
        return self.__halo_prev

    @property
    def halo_next(self) -> Optional[torch.Tensor]:
        return self.__halo_next

    @property
    def array_with_halos(self) -> torch.Tensor:
        """This rank's true chunk between its fetched halos."""
        pieces = [p for p in (self.__halo_prev, self.larray, self.__halo_next) if p is not None]
        if len(pieces) == 1:
            return pieces[0]
        return torch.cat(pieces, dim=self.__split if self.__split is not None else 0)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def __getitem__(self, key) -> "DNDarray":
        key_t, out_split = _convert_key(self, key)
        comm, split = self.__comm, self.__split
        if _scalar_bool_key(key_t):
            # numpy's degenerate advanced case (a new axis of 1 or 0): on
            # the dense view, as the reference
            res = self._dense()[_torch_key(key_t, self.__array.device)]
            return DNDarray.from_dense(res, 0 if res.ndim else None, self.__device, comm, self.__dtype)
        comps, layout, shape = _index_plan(self.__gshape, key_t, self.__array.device)
        if split is None or comm.size == 1:
            res = _apply(self.larray, comps)
            split_out = out_split if out_split is not None and out_split < res.ndim else None
            if split is None:
                return DNDarray(res, res.shape, self.__dtype, None, self.__device, comm)
            return DNDarray.from_dense(res, split_out, self.__device, comm, self.__dtype)
        owner_axis = _consumer(comps, split)
        kind = comps[owner_axis][0]
        if kind == "int" or (kind == "arr" and comps[owner_axis][1].ndim == 0):
            res = self._owner_select(comps, owner_axis)
            return DNDarray(res, res.shape, self.__dtype, None, self.__device, comm)
        if kind == "slice":
            local, axis = self._slice_select(comps, owner_axis, layout, shape)
        else:
            local, axis = self._advanced_select(comps, owner_axis, layout, shape)
        out = DNDarray(local, shape, self.__dtype, axis, self.__device, comm)
        want = out_split if out_split is not None and out_split < len(shape) else None
        return out if want == axis else out.resplit_(want)

    def _owner_select(self, comps, owner_axis: int) -> torch.Tensor:
        """An int key on the split axis: its owner selects, one broadcast."""
        comm, split = self.__comm, self.__split
        i = int(comps[owner_axis][1])
        per = comm.padded_extent(self.__gshape[split]) // comm.size
        owner = i // per
        local = list(comps)
        local[owner_axis] = ("int", i - owner * per if comm.rank == owner else 0)
        res = _apply(self.__array, local).contiguous()
        return _from_bytes(comm.bcast(_as_bytes(res), owner), res.dtype)

    def _slice_select(self, comps, owner_axis: int, layout, shape) -> Tuple[torch.Tensor, int]:
        """A slice on the split axis: each rank its own selected rows, then
        one exchange to the result's canonical layout along the split axis's
        place in the result."""
        comm, split = self.__comm, self.__split
        _, first, count, step = comps[owner_axis]
        axis = layout.index(("in", split))
        runs = [_slice_run(first, count, step, *_owned(comm, self.__gshape, split, r)) for r in range(comm.size)]
        p0, n, lo = runs[comm.rank]
        local = list(comps)
        local[owner_axis] = ("slice", first + p0 * step - lo, n, step)
        mine = _apply(self.__array, local)
        return _runs_to_canonical(comm, mine, axis, [(p, c) for p, c, _ in runs], shape[axis]), axis

    def _advanced_select(self, comps, owner_axis: int, layout, shape) -> Tuple[torch.Tensor, int]:
        """An index array on the split axis: every rank answers the
        positions whose rows it owns; one exchange sends each answer to the
        result's canonical owner along the index block's first axis."""
        comm = self.__comm
        local, block, owners, _ = self._own_positions(comps, owner_axis)
        axis = layout.index(("adv", 0))
        mine = _apply(self.__array, local)
        rest = int(np.prod(block[1:], dtype=np.int64))
        ranges = [tuple(x * rest for x in _owned(comm, (block[0],), 0, r)) for r in range(comm.size)]
        got = _positions_to_ranges(comm, mine, axis, owners, ranges)
        lshape = list(shape)
        lshape[axis] = comm.chunk((block[0],), 0)[1][0]
        got = got.reshape(lshape)
        return _pad_along(got, axis, comm.padded_extent(block[0]) // comm.size).contiguous(), axis

    def _own_positions(self, comps, owner_axis: int):
        """``(local comps, block, owners, sel)`` of an advanced key on the
        split axis: the index arrays broadcast to ``block`` and flattened,
        the rank that holds each position's row (``owners``), this rank's
        positions (``sel``, increasing) and the key restricted to them in
        this rank's coordinates."""
        comm = self.__comm
        arrays = [i for i, c in enumerate(comps) if c[0] == "arr"]
        block = torch.broadcast_shapes(*(comps[i][1].shape for i in arrays))
        flat = {i: comps[i][1].expand(block).reshape(-1) for i in arrays}
        per = comm.padded_extent(self.__gshape[self.__split]) // comm.size
        owners = torch.div(flat[owner_axis], per, rounding_mode="floor")
        sel = torch.nonzero(owners == comm.rank)[:, 0]
        local = list(comps)
        for i in arrays:
            local[i] = ("arr", flat[i][sel] - (comm.rank * per if i == owner_axis else 0))
        return local, block, owners, sel

    def __setitem__(self, key, value):
        self.__ragged_buffer = None  # new values: a ragged target's rows are placed again
        key_t, _ = _convert_key(self, key)
        comm, split = self.__comm, self.__split
        dev = self.__array.device
        value = _value_tensor(value, self.__dtype, dev)
        if _scalar_bool_key(key_t):
            dense = self._dense().clone()
            dense[_torch_key(key_t, dev)] = value
            self.__array = DNDarray.from_dense(dense, split, self.__device, comm, self.__dtype).larray_padded
            return
        comps, layout, shape = _index_plan(self.__gshape, key_t, dev)
        value = torch.broadcast_to(value, shape)
        if split is None or comm.size == 1:
            _assign(self._writable(), comps, layout, value)
            return
        owner_axis = _consumer(comps, split)
        kind = comps[owner_axis][0]
        per = comm.padded_extent(self.__gshape[split]) // comm.size
        local = list(comps)
        if kind == "int" or (kind == "arr" and comps[owner_axis][1].ndim == 0):
            i = int(comps[owner_axis][1])
            if i // per == comm.rank:
                local[owner_axis] = ("int", i - comm.rank * per)
                _assign(self._writable(), local, layout, value)
            return
        if kind == "slice":
            _, first, count, step = comps[owner_axis]
            lo, hi = _owned(comm, self.__gshape, split, comm.rank)
            p0, n, _ = _slice_run(first, count, step, lo, hi)
            if n:
                local[owner_axis] = ("slice", first + p0 * step - lo, n, step)
                axis = layout.index(("in", split))
                _assign(self._writable(), local, layout, value.narrow(axis, p0, n))
            return
        local, block, _, sel = self._own_positions(comps, owner_axis)
        if not sel.numel():
            return
        axis = layout.index(("adv", 0))
        nb = len(block)
        flat_value = value.reshape(shape[:axis] + (-1,) + shape[axis + nb:])
        _assign(self._writable(), local, layout, flat_value.index_select(axis, sel))

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __contains__(self, item) -> bool:
        """numpy's membership: ``(a == item).any()``; an item that does not
        compare gives False."""
        from . import logical, relational

        try:
            return bool(logical.any(relational.eq(self, item)))
        except TypeError:
            return False

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

    def __floordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(self, other)

    def __rfloordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(other, self)

    def __mod__(self, other):
        from . import arithmetics

        return arithmetics.mod(self, other)

    def __rmod__(self, other):
        from . import arithmetics

        return arithmetics.mod(other, self)

    def __divmod__(self, other):
        """``(self // other, self % other)`` element-wise."""
        from . import arithmetics

        return arithmetics.divmod(self, other)

    def __rdivmod__(self, other):
        from . import arithmetics

        return arithmetics.divmod(other, self)

    def __neg__(self):
        from . import arithmetics

        return arithmetics.neg(self)

    def __pos__(self):
        from . import arithmetics

        return arithmetics.pos(self)

    def __abs__(self):
        from . import rounding

        return rounding.abs(self)

    def __matmul__(self, other):
        from .linalg import basics

        if not isinstance(other, (DNDarray, np.ndarray, torch.Tensor)) and hasattr(other, "__rmatmul__"):
            return NotImplemented  # another array type's product (a sparse matrix's): its __rmatmul__
        return basics.matmul(self, other)

    def __invert__(self):
        from . import arithmetics

        return arithmetics.invert(self)

    def __and__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_and(self, other)

    __rand__ = __and__

    def __or__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_or(self, other)

    __ror__ = __or__

    def __xor__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_xor(self, other)

    __rxor__ = __xor__

    def __lshift__(self, other):
        from . import arithmetics

        return arithmetics.left_shift(self, other)

    def __rshift__(self, other):
        from . import arithmetics

        return arithmetics.right_shift(self, other)

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

    def __complex__(self) -> complex:
        return complex(self.item())

    # in-place operators: the result stored back, cast to this array's type
    def __iadd__(self, other):
        from . import arithmetics

        return arithmetics._inplace(self, arithmetics.add(self, other))

    def __isub__(self, other):
        from . import arithmetics

        return arithmetics._inplace(self, arithmetics.sub(self, other))

    def __imul__(self, other):
        from . import arithmetics

        return arithmetics._inplace(self, arithmetics.mul(self, other))

    def __itruediv__(self, other):
        from . import arithmetics

        return arithmetics._inplace(self, arithmetics.div(self, other))

    def __ifloordiv__(self, other):
        from . import arithmetics

        return arithmetics._inplace(self, arithmetics.floordiv(self, other))

    def __imod__(self, other):
        from . import arithmetics

        return arithmetics._inplace(self, arithmetics.mod(self, other))

    def __ipow__(self, other):
        from . import arithmetics

        return arithmetics._inplace(self, arithmetics.pow(self, other))

    def __iand__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_and_(self, other)

    def __ior__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_or_(self, other)

    def __ixor__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_xor_(self, other)

    def __ilshift__(self, other):
        from . import arithmetics

        return arithmetics.left_shift_(self, other)

    def __irshift__(self, other):
        from . import arithmetics

        return arithmetics.right_shift_(self, other)

    # ------------------------------------------------------------------
    # methods of the operations
    # ------------------------------------------------------------------
    @property
    def real(self) -> "DNDarray":
        from . import complex_math

        return complex_math.real(self)

    @property
    def imag(self) -> "DNDarray":
        from . import complex_math

        return complex_math.imag(self)

    def abs(self, out=None, dtype=None):
        from . import rounding

        return rounding.abs(self, out, dtype)

    def all(self, axis=None, out=None, keepdims: bool = False):
        from . import logical

        return logical.all(self, axis, out, keepdims)

    def any(self, axis=None, out=None, keepdims: bool = False):
        from . import logical

        return logical.any(self, axis, out, keepdims)

    def argmax(self, axis=None, out=None, **kwargs):
        from . import statistics

        return statistics.argmax(self, axis, out, **kwargs)

    def argmin(self, axis=None, out=None, **kwargs):
        from . import statistics

        return statistics.argmin(self, axis, out, **kwargs)

    def ceil(self, out=None):
        from . import rounding

        return rounding.ceil(self, out)

    def clip(self, min=None, max=None, out=None):
        from . import rounding

        return rounding.clip(self, min, max, out)

    def cos(self, out=None):
        from . import trigonometrics

        return trigonometrics.cos(self, out)

    def cumprod(self, axis, dtype=None, out=None):
        from . import arithmetics

        return arithmetics.cumprod(self, axis, dtype, out)

    def cumsum(self, axis, dtype=None, out=None):
        from . import arithmetics

        return arithmetics.cumsum(self, axis, dtype, out)

    def exp(self, out=None):
        from . import exponential

        return exponential.exp(self, out)

    def expand_dims(self, axis):
        from . import manipulations

        return manipulations.expand_dims(self, axis)

    def fill_diagonal(self, value) -> "DNDarray":
        """Write ``value`` on the main diagonal of a 2-D array, in place: each
        rank writes the diagonal entries of its own rows."""
        if self.ndim != 2:
            raise ValueError("fill_diagonal requires a 2-D array")
        n = min(self.__gshape)
        self.__ragged_buffer = None
        lo, hi = (0, n) if self.__split is None else _owned(self.__comm, self.__gshape, self.__split, self.__comm.rank)
        i = torch.arange(max(lo, 0), min(hi, n), device=self.__array.device)
        if i.numel():
            v = _value_tensor(value, self.__dtype, self.__array.device)
            rows, cols = (i - lo, i) if self.__split == 0 else ((i, i - lo) if self.__split == 1 else (i, i))
            self._writable()[rows, cols] = v.to(self.__array.dtype)
        return self

    def flatten(self):
        from . import manipulations

        return manipulations.flatten(self)

    def floor(self, out=None):
        from . import rounding

        return rounding.floor(self, out)

    def log(self, out=None):
        from . import exponential

        return exponential.log(self, out)

    def max(self, axis=None, out=None, keepdims: bool = False):
        from . import statistics

        return statistics.max(self, axis, out, keepdims)

    def mean(self, axis=None, keepdims: bool = False):
        from . import statistics

        return statistics.mean(self, axis, keepdims=keepdims)

    def median(self, axis=None, keepdims: bool = False):
        from . import statistics

        return statistics.median(self, axis, keepdims)

    def min(self, axis=None, out=None, keepdims: bool = False):
        from . import statistics

        return statistics.min(self, axis, out, keepdims)

    def prod(self, axis=None, out=None, keepdims: bool = False):
        from . import arithmetics

        return arithmetics.prod(self, axis, out, keepdims)

    def ravel(self):
        from . import manipulations

        return manipulations.ravel(self)

    def reshape(self, *shape, new_split=None):
        from . import manipulations

        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return manipulations.reshape(self, shape, new_split=new_split)

    def round(self, decimals: int = 0, out=None, dtype=None):
        from . import rounding

        return rounding.round(self, decimals, out, dtype)

    def sin(self, out=None):
        from . import trigonometrics

        return trigonometrics.sin(self, out)

    def sqrt(self, out=None):
        from . import exponential

        return exponential.sqrt(self, out)

    def squeeze(self, axis=None):
        from . import manipulations

        return manipulations.squeeze(self, axis)

    def std(self, axis=None, ddof: int = 0, **kwargs):
        from . import statistics

        return statistics.std(self, axis, ddof=ddof, **kwargs)

    def sum(self, axis=None, out=None, keepdims: bool = False):
        from . import arithmetics

        return arithmetics.sum(self, axis, out, keepdims)

    def tan(self, out=None):
        from . import trigonometrics

        return trigonometrics.tan(self, out)

    def transpose(self, axes=None):
        from .linalg import basics

        return basics.transpose(self, axes)

    def tril(self, k: int = 0):
        from .linalg import basics

        return basics.tril(self, k)

    def triu(self, k: int = 0):
        from .linalg import basics

        return basics.triu(self, k)

    def trunc(self, out=None):
        from . import rounding

        return rounding.trunc(self, out)

    def unique(self, sorted: bool = False, return_inverse: bool = False, axis=None):
        from . import manipulations

        return manipulations.unique(self, sorted, return_inverse, axis)

    def var(self, axis=None, ddof: int = 0, **kwargs):
        from . import statistics

        return statistics.var(self, axis, ddof=ddof, **kwargs)


# ----------------------------------------------------------------------
# layout helpers
# ----------------------------------------------------------------------
def _owned(comm, gshape, axis: int, rank: int) -> Tuple[int, int]:
    """``(lo, hi)``: the global indices along ``axis`` that ``rank`` holds."""
    lo, lshape, _ = comm.chunk(gshape, axis, rank=rank)
    return lo, lo + lshape[axis]


def _pad_along(x: torch.Tensor, axis: int, extent: int) -> torch.Tensor:
    """``x`` zero-padded along ``axis`` to ``extent`` entries."""
    pad = extent - x.shape[axis]
    if pad <= 0:
        return x
    widths = list(x.shape)
    widths[axis] = pad
    return torch.cat([x, x.new_zeros(widths)], dim=axis)


def _runs_to_canonical(comm, mine: torch.Tensor, axis: int, runs, extent: int) -> torch.Tensor:
    """This rank's padded chunk of a result whose rows along ``axis`` rank
    r holds as the run ``runs[r] = (first position, count)`` (``mine``):
    one exchange moves every row to its canonical owner."""
    per = comm.padded_extent(extent) // comm.size
    ranges = [(min(d * per, extent), min((d + 1) * per, extent)) for d in range(comm.size)]
    return _pad_along(_move_rows(comm, mine, axis, runs, ranges), axis, per).contiguous()


def _move_rows(comm, mine: torch.Tensor, axis: int, runs, ranges) -> torch.Tensor:
    """Rows along ``axis`` that rank r holds as the run ``runs[r] = (first
    position, count)`` (``mine``: this rank's) go to the rank whose range
    ``ranges[d] = (lo, hi)`` covers them, by one exchange: this rank's rows
    of its own range, in order."""

    def overlap(run, rng):
        lo, hi = max(run[0], rng[0]), min(run[0] + run[1], rng[1])
        return lo, max(0, hi - lo)

    me = comm.rank
    blocks = []
    for d in range(comm.size):
        lo, n = overlap(runs[me], ranges[d])
        blocks.append(_as_bytes(mine.narrow(axis, lo - runs[me][0] if n else 0, n)))
    recv = [overlap(runs[s], ranges[me]) for s in range(comm.size)]
    got = comm.all_to_all_varying(blocks, [n for _, n in recv], axis)
    pieces = sorted(((lo, g) for (lo, n), g in zip(recv, got) if n), key=lambda p: p[0])
    rows = [_from_bytes(g, mine.dtype) for _, g in pieces]
    return torch.cat(rows, dim=axis) if rows else mine.narrow(axis, 0, 0)


def _positions_to_ranges(comm, mine: torch.Tensor, axis: int, owners: torch.Tensor, ranges) -> torch.Tensor:
    """Rows along ``axis`` at flat positions: ``owners[p]`` is the rank that
    holds position p, and ``mine`` holds this rank's positions in increasing
    order.  One exchange gives this rank the rows of its range
    ``ranges[rank] = (lo, hi)``, in order."""
    me = comm.rank
    mine_pos = torch.nonzero(owners == me)[:, 0]
    blocks = []
    for lo, hi in ranges:
        take = torch.nonzero((mine_pos >= lo) & (mine_pos < hi))[:, 0]
        blocks.append(_as_bytes(mine.index_select(axis, take)))
    lo, hi = ranges[me]
    want = owners[lo:hi]
    counts = [int((want == s).sum()) for s in range(comm.size)]
    got = comm.all_to_all_varying(blocks, counts, axis)
    shape = list(mine.shape)
    shape[axis] = hi - lo
    out = mine.new_empty(shape)
    for s, g in enumerate(got):
        if counts[s]:
            out.index_copy_(axis, torch.nonzero(want == s)[:, 0], _from_bytes(g, mine.dtype))
    return out


# ----------------------------------------------------------------------
# keys
# ----------------------------------------------------------------------
def _is_array(k) -> bool:
    return isinstance(k, (torch.Tensor, np.ndarray))


def _is_bool_array(k) -> bool:
    return _is_array(k) and (k.dtype == torch.bool if isinstance(k, torch.Tensor) else k.dtype == np.bool_)


def _convert_key(arr: DNDarray, key):
    """Normalize an indexing key (DNDarray keys gathered as tensors, lists
    as numpy arrays) and compute the reference's output split for it."""

    def conv(k):
        if isinstance(k, DNDarray):
            d = k._dense()
            if k.dtype in types._WIDENED:
                d = types._cast(d, k.dtype, types.int64)
            return d
        if isinstance(k, list):
            return np.asarray(k)
        return k

    key_t = tuple(conv(k) for k in key) if isinstance(key, tuple) else conv(key)
    return key_t, _exact_out_split(arr, key_t)


def _exact_out_split(arr: DNDarray, key_t) -> Optional[int]:
    """Where the input's split dimension lands in the indexed output, by the
    reference's rules (heat_tpu/core/dndarray.py::_exact_out_split): ints
    remove dims, slices map them through, newaxis inserts, a boolean mask of
    ndim k consumes k dims, and the advanced block sits at the first
    advanced key when the advanced keys are adjacent, else at the front.
    An int on the split dim gives None; an advanced key on it gives the
    block's position."""
    split = arr.split
    if split is None:
        return None
    keys = list(key_t) if isinstance(key_t, tuple) else [key_t]
    norm = []
    for k in keys:
        if isinstance(k, (list, tuple)):
            k = np.asarray(k)
        if isinstance(k, (bool, np.bool_)) or (_is_bool_array(k) and k.ndim == 0):
            return 0  # scalar-bool key: degenerate advanced case
        norm.append(k)

    def consumed(k) -> int:
        if k is None:
            return 0
        if _is_bool_array(k):
            return int(k.ndim)
        return 1

    n_explicit = sum(consumed(k) for k in norm if k is not Ellipsis)
    expanded = []
    for k in norm:
        if k is Ellipsis:
            expanded.extend([slice(None)] * (arr.ndim - n_explicit))
        else:
            expanded.append(k)
    expanded.extend([slice(None)] * (arr.ndim - sum(consumed(k) for k in expanded)))

    adv_positions = [i for i, k in enumerate(expanded) if _is_array(k)]
    adv_present = bool(adv_positions)
    if adv_present:
        ranks = [1 if _is_bool_array(expanded[i]) else int(expanded[i].ndim) for i in adv_positions]
        nb = max(ranks)
        contiguous = adv_positions[-1] - adv_positions[0] + 1 == len(adv_positions)

    basic_out = []
    first_adv_basic_count = None
    in_dim = 0
    split_fate = "kept"
    for k in expanded:
        if k is None:
            basic_out.append(("new",))
            continue
        if _is_array(k):
            if first_adv_basic_count is None:
                first_adv_basic_count = len(basic_out)
            c = consumed(k)
            if in_dim <= split < in_dim + c:
                split_fate = "adv"
            in_dim += c
            continue
        if isinstance(k, slice):
            basic_out.append(("in", in_dim))
            in_dim += 1
            continue
        if in_dim == split:
            split_fate = "int"
        in_dim += 1

    if split_fate == "int":
        return None
    if adv_present:
        insert_at = first_adv_basic_count if contiguous else 0
        if split_fate == "adv":
            return insert_at if nb > 0 else None
        pos = basic_out.index(("in", split))
        return pos + (nb if pos >= insert_at else 0)
    return basic_out.index(("in", split))


def _scalar_bool_key(key_t) -> bool:
    keys = key_t if isinstance(key_t, tuple) else (key_t,)
    return any(isinstance(k, (bool, np.bool_)) or (_is_bool_array(k) and k.ndim == 0) for k in keys)


def _torch_key(key_t, device):
    """The key with numpy arrays as tensors on ``device`` (for torch's own
    indexing of a dense tensor)."""
    def conv(k):
        if isinstance(k, np.ndarray):
            return torch.from_numpy(k).to(device)
        if isinstance(k, np.bool_):
            return bool(k)
        return k

    return tuple(conv(k) for k in key_t) if isinstance(key_t, tuple) else conv(key_t)


def _index_plan(gshape: Tuple[int, ...], key_t, device):
    """``(comps, layout, shape)`` of a key on an array of ``gshape``.

    ``comps`` has one entry per key component, ``Ellipsis`` and the missing
    trailing dims expanded and boolean masks replaced by their nonzero
    index arrays (one per dim they span): ``("none",)``, ``("int", i)``,
    ``("slice", first, count, step)`` or ``("arr", index tensor)``, indices
    made non-negative and checked.  ``layout`` names each output dim by
    numpy's rules: ``("in", d)`` for a sliced input dim, ``("new",)`` for a
    newaxis and ``("adv", j)`` for dim j of the broadcast index block, which
    sits at the first advanced component (ints count as advanced when an
    array is present) if they are adjacent, else in front."""
    ndim = len(gshape)
    keys = list(key_t) if isinstance(key_t, tuple) else [key_t]

    def consumed(k) -> int:
        if k is None:
            return 0
        if _is_bool_array(k):
            return int(k.ndim)
        return 1

    n_explicit = sum(consumed(k) for k in keys if k is not Ellipsis)
    if sum(1 for k in keys if k is Ellipsis) > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    if n_explicit > ndim:
        raise IndexError(f"too many indices for array: array is {ndim}-dimensional, but {n_explicit} were indexed")
    expanded = []
    for k in keys:
        if k is Ellipsis:
            expanded.extend([slice(None)] * (ndim - n_explicit))
        else:
            expanded.append(k)
    expanded.extend([slice(None)] * (ndim - sum(consumed(k) for k in expanded)))

    comps = []
    d = 0
    for k in expanded:
        if k is None:
            comps.append(("none",))
            continue
        if isinstance(k, slice):
            start, stop, step = k.indices(gshape[d])
            comps.append(("slice", start, len(range(start, stop, step)), step))
            d += 1
            continue
        if _is_array(k):
            t = torch.from_numpy(np.ascontiguousarray(k).reshape(k.shape)).to(device) if isinstance(k, np.ndarray) \
                else k.to(device)
            if t.dtype == torch.bool:
                if tuple(t.shape) != tuple(gshape[d:d + t.ndim]):
                    raise IndexError(f"boolean index of shape {tuple(t.shape)} does not match the indexed "
                                     f"dimensions {tuple(gshape[d:d + t.ndim])}")
                for idx in torch.nonzero(t).unbind(1):
                    comps.append(("arr", idx))
                d += t.ndim
                continue
            if t.is_floating_point() or t.is_complex():
                raise IndexError("arrays used as indices must be of integer (or boolean) type")
            t = t.to(torch.int64)
            if t.numel() and (int(t.max()) >= gshape[d] or int(t.min()) < -gshape[d]):
                raise IndexError(f"index out of bounds for axis {d} with size {gshape[d]}")
            comps.append(("arr", torch.where(t < 0, t + gshape[d], t)))
            d += 1
            continue
        if isinstance(k, (int, np.integer)) and not isinstance(k, (bool, np.bool_)):
            i = int(k)
            if not -gshape[d] <= i < gshape[d]:
                raise IndexError(f"index {i} is out of bounds for axis {d} with size {gshape[d]}")
            comps.append(("int", i % gshape[d]))
            d += 1
            continue
        raise IndexError(f"only integers, slices, None, Ellipsis, and integer or boolean arrays are valid "
                         f"indices, got {type(k).__name__}")

    arrays = [i for i, c in enumerate(comps) if c[0] == "arr"]
    block = tuple(torch.broadcast_shapes(*(comps[i][1].shape for i in arrays))) if arrays else ()
    advanced = [i for i, c in enumerate(comps) if c[0] == "arr" or (arrays and c[0] == "int")]
    adjacent = bool(advanced) and advanced[-1] - advanced[0] + 1 == len(advanced)
    layout, shape = [], []
    d = 0
    for i, c in enumerate(comps):
        if advanced and i == (advanced[0] if adjacent else -1):
            layout.extend(("adv", j) for j in range(len(block)))
            shape.extend(block)
        if c[0] == "none":
            layout.append(("new",))
            shape.append(1)
            continue
        if c[0] == "slice":
            layout.append(("in", d))
            shape.append(c[2])
        d += 1
    if advanced and not adjacent:
        layout = [("adv", j) for j in range(len(block))] + layout
        shape = list(block) + shape
    return comps, layout, tuple(int(s) for s in shape)


def _consumer(comps, dim: int) -> int:
    """The index of the component that consumes input dim ``dim``."""
    d = 0
    for i, c in enumerate(comps):
        if c[0] == "none":
            continue
        if d == dim:
            return i
        d += 1
    raise IndexError(f"no component consumes dim {dim}")


def _slice_run(first: int, count: int, step: int, lo: int, hi: int) -> Tuple[int, int, int]:
    """``(p0, n, lo)``: the positions p0 .. p0 + n - 1 of the slice's
    selection ``first + p * step`` (p < count) that fall in [lo, hi)."""
    if count == 0 or hi <= lo:
        return 0, 0, lo
    if step > 0:
        p0 = max(0, -(-(lo - first) // step))
        p1 = min(count, -(-(hi - first) // step))
    else:
        s = -step
        p0 = max(0, -(-(first - hi + 1) // s))
        p1 = min(count, (first - lo) // s + 1)
    return p0, max(0, p1 - p0), lo


def _slice_view(t: torch.Tensor, dim: int, first: int, count: int, step: int) -> torch.Tensor:
    """``count`` entries along ``dim`` from ``first`` in steps of ``step``
    (a negative step walks backwards: taken forward, then flipped)."""
    if count == 0:
        return t.narrow(dim, 0, 0)
    if step > 0:
        return t.narrow(dim, first, (count - 1) * step + 1)[(slice(None),) * dim + (slice(None, None, step),)]
    last = first + (count - 1) * step
    fwd = t.narrow(dim, last, first - last + 1)[(slice(None),) * dim + (slice(None, None, -step),)]
    return fwd.flip(dim)


def _advanced_key(comps):
    """The torch key of the non-slice components (slices already applied):
    ints become index arrays broadcast with the others when an array is
    present, so that torch places the block by numpy's rule."""
    arrays = [c[1] for c in comps if c[0] == "arr"]
    block = torch.broadcast_shapes(*(a.shape for a in arrays)) if arrays else None
    if block is not None and len(block) == 0:
        # 0-d index arrays only: each takes its dim away, as an int does
        comps = [("int", int(c[1])) if c[0] == "arr" else c for c in comps]
        arrays, block = [], None
    key = []
    for c in comps:
        if c[0] == "none":
            key.append(None)
        elif c[0] == "slice":
            key.append(slice(None))
        elif c[0] == "int":
            key.append(torch.full(block, c[1], dtype=torch.int64, device=arrays[0].device) if arrays else c[1])
        else:
            key.append(c[1])
    return tuple(key), bool(arrays)


def _apply(t: torch.Tensor, comps) -> torch.Tensor:
    """The key on a local tensor whose dims are the input dims: slices
    first (views), then ints, newaxes and index arrays in one indexing."""
    d = 0
    for c in comps:
        if c[0] == "none":
            continue
        if c[0] == "slice":
            t = _slice_view(t, d, c[1], c[2], c[3])
        d += 1
    key, has_arrays = _advanced_key(comps)
    res = t[key]
    return res if has_arrays else res.clone()  # a copy, never a view of the array


def _assign(t: torch.Tensor, comps, layout, value: torch.Tensor) -> None:
    """Write ``value`` (shaped like the key's result on ``t``) in place
    through the key."""
    view = t
    d = 0
    flips = []
    for c in comps:
        if c[0] == "none":
            continue
        if c[0] == "slice":
            first, count, step = c[1], c[2], c[3]
            if step < 0 and count:
                first, step = first + (count - 1) * step, -step
                flips.append(layout.index(("in", d)))
            view = view.narrow(d, first, (count - 1) * step + 1 if count else 0)
            if count:
                view = view[(slice(None),) * d + (slice(None, None, step),)]
        d += 1
    if flips:
        value = value.flip(flips)
    key, _ = _advanced_key(comps)
    view[key] = value.to(view.dtype)


def _value_tensor(value, dtype, device) -> torch.Tensor:
    """A value to assign, as a tensor of ``dtype``'s holding type."""
    if isinstance(value, DNDarray):
        return types._cast(value._dense(), value.dtype, dtype).to(device)
    if isinstance(value, torch.Tensor):
        return types._cast(value.to(device), types.canonical_heat_type(value.dtype), dtype)
    if isinstance(value, (bool, int, float, complex)) and not isinstance(value, np.generic):
        if dtype in types._WIDENED and isinstance(value, int) and not isinstance(value, bool):
            v = value % (1 << 64) if dtype is types.uint64 else value
            return types._cast(torch.tensor(v - (1 << 64) if v >= 1 << 63 else v, device=device), types.int64, dtype)
        host = np.asarray(value)
    else:
        host = np.asarray(value)
    src = types.canonical_heat_type(host.dtype)
    held = np.ascontiguousarray(types._to_holding(host, src)).reshape(host.shape)
    return types._cast(torch.from_numpy(held).to(device), src, dtype)
