"""Shape and layout manipulations (counterpart of heat_tpu/core/manipulations.py).

The reference calls a ``jnp`` function on the global array and lets XLA
move the data.  Here each rank holds its padded chunk, and no function
gathers the rows of a split axis:

* where the split axis is not touched (``squeeze``, ``expand_dims``,
  ``swapaxes``, ``moveaxis``, ``broadcast_to``, ``diagonal`` off the split
  axis, and a ``flip``, ``roll``, ``pad``, ``repeat``, ``tile`` or
  ``unfold`` along another axis) each rank works on its own chunk;
* where rows change places along the split axis, each rank works out the
  global positions of its rows in the result, and one exchange
  (:func:`_to_canonical`, over ``Communication.all_to_all_varying``) sends
  every row to the rank that owns it in the result's canonical layout
  (``reshape``, ``flatten``, ``concatenate`` and the stacks, ``flip``,
  ``roll``, ``repeat``, ``tile``, ``rot90``, ``split``, ``diag``); ``pad``
  takes its edge rows through the same exchange, and ``unfold`` brings each
  rank the rows of its windows (its own and the next rank's first ones);
* ``sort`` takes the distributed sample sort (:mod:`.sample_sort`), and a
  sort along the split axis below its gate the same algorithm in a stable
  argsort's order; ``topk`` of a split axis merges the ranks' p k
  candidates and ``unique`` the ranks' distinct values, the gathers of the
  reference's own algorithms.

Results have the reference's split, type and values.
"""

from __future__ import annotations

import builtins
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.comm import _as_bytes, _from_bytes
from . import _keys, types
from .dndarray import DNDarray, _owned, _pad_along
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "balance",
    "broadcast_arrays",
    "broadcast_to",
    "collect",
    "column_stack",
    "concatenate",
    "diag",
    "diagonal",
    "dsplit",
    "expand_dims",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hsplit",
    "hstack",
    "moveaxis",
    "pad",
    "ravel",
    "redistribute",
    "repeat",
    "reshape",
    "resplit",
    "roll",
    "rot90",
    "row_stack",
    "shape",
    "sort",
    "split",
    "squeeze",
    "stack",
    "swapaxes",
    "tile",
    "topk",
    "unfold",
    "unique",
    "vsplit",
    "vstack",
]


# ----------------------------------------------------------------------
# moving rows along the split axis
# ----------------------------------------------------------------------
def _exchange_runs(comm, pieces, runs, axis: int, ranges, like: torch.Tensor) -> torch.Tensor:
    """Rows along ``axis`` to the ranks whose ranges cover them, by one
    exchange.  This rank holds ``pieces``, the rows of the global runs
    ``runs[rank]`` (one ``(first, count)`` per piece; ``runs`` lists every
    rank's); rank d receives the rows of ``ranges[d] = (lo, hi)`` (ranges
    may overlap: a row goes to each rank that needs it), in order.  ``like``
    gives the dtype and the other axes' extents."""
    me = comm.rank

    def cuts(run_list, lo, hi):
        out = []
        for j, (first, count) in enumerate(run_list):
            a, b = builtins.max(first, lo), builtins.min(first + count, hi)
            if b > a:
                out.append((j, a, b))
        return out

    empty = like.narrow(axis, 0, 0)
    blocks = []
    for lo, hi in ranges:
        parts = [pieces[j].narrow(axis, a - runs[me][j][0], b - a) for j, a, b in cuts(runs[me], lo, hi)]
        blocks.append(_as_bytes(torch.cat(parts, dim=axis) if parts else empty))
    lo, hi = ranges[me]
    incoming = [cuts(runs[s], lo, hi) for s in range(comm.size)]
    got = comm.all_to_all_varying(blocks, [builtins.sum(b - a for _, a, b in c) for c in incoming], axis)
    segments = []
    for c, g in zip(incoming, got):
        g = _from_bytes(g, like.dtype)
        at = 0
        for _, a, b in c:
            segments.append((a, g.narrow(axis, at, b - a)))
            at += b - a
    segments.sort(key=lambda s: s[0])
    return torch.cat([s[1] for s in segments], dim=axis) if segments else empty


def _canonical_ranges(comm, extent: int):
    per = comm.padded_extent(extent) // comm.size
    return [(builtins.min(d * per, extent), builtins.min((d + 1) * per, extent)) for d in range(comm.size)], per


def _to_canonical(comm, pieces, runs, axis: int, extent: int, like: torch.Tensor) -> torch.Tensor:
    """This rank's padded chunk of an array of ``extent`` rows along
    ``axis`` whose rows the ranks hold as ``pieces`` of the global ``runs``
    (:func:`_exchange_runs`)."""
    ranges, per = _canonical_ranges(comm, extent)
    return _pad_along(_exchange_runs(comm, pieces, runs, axis, ranges, like), axis, per).contiguous()


def _own_runs(comm, gshape, axis: int):
    """Every rank's ``(first, count)`` of its canonical rows along ``axis``."""
    return [(lo, hi - lo) for lo, hi in (_owned(comm, gshape, axis, r) for r in range(comm.size))]


def _wrap(like: DNDarray, local: torch.Tensor, gshape, split, dtype=None) -> DNDarray:
    return DNDarray(local, tuple(int(s) for s in gshape), like.dtype if dtype is None else dtype, split,
                    like.device, like.comm)


def _take(x: DNDarray, axis: int, idx) -> DNDarray:
    """``x``'s rows ``idx`` (global indices, numpy) along ``axis``, the split
    kept: one rank's own where ``axis`` is not split, else one exchange (the
    indexing of an index array on the split axis)."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    if x.split == axis and x.comm.size > 1:
        return x[(slice(None),) * axis + (idx,)]
    src = x.larray_padded if x.split is not None else x.larray
    t = torch.as_tensor(idx, device=src.device)
    local = src.index_select(axis, t)
    gshape = tuple(len(idx) if d == axis else s for d, s in enumerate(x.shape))
    if x.split == axis:  # one rank: its chunk is the array
        return DNDarray.from_dense(local, axis, x.device, x.comm, x.dtype)
    return _wrap(x, local, gshape, x.split)


def _local(x: DNDarray) -> torch.Tensor:
    """The tensor a local operation along an unsplit axis works on: the
    padded chunk, or the whole array."""
    return x.larray_padded if x.split is not None else x.larray


# ----------------------------------------------------------------------
# exports
# ----------------------------------------------------------------------
def balance(array: DNDarray, copy: bool = False) -> DNDarray:
    """``array`` itself, or a balanced copy with ``copy``: the compute
    layout is always the canonical one (``DNDarray.balance_`` drops a
    ragged target in place)."""
    if not isinstance(array, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(array)}")
    return array.copy() if copy else array


def redistribute(arr: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """A copy of ``arr`` with the layout ``target_map``
    (:meth:`DNDarray.redistribute_`)."""
    if not isinstance(arr, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(arr)}")
    return arr.copy().redistribute_(lshape_map=lshape_map, target_map=target_map)


def broadcast_arrays(*arrays: DNDarray) -> List[DNDarray]:
    """The arrays broadcast against each other."""
    if not arrays:
        return []
    out_shape = tuple(np.broadcast_shapes(*(a.shape for a in arrays)))
    return [broadcast_to(a, out_shape) for a in arrays]


def broadcast_to(x: DNDarray, shape) -> DNDarray:
    """``x`` broadcast to ``shape``; the split moves with its axis.  Each
    rank broadcasts its chunk, unless the split axis itself is broadcast
    (its one row then goes to every rank, as an operand broadcast along the
    split axis does)."""
    shape = sanitize_shape(shape)
    if tuple(np.broadcast_shapes(tuple(x.shape), shape)) != shape:
        raise ValueError(f"cannot broadcast an array of shape {x.shape} to {shape}")
    if x.split is None:
        return _wrap(x, x.larray.expand(shape).contiguous(), shape, None)
    out_split = x.split + len(shape) - x.ndim
    if x.shape[x.split] != shape[out_split]:
        return DNDarray.from_dense(x._dense().expand(shape), out_split, x.device, x.comm, x.dtype)
    local_shape = list(shape)
    local_shape[out_split] = x.larray_padded.shape[x.split]
    return _wrap(x, x.larray_padded.expand(local_shape).contiguous(), shape, out_split)


def collect(arr: DNDarray, target_rank: int = 0) -> DNDarray:
    """The whole array on every rank (``resplit(arr, None)``)."""
    return resplit(arr, None)


def _first_dnd(arrays):
    for a in arrays:
        if isinstance(a, DNDarray):
            return a
    return None


def _as_dnd(arrays) -> List[DNDarray]:
    """Each operand as a DNDarray: array-likes on the first DNDarray's
    device and communication, unsplit."""
    from . import factories

    ref = _first_dnd(arrays)
    kw = {} if ref is None else {"device": ref.device, "comm": ref.comm}
    return [a if isinstance(a, DNDarray) else factories.array(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                                                              **kw) for a in arrays]


def _promoted(ds: List[DNDarray]) -> List[DNDarray]:
    dt = ds[0].dtype
    for d in ds[1:]:
        dt = types.promote_types(dt, d.dtype)
    return [d if d.dtype is dt else d.astype(dt) for d in ds]


def _concat(ds: List[DNDarray], axis: int, split: Optional[int]) -> DNDarray:
    """Join DNDarrays of one type along ``axis`` into a result split along
    ``split``: where that is another axis, each rank joins its own rows;
    along the joined axis every operand's rows go to their place in the
    result by one exchange."""
    ref = ds[0]
    comm = ref.comm
    nd = ref.ndim
    for d in ds[1:]:
        if d.ndim != nd or any(d.shape[i] != ref.shape[i] for i in range(nd) if i != axis):
            raise ValueError(f"all the input array dimensions except for the concatenation axis must match "
                             f"exactly, got {[tuple(d.shape) for d in ds]}")
    gshape = list(ref.shape)
    gshape[axis] = builtins.sum(d.shape[axis] for d in ds)
    if split is None or comm.size == 1:
        local = torch.cat([d._dense() if d.split is not None else d.larray for d in ds], dim=axis)
        return DNDarray.from_dense(local, split, ref.device, comm, ref.dtype)
    if split != axis:
        from ._operations import _aligned

        return _wrap(ref, torch.cat([_aligned(d, d.shape, split) for d in ds], dim=axis), gshape, split)
    pieces, runs, offset = [], [[] for _ in range(comm.size)], 0
    for d in ds:
        if d.split not in (None, axis):
            d = d.resplit(axis)
        own = _own_runs(comm, d.shape, axis)
        lo, count = own[comm.rank]
        pieces.append(d.larray if d.split == axis else d.larray.narrow(axis, lo, count))
        for r in range(comm.size):
            runs[r].append((offset + own[r][0], own[r][1]))
        offset += d.shape[axis]
    return _wrap(ref, _to_canonical(comm, pieces, runs, axis, offset, pieces[0]), gshape, axis)


def concatenate(arrays: Sequence[DNDarray], axis: int = 0) -> DNDarray:
    """Join arrays along an existing axis, in their promoted type; the
    result is split as the first DNDarray."""
    if not isinstance(arrays, (list, tuple)):
        raise TypeError("arrays must be a list or a tuple")
    if len(arrays) == 0:
        raise ValueError("need at least one array to concatenate")
    ref = _first_dnd(arrays)
    ds = _promoted(_as_dnd(arrays))
    axis = sanitize_axis(ds[0].shape, axis)
    return _concat(ds, axis, ref.split if ref is not None else None)


def _stacked(arrays, ndmin_front: bool) -> DNDarray:
    ref = _first_dnd(arrays)
    ds = _as_dnd(arrays)
    ds = [expand_dims(d, 0 if ndmin_front else 1) if d.ndim == 1 else d for d in ds]
    return _concat(_promoted(ds), 0 if ndmin_front else 1, ref.split if ref is not None else None)


def column_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """1-D arrays as columns beside 2-D ones, joined along axis 1; split as
    the first DNDarray."""
    return _stacked(arrays, ndmin_front=False)


def row_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """1-D arrays as rows beside 2-D ones, joined along axis 0; split as the
    first DNDarray."""
    return _stacked(arrays, ndmin_front=True)


vstack = row_stack


def hstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Join along axis 1 (axis 0 for 1-D arrays)."""
    a0 = arrays[0]
    nd = a0.ndim if isinstance(a0, DNDarray) else np.ndim(a0)
    return concatenate(arrays, axis=0 if nd == 1 else 1)


def stack(arrays: Sequence[DNDarray], axis: int = 0, out=None) -> DNDarray:
    """Join arrays of one shape along a new axis; the split moves with its
    axis.  Each rank stacks its own rows."""
    from ._operations import _aligned
    from .sanitation import store_out

    ref = _first_dnd(arrays)
    ds = _promoted(_as_dnd(arrays))
    shape = ds[0].shape
    if any(d.shape != shape for d in ds):
        raise ValueError("all input arrays must have the same shape")
    nd = len(shape) + 1
    axis_n = axis % nd if -nd <= axis < nd else None
    if axis_n is None:
        raise ValueError(f"axis {axis} is out of bounds for {nd}-dimensional array")
    split = ref.split if ref is not None else None
    gshape = shape[:axis_n] + (len(ds),) + shape[axis_n:]
    if split is None:
        res = _wrap(ds[0], torch.stack([d._dense() if d.split is not None else d.larray for d in ds], dim=axis_n),
                    gshape, None)
    else:
        local = torch.stack([_aligned(d, d.shape, split) for d in ds], dim=axis_n)
        res = _wrap(ds[0], local, gshape, split + 1 if axis_n <= split else split)
    return res if out is None else store_out(res, out)


def diag(a: DNDarray, offset: int = 0) -> DNDarray:
    """The diagonal of a 2-D array, or the square array with a 1-D array on
    its ``offset`` diagonal (split 0 where ``a`` is split: each rank gets
    the values of its rows by one exchange)."""
    if a.ndim not in (1, 2):
        raise ValueError(f"input must be 1- or 2-dimensional, got {a.ndim}-d")
    if a.ndim == 2:
        return diagonal(a, offset=offset)
    n, k = a.shape[0], int(offset)
    size = n + builtins.abs(k)
    if a.split is None:
        return _wrap(a, torch.diag(a.larray, k), (size, size), None)
    comm = a.comm
    s0 = builtins.max(0, -k)
    runs = [[(first + s0, count)] for first, count in _own_runs(comm, a.shape, 0)]
    ranges, per = _canonical_ranges(comm, size)
    vals = _exchange_runs(comm, [a.larray], runs, 0, ranges, a.larray)
    lo, hi = ranges[comm.rank]
    rows = torch.arange(builtins.max(lo, s0), builtins.min(hi, s0 + n), device=vals.device)
    local = torch.zeros((per, size), dtype=vals.dtype, device=vals.device)
    local[rows - lo, rows + k] = vals
    return _wrap(a, local, (size, size), 0)


def diagonal(a: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """The ``offset`` diagonal of the (dim1, dim2) planes, as the last axis.
    Split off those axes: each rank's own; split along one of them: each
    rank takes the diagonal of its rows, and one exchange lays the diagonal
    out along the result's last axis."""
    dim1, dim2 = sanitize_axis(a.shape, dim1), sanitize_axis(a.shape, dim2)
    if dim1 == dim2:
        raise ValueError("dim1 and dim2 cannot be identical")
    offset = int(offset)
    split = a.split
    L = builtins.max(0, builtins.min(a.shape[dim1] + builtins.min(offset, 0), a.shape[dim2] - builtins.max(offset, 0)))
    gshape = tuple(s for d, s in enumerate(a.shape) if d not in (dim1, dim2)) + (L,)
    if split is None:
        return _wrap(a, torch.diagonal(a.larray, offset, dim1, dim2).contiguous(), gshape, None)
    if split not in (dim1, dim2):
        out_split = split - builtins.sum(1 for d in (dim1, dim2) if d < split)
        return _wrap(a, torch.diagonal(a.larray_padded, offset, dim1, dim2).contiguous(), gshape, out_split)
    comm = a.comm
    firsts = []
    for lo, _ in _own_runs(comm, a.shape, split):
        # the diagonal's entry i sits at row i - min(offset, 0)
        if split == dim1:  # this rank's first row with a diagonal entry
            row = lo + builtins.max(0, -(lo + offset))
        else:  # the first row whose column offset + row falls in this rank's columns
            row = builtins.max(0, lo - offset)
        firsts.append(row + builtins.min(offset, 0))
    lo = _owned(comm, a.shape, split, comm.rank)[0]
    mine = torch.diagonal(a.larray, offset + lo if split == dim1 else offset - lo, dim1, dim2)
    runs = [[(firsts[r], _diag_count(a, split, dim1, dim2, offset, r))] for r in range(comm.size)]
    local = _to_canonical(comm, [mine], runs, mine.ndim - 1, L, mine)
    return _wrap(a, local, gshape, len(gshape) - 1)


def _diag_count(a: DNDarray, split: int, dim1: int, dim2: int, offset: int, rank: int) -> int:
    """The number of diagonal elements in rank ``rank``'s rows."""
    lo, hi = _owned(a.comm, a.shape, split, rank)
    rows, cols = (hi - lo, a.shape[dim2]) if split == dim1 else (a.shape[dim1], hi - lo)
    off = offset + (lo if split == dim1 else -lo)
    if off >= 0:
        return builtins.max(0, builtins.min(rows, cols - off))
    return builtins.max(0, builtins.min(rows + off, cols))


def dsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along axis 2."""
    if x.ndim < 3:
        raise ValueError("dsplit only works on arrays of 3 or more dimensions")
    return split(x, indices_or_sections, 2)


def expand_dims(a: DNDarray, axis: int) -> DNDarray:
    """A new axis of length 1 at ``axis``; each rank's own."""
    axis = sanitize_axis(tuple(a.shape) + (1,), axis)
    split = a.split
    if split is not None and axis <= split:
        split += 1
    gshape = tuple(a.shape[:axis]) + (1,) + tuple(a.shape[axis:])
    return _wrap(a, _local(a).unsqueeze(axis), gshape, split)


def flatten(a: DNDarray) -> DNDarray:
    """The array as 1-D in row-major order, split 0 where ``a`` is split: an
    array split along axis 0 sends each rank's rows, one contiguous run of
    the result, by one exchange (along another axis it is resplit along
    axis 0 first)."""
    if a.split is None:
        return _wrap(a, a.larray.reshape(-1), (a.size,), None)
    if a.split != 0:
        a = a.resplit(0)
    comm = a.comm
    inner = int(np.prod(a.shape[1:], dtype=np.int64))
    runs = [[(first * inner, count * inner)] for first, count in _own_runs(comm, a.shape, 0)]
    flat = a.larray.reshape(-1)
    return _wrap(a, _to_canonical(comm, [flat], runs, 0, a.size, flat), (a.size,), 0)


def ravel(a: DNDarray) -> DNDarray:
    """:func:`flatten`."""
    return flatten(a)


def flip(a: DNDarray, axis=None) -> DNDarray:
    """The order of the entries reversed along ``axis`` (all axes by
    default): each rank flips its chunk, and along the split axis its rows
    go to their mirrored place by one exchange."""
    axes = sanitize_axis(a.shape, axis)
    axes = tuple(range(a.ndim)) if axes is None else (axes if isinstance(axes, tuple) else (axes,))
    split = a.split
    other = [d for d in axes if d != split]
    local = _local(a)
    if other:
        local = local.flip(other)
    if split is None or split not in axes:
        return _wrap(a, local.clone() if not other else local, a.shape, split)
    comm, n = a.comm, a.shape[split]
    rows = local.narrow(split, 0, a.lshape[split]).flip(split)
    runs = [[(n - first - count, count)] for first, count in _own_runs(comm, a.shape, split)]
    return _wrap(a, _to_canonical(comm, [rows], runs, split, n, rows), a.shape, split)


def fliplr(a: DNDarray) -> DNDarray:
    """Flip along axis 1."""
    return flip(a, 1)


def flipud(a: DNDarray) -> DNDarray:
    """Flip along axis 0."""
    return flip(a, 0)


def hsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along axis 1 (axis 0 for 1-D arrays)."""
    if x.ndim < 2:
        return split(x, indices_or_sections, 0)
    return split(x, indices_or_sections, 1)


def moveaxis(x: DNDarray, source, destination) -> DNDarray:
    """Axes moved to new positions (a transpose: the split moves with its
    axis)."""
    from .linalg import basics

    if isinstance(source, int):
        source = (source,)
    if isinstance(destination, int):
        destination = (destination,)
    source = tuple(sanitize_axis(x.shape, s) for s in source)
    destination = tuple(sanitize_axis(x.shape, d) for d in destination)
    if len(source) != len(destination):
        raise ValueError("source and destination arguments must have the same number of elements")
    perm = [n for n in range(x.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        perm.insert(dest, src)
    return basics.transpose(x, perm)


def swapaxes(x: DNDarray, axis1: int, axis2: int) -> DNDarray:
    """Two axes interchanged (a transpose)."""
    from .linalg import basics

    axis1 = sanitize_axis(x.shape, axis1)
    axis2 = sanitize_axis(x.shape, axis2)
    perm = list(range(x.ndim))
    perm[axis1], perm[axis2] = perm[axis2], perm[axis1]
    return basics.transpose(x, perm)


# numpy's mode -> accepted keyword table (np.pad): another keyword is refused
_PAD_MODE_KWARGS = {
    "constant": {"constant_values"},
    "edge": set(),
    "empty": set(),
    "linear_ramp": {"end_values"},
    "maximum": {"stat_length"},
    "mean": {"stat_length"},
    "median": {"stat_length"},
    "minimum": {"stat_length"},
    "reflect": {"reflect_type"},
    "symmetric": {"reflect_type"},
    "wrap": set(),
}


def _pairs(value, nd: int, name: str) -> np.ndarray:
    """``value`` broadcast to (nd, 2) pairs, as ``jnp.pad`` reads its widths
    and values."""
    arr = np.asarray(value)
    if arr.ndim == 1 and arr.shape[0] == 1:
        arr = arr[0]
    try:
        return np.broadcast_to(arr, (nd, 2))
    except ValueError:
        raise ValueError(f"jnp.pad: {name} with shape {arr.shape} cannot be broadcast to ({nd}, 2)") from None


def _full_rows(x: DNDarray, axis: int, count: int, value) -> DNDarray:
    """``count`` rows along ``axis`` of one value, in ``x``'s type, split as
    ``x`` (whole on every rank where ``axis`` is its split axis)."""
    shape = list(_local(x).shape)
    shape[axis] = count
    host = np.asarray(value)
    v = types._cast(torch.as_tensor(host, device=_local(x).device), types.canonical_heat_type(host.dtype), x.dtype)
    local = v.to(_local(x).dtype).expand(shape).contiguous()
    gshape = tuple(count if d == axis else s for d, s in enumerate(x.shape))
    return _wrap(x, local, gshape, x.split if x.split != axis else None)


def _rows_of(x: DNDarray, axis: int, rows: torch.Tensor) -> DNDarray:
    """Rows along ``axis`` computed on every rank (``rows``: the local shape
    of x's chunk with ``axis`` replaced), as a DNDarray split as ``x``
    (whole where ``axis`` is its split axis)."""
    gshape = tuple(rows.shape[axis] if d == axis else s for d, s in enumerate(x.shape))
    return _wrap(x, rows.contiguous(), gshape, x.split if x.split != axis else None)


def _edge_rows(x: DNDarray, axis: int, idx) -> torch.Tensor:
    """``x``'s rows ``idx`` along ``axis`` as a tensor of x's local shape
    there (every rank's copy where ``axis`` is its split axis: a few rows)."""
    t = _take(x, axis, idx)
    return (t.resplit(None).larray if t.split == axis else _local(t))


def _pad_axis(x: DNDarray, axis: int, before: int, after: int, mode: str, kw: dict) -> DNDarray:
    """``jnp.pad`` along one axis, the rows before and after made apart and
    joined with ``x`` by :func:`_concat` (one exchange along the split
    axis)."""
    if before == 0 and after == 0:
        return x
    n = x.shape[axis]
    if n == 0 and mode not in ("constant", "empty"):
        raise ValueError(f"can't extend empty axis {axis} using modes other than 'constant' or 'empty'")
    if mode in ("constant", "empty"):
        cv = _pairs(kw.get("constant_values", 0) if mode == "constant" else 0, x.ndim, "constant_values")
        parts = [_full_rows(x, axis, before, cv[axis][0]), x, _full_rows(x, axis, after, cv[axis][1])]
    elif mode == "edge":
        parts = [_take(x, axis, [0] * before), x, _take(x, axis, [n - 1] * after)]
    elif mode == "wrap":
        lrep, lrem = divmod(before, n)
        rrep, rrem = divmod(after, n)
        parts = ([_take(x, axis, range(n - lrem, n))] if lrem else []) + [x] * (lrep + rrep + 1) + \
            ([_take(x, axis, range(rrem))] if rrem else [])
    elif mode in ("reflect", "symmetric"):
        return _pad_reflect(x, axis, before, after, mode, kw.get("reflect_type", "even"))
    elif mode == "linear_ramp":
        ev = _pairs(kw.get("end_values", 0), x.ndim, "end_values")
        parts = [_ramp(x, axis, before, 0, ev[axis][0], flip_it=False), x,
                 _ramp(x, axis, after, n - 1, ev[axis][1], flip_it=True)]
    else:
        parts = [_stat_rows(x, axis, before, mode, kw.get("stat_length"), True), x,
                 _stat_rows(x, axis, after, mode, kw.get("stat_length"), False)]
    return _concat([p for p in parts if p.shape[axis] or p is x], axis, x.split)


def _ramp(x: DNDarray, axis: int, count: int, edge_at: int, end, flip_it: bool) -> DNDarray:
    """``count`` rows rising linearly from ``end`` towards the edge row
    (``jnp.linspace(end, edge, count, endpoint=False)``; integers floored)."""
    wide = torch.complex128 if types.heat_type_is_complexfloating(x.dtype) else torch.float64
    edge = _edge_rows(x, axis, [edge_at]).to(wide)
    shape = [1] * edge.ndim
    shape[axis] = count
    i = torch.arange(count, dtype=torch.float64, device=edge.device).reshape(shape)
    end = float(end)
    rows = end + i * ((edge - end) / builtins.max(count, 1))
    if not types.heat_type_is_inexact(x.dtype):
        rows = torch.floor(rows)
    rows = types._cast(rows, types.canonical_heat_type(wide), x.dtype)
    return _rows_of(x, axis, rows.flip(axis) if flip_it else rows)


def _stat_rows(x: DNDarray, axis: int, count: int, mode: str, stat_length, before: bool) -> DNDarray:
    """``count`` rows of the statistic (``mode``) over the ``stat_length``
    edge rows (all where None); integers round half to even."""
    from . import arithmetics, statistics

    n = x.shape[axis]
    src = x
    if stat_length is not None:
        length = int(_pairs(stat_length, x.ndim, "stat_length")[axis][0 if before else 1])
        if length == 0:
            raise ValueError("stat_length of 0 yields no value for padding")
        length = builtins.min(length, n)
        src = _take(x, axis, range(length) if before else range(n - length, n))
    exact = not types.heat_type_is_inexact(src.dtype)
    integer = exact and src.dtype is not types.bool  # jnp.pad rounds integer statistics, not bool ones
    if mode == "maximum":
        stat = statistics.max(src, axis=axis, keepdims=True)
    elif mode == "minimum":
        stat = statistics.min(src, axis=axis, keepdims=True)
    elif mode == "mean":
        wide = src.astype(types.float64) if exact else src
        stat = arithmetics.sum(wide, axis=axis, keepdims=True) / float(src.shape[axis])
    else:
        stat = statistics.median(src.astype(types.float64) if exact else src, axis=axis, keepdims=True)
    t = stat.resplit(None).larray if stat.split == axis else _local(stat)
    if exact and mode in ("mean", "median"):
        t = types._cast(torch.round(t) if integer else t, types.float64, x.dtype)
    shape = list(t.shape)
    shape[axis] = count
    return _rows_of(x, axis, t.expand(shape))


def _pad_reflect(x: DNDarray, axis: int, before: int, after: int, mode: str, reflect_type: str) -> DNDarray:
    """``jnp.pad``'s reflect and symmetric modes along one axis: rounds of
    at most the axis's extent, each reflecting the current edge rows (odd:
    ``2 edge - x``)."""
    if reflect_type not in ("even", "odd"):
        raise ValueError(f"reflect_type must be 'even' or 'odd', got {reflect_type!r}")
    size = x.shape[axis]
    offset = 1 if (mode == "reflect" and size > 1) else 0
    for side, padding in (("before", before), ("after", after)):
        while padding > 0:
            n = x.shape[axis]
            curr = builtins.min(padding, size - offset)
            padding -= curr
            if side == "before":
                idx = list(range(offset + curr - 1, offset - 1, -1))
                edge = 0
            else:
                stop = n if (mode == "symmetric" or size == 1) else n - 1
                idx = list(range(stop - 1, stop - curr - 1, -1))
                edge = n - 1
            rows = _take(x, axis, idx)
            if reflect_type == "odd" and x.dtype is types.bool:
                raise TypeError("lax.concatenate requires arguments to have the same dtypes, got int64, bool.")
            if reflect_type == "odd":  # 2 edge - x, in the array's type (both taken alike: one layout)
                e = _take(x, axis, [edge] * curr)
                rows = _wrap(rows, 2 * _local(e) - _local(rows), rows.shape, rows.split)
            parts = [rows, x] if side == "before" else [x, rows]
            x = _concat(parts, axis, x.split)
    return x


def pad(array: DNDarray, pad_width, mode: str = "constant", constant_values=0, **kwargs) -> DNDarray:
    """``jnp.pad`` of the array, axis after axis, the split kept: along an
    unsplit axis each rank pads its own chunk; along the split axis the edge
    rows a mode needs come by one exchange, and the rows before and after
    join the array's by another."""
    if callable(mode):
        raise NotImplementedError("pad with a callable mode is not ported")
    allowed = _PAD_MODE_KWARGS.get(mode)
    if allowed is None:
        raise ValueError(f"mode '{mode}' is not supported")
    if mode == "constant":
        kwargs.setdefault("constant_values", constant_values)
    unexpected = set(kwargs) - allowed
    if unexpected:
        raise ValueError(f"unsupported keyword arguments for mode '{mode}': {sorted(unexpected)}")
    if array.ndim == 0:
        return array.copy()
    widths = np.asarray(pad_width)
    if not np.issubdtype(widths.dtype, np.integer):
        raise TypeError(f"pad_width must be of integral type, got {widths.dtype}")
    widths = _pairs(widths, array.ndim, "pad_width").astype(np.int64)
    if (widths < 0).any():
        raise ValueError("index can't contain negative values")
    x = array
    for axis in range(array.ndim):
        x = _pad_axis(x, axis, int(widths[axis][0]), int(widths[axis][1]), mode, kwargs)
    return x if x is not array else array.copy()


def repeat(a: DNDarray, repeats, axis: Optional[int] = None) -> DNDarray:
    """Each entry repeated (``repeats`` a number, or one count per entry of
    the axis); along the split axis each rank repeats its rows and one
    exchange lays them out."""
    if isinstance(repeats, DNDarray):
        repeats = repeats.numpy()
    reps = np.asarray(repeats)
    if not np.issubdtype(reps.dtype, np.integer):
        raise TypeError(f"repeats must be integers, got {reps.dtype}")
    if (reps < 0).any():
        raise ValueError("repeats may not contain negative values")
    if axis is None:
        a, axis = flatten(a), 0
    axis = sanitize_axis(a.shape, axis)
    n = a.shape[axis]
    reps = reps.reshape(-1).astype(np.int64)
    if reps.size == 1:
        reps = np.full(n, reps[0], dtype=np.int64)
    elif reps.size != n:
        raise ValueError(f"repeats has {reps.size} entries for an axis of {n}")
    total = int(reps.sum())
    gshape = tuple(total if d == axis else s for d, s in enumerate(a.shape))
    dev = _local(a).device
    if a.split != axis or a.comm.size == 1:
        src = a.larray if a.split == axis else _local(a)
        local = torch.repeat_interleave(src, torch.as_tensor(reps, device=dev), dim=axis)
        if a.split == axis:
            return DNDarray.from_dense(local, axis, a.device, a.comm, a.dtype)
        return _wrap(a, local, gshape, a.split)
    comm = a.comm
    starts = np.concatenate([[0], np.cumsum(reps)])
    runs = [[(int(starts[lo]), int(starts[lo + c] - starts[lo]))] for lo, c in _own_runs(comm, a.shape, axis)]
    lo, c = _own_runs(comm, a.shape, axis)[comm.rank]
    mine = torch.repeat_interleave(a.larray, torch.as_tensor(reps[lo:lo + c], device=dev), dim=axis)
    return _wrap(a, _to_canonical(comm, [mine], runs, axis, total, mine), gshape, axis)


def reshape(a: DNDarray, *shape, new_split: Optional[int] = None) -> DNDarray:
    """A new global shape in row-major order, split along ``new_split`` (by
    default the old split where the new shape has that axis, else 0).  The
    rows of an array split along axis 0 are contiguous runs of the
    row-major order: one exchange gives each rank the run of its rows of
    the result (an array split otherwise is resplit along axis 0 first, a
    result split otherwise resplit after)."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = tuple(int(s) for s in shape)
    if shape.count(-1) > 1:
        raise ValueError("can only specify one unknown dimension")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1], dtype=np.int64))
        if known == 0 or a.size % known:
            raise ValueError(f"cannot reshape array of size {a.size} into shape {shape}")
        shape = tuple(a.size // known if s == -1 else s for s in shape)
    if int(np.prod(shape, dtype=np.int64)) != a.size:
        raise ValueError(f"cannot reshape array of size {a.size} into shape {shape}")
    if new_split is None:
        new_split = a.split if a.split is not None and a.split < len(shape) else (0 if a.split is not None else None)
    new_split = sanitize_axis(shape, new_split)
    if a.split is None or a.comm.size == 1:
        return DNDarray.from_dense(a.larray.reshape(shape), new_split, a.device, a.comm, a.dtype)
    if new_split is None:
        return _wrap(a, a._dense().reshape(shape), shape, None)
    if a.split != 0:
        a = a.resplit(0)
    comm = a.comm
    inner = int(np.prod(a.shape[1:], dtype=np.int64))
    runs = [[(first * inner, count * inner)] for first, count in _own_runs(comm, a.shape, 0)]
    out_inner = int(np.prod(shape[1:], dtype=np.int64))
    ranges, per = _canonical_ranges(comm, shape[0])
    flat = a.larray.reshape(-1)
    rows = _exchange_runs(comm, [flat], runs, 0, [(lo * out_inner, hi * out_inner) for lo, hi in ranges], flat)
    local = _pad_along(rows.reshape((-1,) + shape[1:]), 0, per).contiguous()
    res = _wrap(a, local, shape, 0)
    return res if new_split == 0 else res.resplit(new_split)


def resplit(arr: DNDarray, axis: Optional[int] = None) -> DNDarray:
    """A copy re-split along ``axis`` (:meth:`DNDarray.resplit`)."""
    return arr.resplit(axis)


def roll(x: DNDarray, shift, axis=None) -> DNDarray:
    """A cyclic shift of the entries along ``axis`` (of the flattened array
    when None).  Along an unsplit axis each rank rolls its chunk; along the
    split axis each rank's rows land in one or two runs, and one exchange
    brings every rank the rows that now fall in its range: its own and
    those of the rank ``shift`` rows before it."""
    if axis is None:
        if np.ndim(shift) != 0:
            raise ValueError("shift must be a scalar when axis is None")
        return reshape(roll(flatten(x), int(shift), 0), x.shape, new_split=x.split)
    shifts, axes = np.broadcast_arrays(np.asarray(shift), np.asarray(axis))
    total = {}
    for sh, ax in zip(shifts.reshape(-1), axes.reshape(-1)):
        ax = sanitize_axis(x.shape, int(ax))
        total[ax] = total.get(ax, 0) + int(sh)
    local = _local(x)
    others = [(s, ax) for ax, s in total.items() if ax != x.split]
    if others:
        local = torch.roll(local, [s for s, _ in others], [ax for _, ax in others])
    res = _wrap(x, local if others else local.clone(), x.shape, x.split)
    s = total.get(x.split) if x.split is not None else None
    if s is None or x.shape[x.split] == 0 or s % x.shape[x.split] == 0:
        return res
    comm, ax, n = x.comm, x.split, x.shape[x.split]
    s %= n
    if comm.size == 1:
        return _wrap(x, torch.roll(res.larray_padded, s, ax), x.shape, ax)
    runs, pieces = [], None
    for r, (lo, count) in enumerate(_own_runs(comm, x.shape, ax)):
        first = (lo + s) % n
        head = builtins.min(count, n - first)
        runs.append([(first, head), (0, count - head)])
        if r == comm.rank:
            rows = res.larray
            pieces = [rows.narrow(ax, 0, head), rows.narrow(ax, head, count - head)]
    return _wrap(x, _to_canonical(comm, pieces, runs, ax, n, res.larray), x.shape, ax)


def rot90(m: DNDarray, k: int = 1, axes=(0, 1)) -> DNDarray:
    """Rotate by 90 degrees ``k`` times in the plane of ``axes`` (flips and a
    transpose: the split moves with its axis)."""
    from .linalg import basics

    axes = tuple(axes)
    if len(axes) != 2:
        raise ValueError("len(axes) must be 2.")
    if m.ndim < 2:
        raise ValueError("Axes must be different.")
    a0, a1 = sanitize_axis(m.shape, axes[0]), sanitize_axis(m.shape, axes[1])
    if a0 == a1:
        raise ValueError("Axes must be different.")
    k = int(k) % 4
    if k == 0:
        return m.copy()
    if k == 2:
        return flip(flip(m, a0), a1)
    perm = list(range(m.ndim))
    perm[a0], perm[a1] = perm[a1], perm[a0]
    if k == 1:
        return basics.transpose(flip(m, a1), perm)
    return flip(basics.transpose(m, perm), a1)


def shape(a: DNDarray) -> Tuple[int, ...]:
    """The global shape."""
    return a.shape


def _local_sort(t: torch.Tensor, axis: int, descending: bool, dtype):
    """A stable sort of a whole tensor along ``axis`` in ``jnp.argsort``'s
    order (NaN last whatever its sign, -0.0 equal to +0.0, ties by index):
    ``(values, int64 indices)``.  Floats sort by their order keys (the
    card's radix sort would put a NaN of negative sign first), complex and
    uint64 by theirs, the other types by value."""
    if t.is_complex() or dtype is types.uint64:
        perm = _keys.lex_sort(_keys.sort_keys(t, descending, True, dtype is types.uint64), dim=axis)
    elif t.is_floating_point():
        key = _keys._ordered(t + 0.0)
        perm = torch.sort(torch.bitwise_not(key) if descending else key, dim=axis, stable=True).indices
    else:
        return tuple(torch.sort(t, dim=axis, descending=descending, stable=True))
    return t.gather(axis, perm), perm


def sort(a: DNDarray, axis: int = -1, descending: bool = False, out=None):
    """``(values, int64 indices)`` of a stable sort along ``axis``, split as
    ``a``.  The split axis of more than one rank takes the distributed
    sample sort: where the reference's gate admits, in its order (-0.0 below
    +0.0); otherwise in its dense route's, a stable argsort's.  Any other
    axis sorts on each rank."""
    from .sample_sort import _sorted_along, sample_sort_along, supports_sample_sort
    from .sanitation import store_out

    axis = sanitize_axis(a.shape, axis)
    if axis is None:  # a 0-d array: the reference's flattened argsort
        res_v = a._like(a.larray.reshape(1).clone(), gshape=(1,), dtype=a.dtype)
        res_i = a._like(torch.zeros(1, dtype=torch.int64, device=_local(a).device), gshape=(1,), dtype=types.int64)
    elif supports_sample_sort(a, axis, descending):
        res_v, res_i = sample_sort_along(a, axis, descending)
    elif a.split == axis and a.comm.size > 1:
        res_v, res_i = _sorted_along(a, axis, descending, merge_zeros=True)
    else:
        t = a.larray if a.split == axis else _local(a)
        v, i = _local_sort(t, axis, descending, a.dtype)
        if a.split == axis:
            res_v = DNDarray.from_dense(v, axis, a.device, a.comm, a.dtype)
            res_i = DNDarray.from_dense(i, axis, a.device, a.comm, types.int64)
        else:
            res_v, res_i = _wrap(a, v, a.shape, a.split), _wrap(a, i, a.shape, a.split, types.int64)
    if out is not None:
        return store_out(res_v, out), res_i
    return res_v, res_i


def _slice_along(x: DNDarray, axis: int, start: int, stop: int) -> DNDarray:
    """``x[..., start:stop, ...]`` along ``axis`` (python slice bounds), the
    split kept: each rank's own rows where ``axis`` is not split."""
    if x.split == axis:
        return x[(slice(None),) * axis + (slice(start, stop),)]
    lo, hi, _ = slice(start, stop).indices(x.shape[axis])
    count = builtins.max(0, hi - lo)
    gshape = tuple(count if d == axis else s for d, s in enumerate(x.shape))
    return _wrap(x, _local(x).narrow(axis, lo, count).clone(), gshape, x.split)


def split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """Sub-arrays along ``axis``, at the given indices or into equal
    sections, each split as ``x`` (along the split axis each part's rows go
    to their canonical owners by one exchange)."""
    axis = sanitize_axis(x.shape, axis)
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.numpy().tolist()
    n = x.shape[axis]
    if isinstance(indices_or_sections, (list, tuple, np.ndarray)):
        cuts = [0] + [int(i) for i in np.asarray(indices_or_sections).reshape(-1)] + [n]
        sizes = np.diff(cuts)
        if (sizes < 0).any():
            raise ValueError(f"Sizes passed to split must be nonnegative, got {sizes.tolist()}")
        bounds = list(zip(cuts[:-1], cuts[1:]))
    else:
        sections = int(indices_or_sections)
        if sections <= 0:
            raise ValueError("number sections must be larger than 0.")
        if n % sections:
            raise ValueError("array split does not result in an equal division")
        step = n // sections
        bounds = [(i * step, (i + 1) * step) for i in range(sections)]
    return [_slice_along(x, axis, lo, hi) for lo, hi in bounds]


def squeeze(x: DNDarray, axis=None) -> DNDarray:
    """Axes of length 1 removed (those of ``axis``); a squeezed split axis
    leaves the array whole on every rank."""
    ax = sanitize_axis(x.shape, axis)
    if ax is not None:
        axes = ax if isinstance(ax, tuple) else (ax,)
        for a in axes:
            if x.shape[a] != 1:
                raise ValueError(f"cannot select an axis to squeeze out which has size not equal to one, got axis {a}")
    else:
        axes = tuple(d for d, s in enumerate(x.shape) if s == 1)
    split = x.split
    if split is not None and split in axes:
        x, split = x.resplit(None), None
    gshape = tuple(s for d, s in enumerate(x.shape) if d not in axes)
    if split is not None:
        split -= builtins.sum(1 for a in axes if a < split)
    local = _local(x)
    keep = [s for d, s in enumerate(local.shape) if d not in axes]
    return _wrap(x, local.reshape(keep), gshape, split)


def tile(x: DNDarray, reps) -> DNDarray:
    """The array repeated ``reps`` times along each axis (leading axes
    added where ``reps`` is longer); along the split axis each rank's rows
    appear once a repetition, laid out by one exchange."""
    if isinstance(reps, DNDarray):
        reps = reps.numpy().tolist()
    reps = (int(reps),) if np.ndim(reps) == 0 else tuple(int(r) for r in reps)
    while x.ndim < len(reps):
        x = expand_dims(x, 0)
    reps = (1,) * (x.ndim - len(reps)) + reps
    split = x.split
    local_reps = [1 if d == split else r for d, r in enumerate(reps)]
    local = _local(x).repeat(local_reps) if x.ndim else _local(x).clone()
    gshape = tuple(s * r for s, r in zip(x.shape, reps))
    res = _wrap(x, local, tuple(gshape[d] if d != split else x.shape[d] for d in range(x.ndim)), split)
    if split is None or reps[split] == 1:
        return res
    comm, n, r = x.comm, x.shape[split], reps[split]
    if comm.size == 1:
        return _wrap(x, res.larray.repeat([r if d == split else 1 for d in range(x.ndim)]), gshape, split)
    own = _own_runs(comm, x.shape, split)
    runs = [[(k * n + lo, c) for k in range(r)] for lo, c in own]
    rows = res.larray
    return _wrap(x, _to_canonical(comm, [rows] * r, runs, split, n * r, rows), gshape, split)


# ----------------------------------------------------------------------
# top-k
# ----------------------------------------------------------------------
def _topk_keys(t: torch.Tensor, largest: bool, kind=None) -> torch.Tensor:
    """``lax.top_k``'s keys: the values (negated for the smallest) in the
    IEEE total order, as signed integers; holding tensors of an unsigned
    ``kind`` by their values (the negation wraps in the type's width)."""
    if kind in types._WIDENED:
        return types._order_key(t if largest else types._wrap(-t, kind), kind)
    if t.dtype == torch.bool:
        if not largest:
            raise TypeError("neg does not accept dtype bool. Accepted dtypes are subtypes of integer, floating, "
                            "complexfloating.")
        return t.to(torch.int32)
    if t.is_complex():
        raise ValueError("top_k is not compatible with complex inputs.")
    if not t.is_floating_point():
        return t if largest else -t
    if largest:
        return _keys.total_keys(t)
    # XLA's negation flips the sign bit, a NaN's too (the card's may not)
    bits = torch.bitwise_xor(t.view(_keys._KEY_TYPES[t.dtype]), torch.iinfo(_keys._KEY_TYPES[t.dtype]).min)
    return _keys.total_keys(bits.view(t.dtype))


def _topk_select(key: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """The indices of the ``k`` largest keys along ``dim``, the lower index
    first among equals (``lax.top_k``'s order): one ``torch.topk`` of the
    key packed above the index where both fit in 64 bits, else a stable
    descending sort."""
    n = key.shape[dim]
    if key.element_size() <= 4 and n < (1 << 31):
        idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(
            [n if d == dim else 1 for d in range(key.ndim)])
        packed = (key.to(torch.int64) << 32) | ((1 << 31) - 1 - idx)
        return torch.topk(packed, k, dim=dim).indices
    return torch.sort(key, dim=dim, descending=True, stable=True).indices.narrow(dim, 0, k)


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True, out=None):
    """``(values, int64 indices)`` of the ``k`` largest (smallest) entries
    along ``dim``, in ``lax.top_k``'s order.  A 1-D array split over more
    than one rank takes the reference's merge: each rank's own top k, one
    all-gather of the p k candidates and their global indices, the final
    pick on every rank (unsplit result).  Along another split axis the same
    merge runs column by column and the result keeps the split; along an
    unsplit axis each rank picks from its own rows."""
    from .sanitation import store_out

    dim = sanitize_axis(a.shape, dim)
    k = int(k)
    comm = a.comm
    n = a.shape[dim]
    if not 0 <= k <= n:
        raise ValueError(f"k must be in [0, {n}], got {k}")
    merge = a.split == dim and comm.size > 1
    if not merge:
        t = a.larray if a.split == dim else _local(a)
        pos = _topk_select(_topk_keys(t, largest, a.dtype), k, dim)
        vals = t.gather(dim, pos)
        if a.split == dim:
            res_v = DNDarray.from_dense(vals, dim, a.device, comm, a.dtype)
            res_i = DNDarray.from_dense(pos, dim, a.device, comm, types.int64)
        else:
            gshape = tuple(k if d == dim else s for d, s in enumerate(a.shape))
            res_v, res_i = _wrap(a, vals, gshape, a.split), _wrap(a, pos, gshape, a.split, types.int64)
    else:
        rows = a.larray.movedim(dim, 0)
        lo = _owned(comm, a.shape, dim, comm.rank)[0]
        kk = builtins.min(k, rows.shape[0])
        key = _topk_keys(rows, largest, a.dtype).to(torch.int64)
        pos = _topk_select(key, kk, 0)
        cand_k = torch.full((k,) + tuple(rows.shape[1:]), torch.iinfo(torch.int64).min, dtype=torch.int64,
                            device=rows.device)
        cand_k[:kk] = key.gather(0, pos)
        cand_i = torch.zeros_like(cand_k)
        cand_i[:kk] = pos + lo
        cand_v = rows.new_zeros((k,) + tuple(rows.shape[1:]))
        cand_v[:kk] = rows.gather(0, pos)
        every = comm.all_gather(torch.stack([cand_k, cand_i]).unsqueeze(0).contiguous(), axis=0)  # (p, 2, k, ...)
        every_v = _from_bytes(comm.all_gather(_as_bytes(cand_v)[None].contiguous(), axis=0), rows.dtype)
        keys = every[:, 0].reshape((-1,) + tuple(rows.shape[1:]))
        pick = torch.sort(keys, dim=0, descending=True, stable=True).indices[:k]
        vals = every_v.reshape((-1,) + tuple(rows.shape[1:])).gather(0, pick).movedim(0, dim)
        idx = every[:, 1].reshape((-1,) + tuple(rows.shape[1:])).gather(0, pick).movedim(0, dim)
        merged = a.ndim == 1 and k > 0 and (rows.is_floating_point() or (largest and rows.dtype != torch.bool))
        split = None if merged else dim  # the reference's merge route gives an unsplit result
        res_v = DNDarray.from_dense(vals.contiguous(), split, a.device, comm, a.dtype)
        res_i = DNDarray.from_dense(idx.contiguous(), split, a.device, comm, types.int64)
    if out is not None:
        if not (isinstance(out, tuple) and len(out) == 2):
            raise TypeError("out must be a (values, indices) tuple of DNDarrays")
        return store_out(res_v, out[0]), store_out(res_i, out[1])
    return res_v, res_i


def unfold(a: DNDarray, axis: int, size: int, step: int = 1) -> DNDarray:
    """The windows of ``size`` entries every ``step`` along ``axis``: the
    window axis at ``axis``, each window's entries as a new last axis.
    Along the split axis each rank gets the rows of its windows by one
    exchange (its own and the first ``size - 1`` of the next rank's)."""
    axis = sanitize_axis(a.shape, axis)
    if size < 1:
        raise ValueError("size must be >= 1")
    if step < 1:
        raise ValueError("step must be >= 1")
    n = a.shape[axis]
    if size > n:
        raise ValueError(f"maximum size for DNDarray at axis {axis} is {n} but size is {size}")
    windows = (n - size) // step + 1
    gshape = tuple(windows if d == axis else s for d, s in enumerate(a.shape)) + (size,)
    if a.split != axis:
        return _wrap(a, _local(a).unfold(axis, size, step).contiguous(), gshape, a.split)
    comm = a.comm
    wranges, per = _canonical_ranges(comm, windows)
    ranges = [(lo * step, (hi - 1) * step + size) if hi > lo else (0, 0) for lo, hi in wranges]
    runs = [[run] for run in _own_runs(comm, a.shape, axis)]
    rows = _exchange_runs(comm, [a.larray], runs, axis, ranges, a.larray)
    local = rows.unfold(axis, size, step) if rows.shape[axis] >= size else \
        rows.narrow(axis, 0, 0).unsqueeze(-1).expand(*rows.narrow(axis, 0, 0).shape, size)
    return _wrap(a, _pad_along(local, axis, per).contiguous(), gshape, axis)


# ----------------------------------------------------------------------
# unique
# ----------------------------------------------------------------------
def _distinct(t: torch.Tensor) -> torch.Tensor:
    """The distinct values of a 1-D tensor, sorted (``jnp.unique``'s: a
    stable sort, the first of each run of equal values, NaNs one run)."""
    if t.is_complex() or t.is_floating_point():  # by order keys: NaN last whatever its sign
        s = t[_keys.lex_sort(_keys.sort_keys(t, merge_zeros=True))]
    else:
        s = torch.sort(t, stable=True).values
    if s.numel() == 0:
        return s
    new = s[1:] != s[:-1]
    if s.is_floating_point():
        new &= ~(torch.isnan(s[1:]) & torch.isnan(s[:-1]))
    return s[torch.cat([new.new_ones(1), new])]


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False, axis=None):
    """The sorted distinct values (slices along ``axis``), split 0 where
    ``a`` is split.  A large 1-D split array rides the sample sort: each
    rank keeps the first of each run of its sorted rows (the previous rank's
    last row by one ppermute), and one exchange lays the distinct values
    out.  Otherwise each rank takes the distinct values of its own rows and
    one all-gather of those merges them; ``return_inverse`` gives each
    entry's place among them, whole on every rank as the reference's."""
    from .sample_sort import sample_sort_1d, supports_sample_sort

    if a.dtype is types.uint64:  # uint64's bits sorted as int64 keys of the same order
        keys = a._like(types._order_key(a.larray_padded, a.dtype), dtype=types.int64)
        res = unique(keys, sorted, return_inverse, axis)
        first = res[0] if return_inverse else res
        first = first._like(types._order_key(first.larray_padded, a.dtype), dtype=a.dtype)
        return (first, res[1]) if return_inverse else first
    comm = a.comm
    if axis is None and a.ndim == 1 and a.split == 0 and not return_inverse and supports_sample_sort(a, 0, False):
        v, _ = sample_sort_1d(a)
        rows = v.larray
        last = rows[-1:] if rows.shape[0] else rows.new_zeros(1)
        prev = _from_bytes(comm.ppermute(_as_bytes(last), [(i, i + 1) for i in range(comm.size - 1)]), rows.dtype)
        before = torch.cat([prev, rows[:-1]]) if rows.shape[0] else rows
        new = rows != before
        if rows.is_floating_point():
            new &= ~(torch.isnan(rows) & torch.isnan(before))
        if comm.rank == 0 and rows.shape[0]:
            new[0] = True
        mine = rows[new]
        counts = comm.all_gather(torch.tensor([mine.shape[0]], dtype=torch.int64, device=rows.device)).tolist()
        offsets = np.concatenate([[0], np.cumsum(counts)])
        runs = [[(int(offsets[r]), int(counts[r]))] for r in range(comm.size)]
        total = int(offsets[-1])
        return _wrap(a, _to_canonical(comm, [mine], runs, 0, total, mine), (total,), 0)
    if axis is not None:
        axis = sanitize_axis(a.shape, axis)
        return _unique_axis(a, axis, return_inverse)
    vals = _distinct(a.larray.reshape(-1))
    if a.split is not None and comm.size > 1:
        counts = [int(c) for c in comm.all_gather(torch.tensor([vals.numel()], device=vals.device))]
        every = comm.all_gather_varying(_as_bytes(vals), counts, 0)
        vals = _distinct(torch.cat([_from_bytes(e, vals.dtype) for e in every]))
    res = DNDarray.from_dense(vals, 0 if a.split is not None else None, a.device, comm, a.dtype)
    if not return_inverse:
        return res
    dense = a._dense() if a.split is not None else a.larray
    inverse = _inverse(vals, dense.reshape(-1)).reshape(dense.shape)
    return res, DNDarray(inverse, tuple(inverse.shape), types.int64, None, a.device, comm)


def _inverse(vals: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Each entry's place among the sorted distinct ``vals`` (NaN: the NaN
    run's)."""
    if vals.is_complex():  # the (real, imag) rows, in the same lexicographic order
        found = (torch.view_as_real(flat)[:, None, :] == torch.view_as_real(vals)[None, :, :]).all(-1)
        return found.to(torch.int64).argmax(1)
    if not vals.is_floating_point():
        vals, flat = vals.to(torch.int64), flat.to(torch.int64)
    pos = torch.searchsorted(vals, flat)
    if flat.is_floating_point():
        nan = torch.isnan(flat)
        pos = torch.where(nan, vals.numel() - 1, pos)
    return pos


def _unique_axis(a: DNDarray, axis: int, return_inverse: bool):
    """Distinct slices along ``axis``, sorted lexicographically."""
    comm = a.comm
    if a.split is not None and a.split != axis and comm.size > 1:
        a = a.resplit(axis)
    t = a.larray.movedim(axis, 0)
    flat = t.reshape(t.shape[0], -1)
    if flat.is_complex():  # (real, imag) pairs: the same lexicographic order of rows
        flat = torch.view_as_real(flat).reshape(t.shape[0], -1)
    vals = torch.unique(flat, dim=0, sorted=True)
    if a.split == axis and comm.size > 1:
        counts = [int(c) for c in comm.all_gather(torch.tensor([vals.shape[0]], device=vals.device))]
        every = comm.all_gather_varying(_as_bytes(vals), counts, 0)
        vals = torch.unique(torch.cat([_from_bytes(e, vals.dtype) for e in every]), dim=0, sorted=True)
    if t.is_complex():
        vals = torch.view_as_complex(vals.reshape(vals.shape[0], -1, 2).contiguous())
    out = vals.reshape((-1,) + tuple(t.shape[1:])).movedim(0, axis).contiguous()
    res = DNDarray.from_dense(out, 0 if a.split is not None else None, a.device, comm, a.dtype)
    if not return_inverse:
        return res
    whole = (a._dense() if a.split is not None else a.larray).movedim(axis, 0).reshape(a.shape[axis], -1)
    vals = vals.reshape(vals.shape[0], -1)
    inverse = (whole[:, None, :] == vals[None, :, :]).all(-1).to(torch.int64).argmax(1)
    return res, DNDarray(inverse, tuple(inverse.shape), types.int64, None, a.device, comm)


def vsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along axis 0."""
    if x.ndim < 2:
        raise ValueError("vsplit only works on arrays of 2 or more dimensions")
    return split(x, indices_or_sections, 0)
