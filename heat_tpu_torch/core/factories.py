"""Array creation (counterpart of heat_tpu/core/factories.py).

Every factory builds only this rank's chunk of the canonical layout: the
shape-based ones fill a tensor of the padded local shape, ``arange``,
``eye``, ``linspace`` and ``fromfunction`` compute their values from this
rank's global indices, ``meshgrid`` materializes only the chunk of each
broadcast grid.  Host data given to ``array`` is cut to this rank's rows on
the host before it is copied to the device.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..parallel.comm import sanitize_comm
from . import types
from .devices import sanitize_device
from .dndarray import DNDarray, _pad_along, _runs_to_canonical
from .random import _fma64
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "asarray",
    "empty",
    "empty_like",
    "eye",
    "frombuffer",
    "fromfunction",
    "from_partition_dict",
    "from_partitioned",
    "fromiter",
    "fromstring",
    "full",
    "full_like",
    "geomspace",
    "identity",
    "linspace",
    "logspace",
    "meshgrid",
    "ones",
    "ones_like",
    "zeros",
    "zeros_like",
]


def _local_range(extent: int, split: Optional[int], axis: int, comm):
    """``(lo, hi, padded)``: the global indices of this rank's chunk along
    ``axis`` and its padded length (the whole axis where it is not split)."""
    if split != axis:
        return 0, extent, extent
    lo, lshape, _ = comm.chunk((extent,), 0)
    return lo, lo + lshape[0], comm.padded_extent(extent) // comm.size


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Evenly spaced values ``start + i * step`` in [start, stop)."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    elif len(args) == 3:
        start, stop, step = args
    else:
        raise TypeError(f"arange takes 1 to 3 positional arguments, got {len(args)}")
    ints = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
    if dtype is None:
        dtype = types.int32 if ints else types.float32
    dtype = types.canonical_heat_type(dtype)
    if step == 0:
        raise ValueError("arange's step must not be zero")
    n = max(0, math.ceil((stop - start) / step))
    comm, device = sanitize_comm(comm), sanitize_device(device)
    split = sanitize_axis((n,), split)
    lo, hi, padded = _local_range(n, split, 0, comm)
    i = torch.arange(lo, hi, dtype=torch.int64, device=device.torch_device)
    if not ints and types.heat_type_is_exact(dtype):
        # numpy's (and so the reference's) integer arange of float bounds:
        # the first two values cast to the type, then their difference on
        start, step = int(start), int(start + step) - int(start)
        ints = True
    vals = i * int(step) + int(start) if ints else i.to(torch.float64) * float(step) + float(start)
    local = _pad_along(types._cast(vals, types.int64 if ints else types.float64, dtype), 0, padded)
    return DNDarray(local, (n,), dtype, split, device, comm)


def _host_chunk(data: np.ndarray, split: Optional[int], comm) -> np.ndarray:
    if split is None:
        return data
    return data[comm.chunk(data.shape, split)[2]]


def array(obj, dtype=None, copy: Optional[bool] = None, ndmin: int = 0, order: str = "C", split=None,
          is_split=None, device=None, comm=None) -> DNDarray:
    """A DNDarray from array-like data, distributed along ``split``.

    Python floats default to float32, python ints to int32 and python
    complex numbers to complex64; numpy arrays and tensors keep their type.
    ``is_split`` declares ``obj`` to be this rank's own chunk along that
    axis: the chunks of all ranks, in rank order, are the array (one
    all-gather of their extents, one exchange to the canonical layout).
    ``copy=True`` always copies; otherwise a tensor already on the device
    may be shared.  ``ndmin`` prepends axes of length 1.  A DNDarray comes
    back cast when ``dtype`` differs, moved when ``device`` does, resplit
    when ``split`` does and resharded (a copy, :meth:`DNDarray.reshard_`)
    when ``comm`` does."""
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive")
    if order not in ("C", "F"):
        raise ValueError(f"invalid memory layout order, expected 'C' or 'F', got {order!r}")
    if isinstance(obj, DNDarray):
        if comm is not None and sanitize_comm(comm) is not obj.comm:
            obj = obj.copy().reshard_(comm)  # a resharded copy
            copy = False
        if device is not None and sanitize_device(device) != obj.device:
            device = sanitize_device(device)
            obj = DNDarray(obj.larray_padded.to(device.torch_device), obj.gshape, obj.dtype, obj.split, device,
                           obj.comm)
        if dtype is not None and types.canonical_heat_type(dtype) != obj.dtype:
            obj = obj.astype(dtype)
        if split is not None and sanitize_axis(obj.shape, split) != obj.split:
            obj = obj.resplit(split)
        return obj.copy() if copy else obj
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    if isinstance(obj, torch.Tensor):
        src = types.canonical_heat_type(obj.dtype)
        data, host = obj, None
    else:
        explicit = isinstance(obj, (np.ndarray, np.generic))
        host = np.asarray(obj, order=order)
        if not explicit and host.dtype == np.float64:
            host = host.astype(np.float32)
        elif not explicit and host.dtype == np.int64:
            host = host.astype(np.int32)
        elif not explicit and host.dtype == np.complex128:
            host = host.astype(np.complex64)
        # ml_dtypes' bfloat16 (what the reference's numpy() returns) by its bits
        bf16 = host.dtype.name == "bfloat16"
        src = types.bfloat16 if bf16 else types.canonical_heat_type(host.dtype)
        data = None
    shape = tuple(data.shape if host is None else host.shape)
    while len(shape) < ndmin:
        shape = (1,) + shape
    if host is not None:
        host = host.reshape(shape)
    else:
        data = data.reshape(shape)
    dtype = src if dtype is None else types.canonical_heat_type(dtype)
    keep = is_split if is_split is not None else split
    keep = sanitize_axis(shape, keep)
    if host is not None:
        chunk = host if is_split is not None else _host_chunk(host, keep, comm)
        if bf16:
            chunk = np.ascontiguousarray(chunk).view(np.uint16).reshape(chunk.shape)
        else:
            chunk = np.ascontiguousarray(types._to_holding(chunk, src)).reshape(chunk.shape)
        data = torch.from_numpy(chunk if chunk.flags.writeable else chunk.copy())
        if bf16:
            data = data.view(torch.bfloat16)
    elif is_split is None and keep is not None:
        data = data[comm.chunk(shape, keep)[2]]
    local = types._cast(data.to(device.torch_device), src, dtype)
    if (copy or host is not None) and local.numel() and local.data_ptr() == data.data_ptr():
        local = local.clone()  # never the memory of the caller's numpy array
    if is_split is not None:
        return _from_chunks(local, keep, dtype, device, comm)
    if keep is None:
        return DNDarray(local, shape, dtype, None, device, comm)
    local = _pad_along(local, keep, comm.padded_extent(shape[keep]) // comm.size).contiguous()
    return DNDarray(local, shape, dtype, keep, device, comm)


def _from_chunks(local: torch.Tensor, axis: int, dtype, device, comm) -> DNDarray:
    """The array whose rank-r chunk along ``axis`` is rank r's ``local``."""
    if comm.size == 1:
        return DNDarray(local.contiguous(), tuple(local.shape), dtype, axis, device, comm)
    dims = torch.tensor([list(local.shape)], dtype=torch.int64, device=local.device)
    shapes = comm.all_gather(dims, axis=0).cpu().numpy()
    others = np.delete(shapes, axis, axis=1)
    if not (others == others[0]).all():
        raise ValueError(f"non-split dimensions must match across ranks, got {shapes.tolist()}")
    extents = shapes[:, axis]
    offsets = np.concatenate([[0], np.cumsum(extents)])
    total = int(offsets[-1])
    gshape = tuple(int(s) for s in local.shape[:axis]) + (total,) + tuple(int(s) for s in local.shape[axis + 1:])
    runs = [(int(offsets[r]), int(extents[r])) for r in range(comm.size)]
    return DNDarray(_runs_to_canonical(comm, local, axis, runs, total), gshape, dtype, axis, device, comm)


def asarray(obj, dtype=None, copy=None, order="C", is_split=None, device=None) -> DNDarray:
    """``array`` without a copy where none is needed."""
    return array(obj, dtype=dtype, copy=copy, order=order, is_split=is_split, device=device)


def _factory(shape, dtype, split, fill, device, comm) -> DNDarray:
    """An array of ``shape`` filled with ``fill`` (None: not initialised),
    built at this rank's padded local shape."""
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(types.float32 if dtype is None else dtype)
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    split = sanitize_axis(shape, split)
    lshape = list(shape)
    if split is not None:
        lshape[split] = comm.padded_extent(shape[split]) // comm.size
    dev = device.torch_device
    if fill is None:
        local = torch.empty(tuple(lshape), dtype=dtype.torch_type(), device=dev)
    else:
        if dtype in types._WIDENED and isinstance(fill, int) and not isinstance(fill, bool):
            v = fill % (1 << 64) if dtype is types.uint64 else fill
            value = torch.tensor(v - (1 << 64) if v >= 1 << 63 else v, dtype=torch.int64)
            src = types.uint64 if dtype is types.uint64 else types.int64
        else:
            value = torch.as_tensor(fill)
            src = types.canonical_heat_type(value.dtype)
        local = types._cast(value, src, dtype).to(dev).expand(tuple(lshape)).contiguous()
    return DNDarray(local, shape, dtype, split, device, comm)


def _factory_like(a, dtype, split, factory, device, comm, **kwargs) -> DNDarray:
    """``factory`` at ``a``'s shape, and its type, split, device and comm
    where not given."""
    if isinstance(a, DNDarray):
        shape = a.shape
        dtype = dtype if dtype is not None else a.dtype
        split = split if split is not None else a.split
        device = device if device is not None else a.device
        comm = comm if comm is not None else a.comm
    else:
        shape = np.shape(a)
        dtype = dtype if dtype is not None else types.heat_type_of(a)
    return factory(shape, dtype=dtype, split=split, device=device, comm=comm, **kwargs)


def empty(shape, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """An array whose values are not initialised."""
    return _factory(shape, dtype, split, None, device, comm)


def empty_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """An uninitialised array like ``a``."""
    return _factory_like(a, dtype, split, empty, device, comm)


def zeros(shape, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """An array of zeros."""
    return _factory(shape, dtype, split, 0, device, comm)


def zeros_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Zeros like ``a``."""
    return _factory_like(a, dtype, split, zeros, device, comm)


def ones(shape, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """An array of ones."""
    return _factory(shape, dtype, split, 1, device, comm)


def ones_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Ones like ``a``."""
    return _factory_like(a, dtype, split, ones, device, comm)


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """An array filled with ``fill_value`` (of its type by default)."""
    if dtype is None:
        dtype = types.heat_type_of(fill_value)
    return _factory(shape, dtype, split, fill_value, device, comm)


def full_like(a, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """``fill_value`` at ``a``'s shape."""
    return _factory_like(a, dtype, split, full, device, comm, fill_value=fill_value)


def eye(shape, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """A 2-D array with ones on the diagonal: each rank sets the diagonal
    entries of its own rows (split 0) or columns (split 1)."""
    if isinstance(shape, (int, np.integer)):
        n = m = int(shape)
    else:
        shape = sanitize_shape(shape)
        n, m = (shape[0], shape[0]) if len(shape) == 1 else (shape[0], shape[1])
    dtype = types.canonical_heat_type(types.float32 if dtype is None else dtype)
    comm, device = sanitize_comm(comm), sanitize_device(device)
    split = sanitize_axis((n, m), split)
    r0, r1, rp = _local_range(n, split, 0, comm)
    c0, c1, cp = _local_range(m, split, 1, comm)
    dev = device.torch_device
    rows = torch.arange(r0, r0 + rp, device=dev)[:, None]
    cols = torch.arange(c0, c0 + cp, device=dev)[None, :]
    local = ((rows == cols) & (rows < r1) & (cols < c1)).to(dtype.torch_type())
    return DNDarray(local, (n, m), dtype, split, device, comm)


def identity(n: int, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """The n x n identity matrix."""
    return eye(int(n), dtype=dtype, split=split, device=device, comm=comm)


def linspace(start, stop, num: int = 50, endpoint: bool = True, retstep: bool = False, dtype=None, split=None,
             device=None, comm=None):
    """``num`` evenly spaced samples over [start, stop] (or [start, stop)
    without ``endpoint``), float32 by default, computed for this rank's
    indices only.  The values follow the reference's program: ``jnp.linspace``'s
    ``start (1 - i / div) + stop (i / div)`` in float64 as XLA compiles it
    (``r = 1 / div`` and ``stop r`` folded into constants, ``1 - i r`` and
    the final sum each one fused multiply-add), the last sample ``stop``
    itself with ``endpoint``.  In float64 a few samples in 10^5 differ from
    the reference's within one rounding of the larger bound (where XLA's
    compiler fuses otherwise); after the default cast to float32 none was
    seen."""
    num = int(num)
    if num <= 0:
        raise ValueError(f"number of samples 'num' must be non-negative, got {num}")
    start, stop = float(start), float(stop)
    comm, device = sanitize_comm(comm), sanitize_device(device)
    split = sanitize_axis((num,), split)
    dtype = types.float32 if dtype is None else types.canonical_heat_type(dtype)
    lo, hi, padded = _local_range(num, split, 0, comm)
    i = torch.arange(lo, hi, dtype=torch.float64, device=device.torch_device)
    div = num - 1 if endpoint else num
    if num > 1:
        r = 1.0 / div
        sub = _fma64(-i, torch.full_like(i, r), torch.ones_like(i))
        vals = _fma64(i, torch.full_like(i, stop * r), start * sub)
        if endpoint:
            vals = torch.where(i == num - 1, torch.full_like(vals, stop), vals)
    else:
        vals = torch.full_like(i, start)
    out = DNDarray(_pad_along(types._cast(vals, types.float64, dtype), 0, padded), (num,), dtype, split, device, comm)
    if retstep:
        step = float("nan") if endpoint and num == 1 else (stop - start) / div
        return out, step
    return out


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None, split=None, device=None,
             comm=None) -> DNDarray:
    """``base ** linspace(start, stop, num)``."""
    from . import arithmetics

    y = linspace(start, stop, num=num, endpoint=endpoint, split=split, device=device, comm=comm)
    result = arithmetics.pow(base, y)
    return result.astype(dtype) if dtype is not None else result


def geomspace(start, stop, num=50, endpoint=True, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Samples spaced evenly on a log scale between ``start`` and ``stop``
    (of one sign, neither zero)."""
    if start == 0 or stop == 0:
        raise ValueError("geometric sequence cannot include zero")
    if (start < 0) != (stop < 0):
        raise ValueError("start and stop must have the same sign")
    y = logspace(math.log10(abs(start)), math.log10(abs(stop)), num=num, endpoint=endpoint, split=split,
                 device=device, comm=comm)
    result = y if start > 0 else -y
    return result.astype(dtype) if dtype is not None else result


def meshgrid(*arrays, indexing: str = "xy") -> List[DNDarray]:
    """Coordinate matrices from coordinate vectors.  If any input is split,
    the grids are split along their second (xy) or first (ij) axis; each
    rank materializes only its chunk of each broadcast grid."""
    if indexing not in ("xy", "ij"):
        raise ValueError(f"indexing must be 'xy' or 'ij', got {indexing!r}")
    if not arrays:
        return []
    inputs = [array(a) for a in arrays]
    comm, device = inputs[0].comm, inputs[0].device
    vectors = [a._dense().reshape(-1) for a in inputs]
    sizes = [v.shape[0] for v in vectors]
    axes = list(range(len(vectors)))
    if indexing == "xy" and len(vectors) > 1:
        axes[0], axes[1] = 1, 0
        sizes[0], sizes[1] = sizes[1], sizes[0]
    grids = []
    for v, ax in zip(vectors, axes):
        view = [1] * len(sizes)
        view[ax] = -1
        grids.append(v.reshape(view).expand(sizes))  # broadcast views: nothing materialized yet
    out_split = None
    if any(a.split is not None for a in inputs):
        out_split = 1 if indexing == "xy" else 0
        if grids[0].ndim <= out_split:
            out_split = 0
    out = []
    for g, a in zip(grids, inputs):
        shape = tuple(g.shape)
        if out_split is not None:
            g = _pad_along(g[comm.chunk(shape, out_split)[2]], out_split,
                           comm.padded_extent(shape[out_split]) // comm.size)
        out.append(DNDarray(g.contiguous(), shape, a.dtype, out_split, device, comm))
    return out


def fromfunction(function, shape, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """``function`` called on int64 index grids of ``shape`` (this rank's
    chunk of them), broadcast to ``shape``."""
    shape = sanitize_shape(shape)
    comm, device = sanitize_comm(comm), sanitize_device(device)
    split = sanitize_axis(shape, split)
    dev = device.torch_device
    axes = [torch.arange(*_local_range(s, split, d, comm)[:2], device=dev) for d, s in enumerate(shape)]
    grids = torch.meshgrid(*axes, indexing="ij") if shape else []
    data = torch.as_tensor(function(*grids), device=dev)
    lshape = tuple(len(a) for a in axes)
    data = data.expand(lshape) if data.shape != lshape else data
    ht_dtype = types.canonical_heat_type(data.dtype)
    if dtype is not None:
        data = types._cast(data, ht_dtype, dtype)
        ht_dtype = types.canonical_heat_type(dtype)
    if split is not None:
        data = _pad_along(data, split, comm.padded_extent(shape[split]) // comm.size)
    return DNDarray(data.contiguous(), shape, ht_dtype, split, device, comm)


def _np_type(dtype):
    return types.numpy_type(types.canonical_heat_type(dtype))


def fromiter(iter, dtype, count: int = -1, split=None, device=None, comm=None) -> DNDarray:
    """A 1-D array from an iterable."""
    arr = np.fromiter(iter, dtype=_np_type(dtype), count=count)
    return array(arr, dtype=dtype, split=split, device=device, comm=comm)


def frombuffer(buffer, dtype=types.float32, count: int = -1, offset: int = 0, split=None, device=None,
               comm=None) -> DNDarray:
    """A buffer read as a 1-D array."""
    arr = np.frombuffer(buffer, dtype=_np_type(dtype), count=count, offset=offset)
    return array(arr.copy(), dtype=dtype, split=split, device=device, comm=comm)


def fromstring(string: str, dtype=types.float32, count: int = -1, sep: str = " ", split=None, device=None,
               comm=None) -> DNDarray:
    """A 1-D array parsed from text (text mode only)."""
    if not sep:
        raise ValueError("binary-mode fromstring is not supported; use frombuffer")
    arr = np.fromstring(string, dtype=_np_type(dtype), count=count, sep=sep)
    return array(arr, dtype=dtype, split=split, device=device, comm=comm)


def from_partitioned(x, comm=None) -> DNDarray:
    """A DNDarray from an object with the ``__partitioned__`` interface."""
    return from_partition_dict(x.__partitioned__, comm=comm)


def from_partition_dict(parts: dict, comm=None) -> DNDarray:
    """A DNDarray from a ``__partitioned__`` dict.  Split along the axis
    its tiling cuts.  Where every partition carries its data the array is
    their concatenation; where each rank holds only its own (the dicts of
    DNDarrays over several ranks), each rank's partitions are its chunk,
    in rank order (``array(..., is_split=...)``: one exchange to the
    canonical layout).  The result is balanced."""
    comm = sanitize_comm(comm)
    shape = tuple(parts["shape"])
    tiling = tuple(parts.get("partition_tiling", (1,) * len(shape)))
    cut = [i for i, t in enumerate(tiling) if t > 1]
    split = cut[0] if cut else None
    getter = parts.get("get")
    pieces = []
    for key in sorted(parts["partitions"].keys()):
        data = parts["partitions"][key]["data"]
        if callable(data):
            data = data()
        elif data is not None and callable(getter):
            data = getter(data)
        pieces.append((key, data))

    def as_tensor(d):
        return d if isinstance(d, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(d))

    if all(d is not None for _, d in pieces):
        if split is None:
            return array(as_tensor(pieces[0][1]), comm=comm)
        whole = torch.cat([as_tensor(d).cpu() for _, d in pieces if np.prod(np.shape(d)) > 0], dim=split)
        return array(whole, split=split, comm=comm)
    if split is None:
        raise ValueError("an unsplit partition dict carries no data")
    mine = [as_tensor(d) for _, d in pieces if d is not None]
    if not mine:
        raise ValueError("no partition of this rank carries data")
    local = torch.cat(mine, dim=split) if len(mine) > 1 else mine[0]
    return array(local, is_split=split, comm=comm)
