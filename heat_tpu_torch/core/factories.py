"""Array creation (counterpart of heat_tpu/core/factories.py).

Each rank builds or receives the global data and keeps its own chunk of the
canonical layout (:meth:`DNDarray.from_dense`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.comm import sanitize_comm
from . import types
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["arange", "array", "empty", "zeros"]


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Evenly spaced values in [start, stop)."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    elif len(args) == 3:
        start, stop, step = args
    else:
        raise TypeError(f"arange takes 1 to 3 positional arguments, got {len(args)}")
    if dtype is None:
        ints = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
        dtype = types.int32 if ints else types.float32
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    data = torch.arange(start, stop, step, dtype=dtype.torch_type(), device=device.torch_device)
    return DNDarray.from_dense(data, sanitize_axis(data.shape, split), device, sanitize_comm(comm))


def array(obj, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """A DNDarray from array-like data, distributed along ``split``.

    Python floats default to float32, python ints to int32 and python complex
    numbers to complex64; numpy arrays
    and tensors keep their dtype.  A tensor already on the target device is
    not copied (the DNDarray may share its memory).  A DNDarray comes back
    as it is, cast when ``dtype`` differs and moved when ``device`` does;
    another split or another communication raises until ``resplit`` is
    ported."""
    if isinstance(obj, DNDarray):
        if split is not None and sanitize_axis(obj.shape, split) != obj.split:
            raise NotImplementedError(
                f"ht.array of a DNDarray split along {obj.split} with split={split} needs resplit, "
                "not ported yet (ROADMAP Queue 1 item 4)"
            )
        if comm is not None and sanitize_comm(comm) is not obj.comm:
            raise NotImplementedError(
                "ht.array of a DNDarray onto another communication needs resplit, "
                "not ported yet (ROADMAP Queue 1 item 4)"
            )
        if device is not None and sanitize_device(device) != obj.device:
            device = sanitize_device(device)
            moved = obj.larray_padded.to(device.torch_device)
            obj = DNDarray(moved, obj.gshape, obj.dtype, obj.split, device, obj.comm)
        if dtype is not None and types.canonical_heat_type(dtype) != obj.dtype:
            obj = obj.astype(dtype)
        return obj
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    if isinstance(obj, torch.Tensor):
        data = obj.to(device.torch_device)
    else:
        explicit = isinstance(obj, (np.ndarray, np.generic))
        host = np.asarray(obj)
        if not explicit and host.dtype == np.float64:
            host = host.astype(np.float32)
        elif not explicit and host.dtype == np.int64:
            host = host.astype(np.int32)
        elif not explicit and host.dtype == np.complex128:
            host = host.astype(np.complex64)
        data = torch.tensor(host, device=device.torch_device)
    if dtype is not None:
        data = data.to(types.canonical_heat_type(dtype).torch_type())
    return DNDarray.from_dense(data, sanitize_axis(data.shape, split), device, comm)


def _filled(fill, shape, dtype, split, device, comm) -> DNDarray:
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    split = sanitize_axis(shape, split)
    lshape = list(shape)
    if split is not None:
        lshape[split] = comm.padded_extent(shape[split]) // comm.size
    local = fill(tuple(lshape), dtype=dtype.torch_type(), device=device.torch_device)
    return DNDarray(local, shape, dtype, split, device, comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """An array of zeros."""
    return _filled(torch.zeros, shape, dtype, split, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """An array whose values are not initialised."""
    return _filled(torch.empty, shape, dtype, split, device, comm)
