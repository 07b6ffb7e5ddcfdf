"""Generic wrappers behind the element-wise and reducing operations
(counterpart of heat_tpu/core/_operations.py).

Element-wise work runs on each rank's padded chunk; the padding carries
arbitrary values through it.  A reduction sets the padding to the
operation's neutral element first and, when it reduces the split axis,
combines the ranks' partial results with one all-reduce.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import types
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape, sanitize_axis

__all__ = []

_SCALARS = (bool, int, float)


def _as_dndarray(v, like: DNDarray) -> DNDarray:
    """A numpy scalar or array as an unsplit DNDarray of its own dtype on
    ``like``'s device and communicator, as the reference's ``_as_dndarray``
    makes it; anything else is returned as it is."""
    if isinstance(v, (np.generic, np.ndarray)):
        from . import factories

        return factories.array(v, device=like.device, comm=like.comm)
    return v


def _refuse_widened(operation, *dtypes) -> None:
    """Raise for the types held in a wider dtype (uint16, uint32, uint64)
    where ``operation`` is not ported for them: their holding dtype would
    give another type's answer."""
    for t in dtypes:
        if t in types._WIDENED:
            name = getattr(operation, "__name__", "").lstrip("_")
            name = "this operation" if not name or name.startswith("<") else name
            raise TypeError(f"{name} is not ported for {t.__name__}")


def __binary_op(operation: Callable, t1, t2, widened: Optional[Callable] = None) -> DNDarray:
    """``operation`` element-wise on two operands with numpy broadcasting;
    at least one is a DNDarray, the other may be a python scalar or a numpy
    scalar or array.  Two DNDarrays of different types meet in their
    promoted type (``types.promote_types``), as the reference's do: a 0-d
    operand widens the result like any other.

    Where the operands meet in uint16, uint32 or uint64, ``widened(a, b,
    t)`` computes on the holding tensors: its result is of type t, or bool
    where its tensor is bool.  Without it the operation raises for those
    types."""
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(f"at least one operand must be a DNDarray, got {type(t1)} and {type(t2)}")
    like = t1 if isinstance(t1, DNDarray) else t2
    t1, t2 = _as_dndarray(t1, like), _as_dndarray(t2, like)
    if isinstance(t1, _SCALARS) or isinstance(t2, _SCALARS):
        # a python scalar meets the array as the reference's 0-d array of
        # its own type (bool, int32, float32): both in the promoted type
        arr, v = (t1, t2) if isinstance(t1, DNDarray) else (t2, t1)
        common = types.promote_types(arr.dtype, types.heat_type_of(v))
        data = types._cast(arr.larray_padded, arr.dtype, common)
        if common in types._WIDENED:
            if widened is None:
                _refuse_widened(operation, common)
            s = torch.tensor(int(v), dtype=common.torch_type())  # only a bool meets them in their own type
            out = widened(data, s, common) if t1 is arr else widened(s, data, common)
            return arr._like(out, dtype=types.bool if out.dtype == torch.bool else common)
        # a 0-d host tensor: CUDA kernels take it as a scalar argument
        s = torch.tensor(v, dtype=common.torch_type())
        return arr._like(operation(data, s) if t1 is arr else operation(s, data))
    if not isinstance(t1, DNDarray) or not isinstance(t2, DNDarray):
        raise TypeError(f"operands must be DNDarrays, numpy or python scalars, got {type(t1)} and {type(t2)}")
    if t1.dtype != t2.dtype:
        common = types.promote_types(t1.dtype, t2.dtype)
        t1, t2 = t1.astype(common), t2.astype(common)
    wide = t1.dtype if t1.dtype in types._WIDENED else None
    if wide is not None:
        if widened is None:
            _refuse_widened(operation, wide)
        operation = lambda a, b: widened(a, b, wide)  # noqa: E731

    def wrap(out, gshape, split):
        dtype = wide if wide is not None and out.dtype != torch.bool else None
        return t1._like(out, gshape, split, dtype)

    gshape = broadcast_shape(t1.gshape, t2.gshape)
    ndim = len(gshape)
    # the split of the result, in the result's axes
    s1 = None if t1.split is None else t1.split + ndim - t1.ndim
    s2 = None if t2.split is None else t2.split + ndim - t2.ndim
    if s1 is None and s2 is None:
        return wrap(operation(t1.larray_padded, t2.larray_padded), gshape, None)
    if s1 == s2 and t1.gshape[t1.split] == t2.gshape[t2.split]:
        return wrap(operation(t1.larray_padded, t2.larray_padded), gshape, s1)
    # one operand split, the other whole and of extent 1 (or absent) along
    # the split axis: the chunks broadcast locally
    split_op, whole = (t1, t2) if s1 is not None else (t2, t1)
    s = s1 if s1 is not None else s2
    whole_axis = s - (ndim - whole.ndim)
    if whole.split is None and (whole_axis < 0 or whole.gshape[whole_axis] == 1):
        a = t1.larray_padded
        b = t2.larray_padded
        return wrap(operation(a, b), gshape, s)
    # general case: work on the dense arrays, keep the first split
    out = DNDarray.from_dense(operation(t1._dense(), t2._dense()), s, t1.device, t1.comm)
    return wrap(out.larray_padded, gshape, s)


def __local_op(operation: Callable, x: DNDarray, no_cast: bool = False, **kwargs) -> DNDarray:
    """``operation`` on each rank's chunk; integer input is cast to float32
    first unless ``no_cast``.  Raises for the types held wider (uint16,
    uint32, uint64)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    _refuse_widened(operation, x.dtype)
    data = x.larray_padded
    if not no_cast and not types.heat_type_is_inexact(x.dtype):
        data = data.to(torch.float32)
    return x._like(operation(data, **kwargs))


def __reduce_op(
    x: DNDarray,
    partial_op: Callable,
    reduction: Optional[Callable],
    neutral,
    axis=None,
    keepdims: bool = False,
) -> DNDarray:
    """Reduce ``x`` over ``axis`` (all axes when None): ``partial_op(tensor,
    dims, keepdim)`` on the masked chunk, then ``reduction`` (an in-place
    all-reduce such as ``comm.psum``) when the split axis is reduced."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    _refuse_widened(partial_op, x.dtype)
    axis = sanitize_axis(x.shape, axis)
    axes = tuple(range(x.ndim)) if axis is None else (axis if isinstance(axis, tuple) else (axis,))
    split = x.split
    data = x._masked(neutral) if split in axes else x.larray_padded
    local = partial_op(data, axes, keepdims) if axes else data
    gshape = tuple(1 if d in axes else s for d, s in enumerate(x.gshape) if keepdims or d not in axes)
    if split is None:
        return x._like(local, gshape, None)
    if split in axes:
        return x._like(reduction(local.contiguous()), gshape, None)
    out_split = split if keepdims else split - sum(1 for a in axes if a < split)
    return x._like(local, gshape, out_split)
