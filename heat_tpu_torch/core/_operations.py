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


def _scalar_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """A python scalar as a 0-d tensor that promotes with ``like`` as the
    scalar itself does in the reference: in ``like``'s dtype when of the same
    kind, an int beside bool data in the reference's default integer type
    (int32), else in torch's default type of its own kind."""
    if isinstance(v, float) and like.is_floating_point():
        return torch.tensor(v, dtype=like.dtype)
    if isinstance(v, int) and not isinstance(v, bool) and not like.is_floating_point():
        return torch.tensor(v, dtype=torch.int32 if like.dtype == torch.bool else like.dtype)
    return torch.tensor(v)


def _as_dndarray(v, like: DNDarray) -> DNDarray:
    """A numpy scalar or array as an unsplit DNDarray of its own dtype on
    ``like``'s device and communicator, as the reference's ``_as_dndarray``
    makes it; anything else is returned as it is."""
    if isinstance(v, (np.generic, np.ndarray)):
        from . import factories

        return factories.array(v, device=like.device, comm=like.comm)
    return v


def __binary_op(operation: Callable, t1, t2) -> DNDarray:
    """``operation`` element-wise on two operands with numpy broadcasting;
    at least one is a DNDarray, the other may be a python scalar or a numpy
    scalar or array.  Two DNDarrays of different types meet in their
    promoted type (``types.promote_types``), as the reference's do: a 0-d
    operand widens the result like any other."""
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(f"at least one operand must be a DNDarray, got {type(t1)} and {type(t2)}")
    like = t1 if isinstance(t1, DNDarray) else t2
    t1, t2 = _as_dndarray(t1, like), _as_dndarray(t2, like)
    if isinstance(t1, _SCALARS) or isinstance(t2, _SCALARS):
        # a python scalar becomes a 0-d tensor, which (like the scalar)
        # does not widen the array's type within its kind
        arr = t1 if isinstance(t1, DNDarray) else t2
        data = arr.larray_padded
        a = data if t1 is arr else _scalar_tensor(t1, data)
        b = data if t2 is arr else _scalar_tensor(t2, data)
        return arr._like(operation(a, b))
    if not isinstance(t1, DNDarray) or not isinstance(t2, DNDarray):
        raise TypeError(f"operands must be DNDarrays, numpy or python scalars, got {type(t1)} and {type(t2)}")
    if t1.dtype != t2.dtype:
        common = types.promote_types(t1.dtype, t2.dtype)
        t1, t2 = t1.astype(common), t2.astype(common)
    gshape = broadcast_shape(t1.gshape, t2.gshape)
    ndim = len(gshape)
    # the split of the result, in the result's axes
    s1 = None if t1.split is None else t1.split + ndim - t1.ndim
    s2 = None if t2.split is None else t2.split + ndim - t2.ndim
    if s1 is None and s2 is None:
        return t1._like(operation(t1.larray_padded, t2.larray_padded), gshape, None)
    if s1 == s2 and t1.gshape[t1.split] == t2.gshape[t2.split]:
        return t1._like(operation(t1.larray_padded, t2.larray_padded), gshape, s1)
    # one operand split, the other whole and of extent 1 (or absent) along
    # the split axis: the chunks broadcast locally
    split_op, whole = (t1, t2) if s1 is not None else (t2, t1)
    s = s1 if s1 is not None else s2
    whole_axis = s - (ndim - whole.ndim)
    if whole.split is None and (whole_axis < 0 or whole.gshape[whole_axis] == 1):
        a = t1.larray_padded
        b = t2.larray_padded
        return split_op._like(operation(a, b), gshape, s)
    # general case: work on the dense arrays, keep the first split
    out = operation(t1._dense(), t2._dense())
    return DNDarray.from_dense(out, s, t1.device, t1.comm)


def __local_op(operation: Callable, x: DNDarray, no_cast: bool = False, **kwargs) -> DNDarray:
    """``operation`` on each rank's chunk; integer input is cast to float32
    first unless ``no_cast``."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
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
