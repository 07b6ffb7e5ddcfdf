"""Statistical reductions (counterpart of heat_tpu/core/statistics.py)."""

from __future__ import annotations

import torch

from . import _operations, arithmetics, types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = ["argmin", "max", "mean", "min"]


def argmin(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Index of the minimum along ``axis`` (of the flattened array when
    None); ties go to the first index.  Along any axis but the split one
    each rank works on its own chunk.  Bool input is taken as 0 and 1 (torch
    has no bool argmin)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    axis = sanitize_axis(x.shape, axis)
    if isinstance(axis, tuple):
        raise TypeError("argmin takes one axis or None")

    def _argmin(t):
        return torch.argmin(t.to(torch.uint8) if t.dtype == torch.bool else t, dim=axis, keepdim=keepdims)

    if axis is not None and axis != x.split:
        local = _argmin(x.larray_padded)
        gshape = tuple(1 if d == axis else s for d, s in enumerate(x.gshape) if keepdims or d != axis)
        split = x.split if x.split is None or keepdims or x.split < axis else x.split - 1
        return x._like(local, gshape, split)
    # across the split axis: the global array decides (gathered)
    res = _argmin(x._dense())
    return DNDarray.from_dense(res, None, x.device, x.comm)


def _min_neutral(x: DNDarray):
    if types.heat_type_is_exact(x.dtype):
        return types.iinfo(x.dtype).min if x.dtype is not types.bool else False
    return -float("inf")


def _max_neutral(x: DNDarray):
    if types.heat_type_is_exact(x.dtype):
        return types.iinfo(x.dtype).max if x.dtype is not types.bool else True
    return float("inf")


def _amin(t, dims, keep):
    return torch.amin(t, dim=dims, keepdim=keep)


def _amax(t, dims, keep):
    return torch.amax(t, dim=dims, keepdim=keep)


def min(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Minimum over ``axis`` (all axes when None)."""
    return _operations.__reduce_op(x, _amin, x.comm.pmin, _max_neutral(x), axis, keepdims)


def max(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Maximum over ``axis`` (all axes when None)."""
    return _operations.__reduce_op(x, _amax, x.comm.pmax, _min_neutral(x), axis, keepdims)


def mean(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean: the masked sum over the TRUE element count."""
    if not types.heat_type_is_inexact(x.dtype):
        x = x.astype(types.float32)
    axis = sanitize_axis(x.shape, axis)
    axes = tuple(range(x.ndim)) if axis is None else (axis if isinstance(axis, tuple) else (axis,))
    n = 1
    for a in axes:
        n *= x.shape[a]
    return arithmetics.sum(x, axis=axis, keepdims=keepdims) / n
