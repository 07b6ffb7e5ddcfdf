"""Shape and axis helpers (counterpart of heat_tpu/core/stride_tricks.py)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["broadcast_shape", "broadcast_shapes", "sanitize_axis", "sanitize_shape", "sanitize_slice"]


def broadcast_shape(shape_a: Sequence[int], shape_b: Sequence[int]) -> Tuple[int, ...]:
    """NumPy-broadcast result shape of two shapes."""
    try:
        return tuple(np.broadcast_shapes(tuple(shape_a), tuple(shape_b)))
    except ValueError:
        raise ValueError(f"operands could not be broadcast, input shapes {tuple(shape_a)} {tuple(shape_b)}") from None


def broadcast_shapes(*shapes: Sequence[int]) -> Tuple[int, ...]:
    """NumPy-broadcast result shape of any number of shapes."""
    try:
        return tuple(np.broadcast_shapes(*[tuple(s) for s in shapes]))
    except ValueError:
        raise ValueError(f"operands could not be broadcast, input shapes {shapes}") from None


def sanitize_axis(
    shape: Sequence[int], axis: Optional[Union[int, Sequence[int]]]
) -> Optional[Union[int, Tuple[int, ...]]]:
    """Normalize a (possibly negative, possibly tuple) axis against ``shape``."""
    ndim = len(shape)
    if axis is None:
        return None
    if isinstance(axis, (list, tuple, np.ndarray)):
        out: List[int] = []
        for a in (int(a) for a in axis):
            if not -ndim <= a < max(ndim, 1):
                raise ValueError(f"axis {a} is out of bounds for {ndim}-dimensional array")
            out.append(a % ndim if ndim else 0)
        if len(set(out)) != len(out):
            raise ValueError("duplicate axes given")
        return tuple(sorted(out))
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")
    axis = int(axis)
    if ndim == 0 and axis in (-1, 0):
        return None
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} is out of bounds for {ndim}-dimensional array")
    return axis % ndim


def sanitize_shape(shape: Union[int, Sequence[int]], lval: int = 0) -> Tuple[int, ...]:
    """Normalize a shape argument to a tuple of ints no smaller than ``lval``."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    elif isinstance(shape, (list, tuple, np.ndarray)):
        shape = tuple(int(s) for s in shape)
    else:
        raise TypeError(f"expected sequence object with length >= 0 or a single integer, got {type(shape)}")
    for s in shape:
        if s < lval:
            raise ValueError(f"negative dimensions are not allowed, got {shape}")
    return shape


def sanitize_slice(s: slice, max_dim: int) -> slice:
    """``s`` with its Nones and negative bounds resolved against ``max_dim``."""
    if not isinstance(s, slice):
        raise TypeError("can only be applied to slice objects")
    return slice(*s.indices(max_dim))
