"""Relational operations (counterpart of heat_tpu/core/relational.py).

The element-wise comparisons go through :func:`_operations.__binary_op`, so
they broadcast, take python and numpy operands and keep the split as the
arithmetic operations do; each returns a bool DNDarray.  :func:`equal`
answers for the whole global array with one Python bool.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _operations
from .dndarray import DNDarray

__all__ = [
    "eq",
    "equal",
    "ge",
    "greater_equal",
    "gt",
    "greater",
    "le",
    "less_equal",
    "lt",
    "less",
    "ne",
    "not_equal",
]


def eq(t1, t2) -> DNDarray:
    """Element-wise ``t1 == t2``."""
    return _operations.__binary_op(torch.eq, t1, t2)


def equal(t1, t2) -> bool:
    """True iff the two operands are equal everywhere, after broadcasting;
    False for shapes that do not broadcast.  A split comparison is answered
    by each rank for its own true entries, then one all-reduce."""
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        a, b = np.asarray(t1), np.asarray(t2)
        try:
            np.broadcast_shapes(a.shape, b.shape)
        except ValueError:
            return False
        return bool(np.all(a == b))
    t1, t2 = (t if isinstance(t, (DNDarray, bool, int, float)) else np.asarray(t) for t in (t1, t2))
    try:
        np.broadcast_shapes(*(getattr(t, "shape", ()) for t in (t1, t2)))
    except ValueError:
        return False
    diff = ne(t1, t2)
    mismatches = torch.count_nonzero(diff.larray).reshape(1)
    if diff.split is not None:
        diff.comm.psum(mismatches)
    return int(mismatches[0]) == 0


def ge(t1, t2) -> DNDarray:
    """Element-wise ``t1 >= t2``."""
    return _operations.__binary_op(torch.ge, t1, t2)


greater_equal = ge


def gt(t1, t2) -> DNDarray:
    """Element-wise ``t1 > t2``."""
    return _operations.__binary_op(torch.gt, t1, t2)


greater = gt


def le(t1, t2) -> DNDarray:
    """Element-wise ``t1 <= t2``."""
    return _operations.__binary_op(torch.le, t1, t2)


less_equal = le


def lt(t1, t2) -> DNDarray:
    """Element-wise ``t1 < t2``."""
    return _operations.__binary_op(torch.lt, t1, t2)


less = lt


def ne(t1, t2) -> DNDarray:
    """Element-wise ``t1 != t2``."""
    return _operations.__binary_op(torch.ne, t1, t2)


not_equal = ne
