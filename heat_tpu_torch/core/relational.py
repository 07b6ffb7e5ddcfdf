"""Relational operations (counterpart of heat_tpu/core/relational.py).

The element-wise comparisons go through :func:`_operations.__binary_op`, so
they broadcast, take python and numpy operands and keep the split as the
arithmetic operations do; each returns a bool DNDarray.  :func:`equal`
answers for the whole global array with one Python bool.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, types
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


def _held(op):
    """A comparison on holding tensors of uint16, uint32 or uint64: equal
    values hold equal bits."""
    return lambda a, b, t: op(a, b)


_SIGN64 = -(1 << 63)


def _ordered(op):
    """An ordering on holding tensors: uint16 and uint32 values compare as
    held; uint64's bits compare as unsigned once their top bit is flipped."""

    def cmp(a, b, t):
        if t is types.uint64:
            a, b = a ^ _SIGN64, b ^ _SIGN64
        return op(a, b)

    return cmp


def _lexicographic(op, complex_op):
    """``op``, or ``complex_op`` where an operand is complex (torch does not
    order complex numbers; the reference compares them lexicographically)."""
    return lambda a, b: complex_op(a, b) if a.is_complex() or b.is_complex() else op(a, b)


_lt = _lexicographic(torch.lt, lambda a, b: _operations._lex_greater(b, a))
_le = _lexicographic(torch.le, lambda a, b: _operations._lex_greater(b, a, strict=False))
_gt = _lexicographic(torch.gt, lambda a, b: _operations._lex_greater(a, b))
_ge = _lexicographic(torch.ge, lambda a, b: _operations._lex_greater(a, b, strict=False))


def eq(t1, t2) -> DNDarray:
    """Element-wise ``t1 == t2``."""
    return _operations.__binary_op(torch.eq, t1, t2, widened=_held(torch.eq))


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
    return _operations.__binary_op(_ge, t1, t2, widened=_ordered(torch.ge))


greater_equal = ge


def gt(t1, t2) -> DNDarray:
    """Element-wise ``t1 > t2``."""
    return _operations.__binary_op(_gt, t1, t2, widened=_ordered(torch.gt))


greater = gt


def le(t1, t2) -> DNDarray:
    """Element-wise ``t1 <= t2``."""
    return _operations.__binary_op(_le, t1, t2, widened=_ordered(torch.le))


less_equal = le


def lt(t1, t2) -> DNDarray:
    """Element-wise ``t1 < t2``."""
    return _operations.__binary_op(_lt, t1, t2, widened=_ordered(torch.lt))


less = lt


def ne(t1, t2) -> DNDarray:
    """Element-wise ``t1 != t2``."""
    return _operations.__binary_op(torch.ne, t1, t2, widened=_held(torch.ne))


not_equal = ne
