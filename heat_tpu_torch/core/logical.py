"""Logical operations (counterpart of heat_tpu/core/logical.py).

``all`` and ``any`` reduce with the padding set to True and False; over the
split axis the ranks' partial answers meet in one all-reduce (a minimum or
a maximum of bytes).  ``allclose`` answers for the whole global array with
one Python bool (one all-reduce of the count of mismatches).  The
element-wise tests and logical operations run on each rank's chunk.
"""

from __future__ import annotations

import builtins

import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = [
    "all",
    "allclose",
    "any",
    "isclose",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "signbit",
]


def _truth(x: DNDarray) -> DNDarray:
    """``x != 0`` as a bool DNDarray (the truth of each element)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    data = x.larray_padded
    return x._like(data if data.dtype == torch.bool else data != 0, dtype=types.bool)


def _store(result: DNDarray, out):
    """``result``, or written into ``out`` (of its shape) and ``out``."""
    if out is None:
        return result
    if not isinstance(out, DNDarray) or out.shape != result.shape:
        raise ValueError(f"out must be a DNDarray of shape {result.shape}")
    if result.split != out.split:
        result = result.resplit(out.split)
    out._replace(types._cast(result.larray_padded, result.dtype, out.dtype))
    return out


def _bytes_reduce(x: DNDarray, reduce):
    """An all-reduce of a bool tensor through bytes."""
    return lambda t: reduce(t.to(torch.uint8)).to(torch.bool)


def all(x, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """True where every element along ``axis`` (all axes when None) is
    non-zero; the padding counts as True."""
    t = _truth(x)
    res = _operations.__reduce_op(
        t, lambda d, dims, keep: torch.amin(d.to(torch.uint8), dim=dims, keepdim=keep).to(torch.bool),
        _bytes_reduce(t, t.comm.pmin), True, axis, keepdims,
    )
    return _store(res, out)


def any(x, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """True where some element along ``axis`` (all axes when None) is
    non-zero; the padding counts as False."""
    t = _truth(x)
    res = _operations.__reduce_op(
        t, lambda d, dims, keep: torch.amax(d.to(torch.uint8), dim=dims, keepdim=keep).to(torch.bool),
        _bytes_reduce(t, t.comm.pmax), False, axis, keepdims,
    )
    return _store(res, out)


def _inexact(a: torch.Tensor, b: torch.Tensor):
    """Both operands in one inexact dtype (integers and bools as float64,
    as the reference's isclose promotes them)."""
    rt = torch.result_type(a, b)
    if not (rt.is_floating_point or rt.is_complex):
        rt = torch.float64
    return a.to(rt), b.to(rt)


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> DNDarray:
    """Element-wise ``|x - y| <= atol + rtol |y|``."""

    def close(a, b):
        return torch.isclose(*_inexact(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan)

    def close_widened(a, b, t):
        return close(types._cast(a, t, types.float64), types._cast(b, t, types.float64))

    return _operations.__binary_op(close, x, y, widened=close_widened)


def allclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> bool:
    """True iff ``x`` and ``y`` are close everywhere: each rank counts the
    mismatches among its true entries, then one all-reduce."""
    close = isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)
    mismatches = torch.count_nonzero(~close.larray).reshape(1)
    if close.split is not None:
        close.comm.psum(mismatches)
    return builtins.bool(int(mismatches[0]) == 0)


def _test(x, op, unsigned_answer, out=None) -> DNDarray:
    """An element-wise test; on the widened unsigned types (held in signed
    dtypes) the answer every unsigned value gives."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    if x.dtype in types._WIDENED:
        data = x.larray_padded
        res = x._like(torch.full(data.shape, unsigned_answer, dtype=torch.bool, device=data.device), dtype=types.bool)
    else:
        res = _operations.__local_op(op, x, no_cast=True)
    return _store(res, out)


def isfinite(x, *, out=None) -> DNDarray:
    """Element-wise: True where ``x`` is finite."""
    return _test(x, torch.isfinite, True, out)


def isinf(x, *, out=None) -> DNDarray:
    """Element-wise: True where ``x`` is +-inf."""
    return _test(x, torch.isinf, False, out)


def isnan(x, *, out=None) -> DNDarray:
    """Element-wise: True where ``x`` is NaN."""
    return _test(x, torch.isnan, False, out)


def isneginf(x, out=None) -> DNDarray:
    """Element-wise: True where ``x`` is -inf."""
    _operations._refuse_complex("isneginf", ValueError, x)
    return _test(x, torch.isneginf, False, out)


def isposinf(x, out=None) -> DNDarray:
    """Element-wise: True where ``x`` is +inf."""
    _operations._refuse_complex("isposinf", ValueError, x)
    return _test(x, torch.isposinf, False, out)


def signbit(x, out=None) -> DNDarray:
    """Element-wise: True where the sign bit is set (never for unsigned)."""
    _operations._refuse_complex("signbit", ValueError, x)
    return _test(x, torch.signbit, False, out)


def logical_not(t, out=None) -> DNDarray:
    """Element-wise logical NOT."""
    return _store(_truth(t)._like(~_truth(t).larray_padded, dtype=types.bool), out)


def _logical(op):
    return lambda a, b, t: op(a, b)


def logical_and(t1, t2) -> DNDarray:
    """Element-wise logical AND."""
    return _operations.__binary_op(torch.logical_and, t1, t2, widened=_logical(torch.logical_and))


def logical_or(t1, t2) -> DNDarray:
    """Element-wise logical OR."""
    return _operations.__binary_op(torch.logical_or, t1, t2, widened=_logical(torch.logical_or))


def logical_xor(t1, t2) -> DNDarray:
    """Element-wise logical XOR."""
    return _operations.__binary_op(torch.logical_xor, t1, t2, widened=_logical(torch.logical_xor))
