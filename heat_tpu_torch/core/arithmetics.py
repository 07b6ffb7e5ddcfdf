"""Arithmetic operations (counterpart of heat_tpu/core/arithmetics.py)."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_and_",
    "bitwise_not",
    "bitwise_not_",
    "bitwise_or",
    "bitwise_or_",
    "bitwise_xor",
    "bitwise_xor_",
    "div",
    "invert",
    "invert_",
    "left_shift",
    "left_shift_",
    "mul",
    "neg",
    "pow",
    "right_shift",
    "right_shift_",
    "sub",
    "sum",
]

_SCAN_BLOCK = 4096


def add(t1, t2) -> DNDarray:
    """Element-wise ``t1 + t2``."""
    return _operations.__binary_op(torch.add, t1, t2)


def _subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` in the reference's type: torch subtracts no bools, so a bool
    operand is cast to the result type first; two bools raise, as there."""
    rt = torch.result_type(a, b)
    if rt == torch.bool:
        raise TypeError("sub does not accept two bool operands")
    return torch.sub(a.to(rt) if a.dtype == torch.bool else a, b.to(rt) if b.dtype == torch.bool else b)


def sub(t1, t2) -> DNDarray:
    """Element-wise ``t1 - t2``."""
    return _operations.__binary_op(_subtract, t1, t2)


def mul(t1, t2) -> DNDarray:
    """Element-wise ``t1 * t2``."""
    return _operations.__binary_op(torch.mul, t1, t2)


def _true_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` in the reference's type: int64 operands divide in float64
    (torch would give its default float32), int32 and bool in float32."""
    if torch.result_type(a, b) == torch.int64:
        return torch.true_divide(a.to(torch.float64), b.to(torch.float64))
    return torch.true_divide(a, b)


def div(t1, t2) -> DNDarray:
    """Element-wise true division ``t1 / t2``."""
    return _operations.__binary_op(_true_divide, t1, t2)


def _power(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ** b``; two bools meet in int32, the reference's type (torch has
    no bool power)."""
    if torch.result_type(a, b) == torch.bool:
        return torch.pow(a.to(torch.int32), b.to(torch.int32))
    return torch.pow(a, b)


def pow(t1, t2) -> DNDarray:
    """Element-wise ``t1 ** t2``."""
    return _operations.__binary_op(_power, t1, t2)


def neg(x: DNDarray) -> DNDarray:
    """Element-wise ``-x``; bool input raises, as in the reference."""
    if isinstance(x, DNDarray) and x.dtype is types.bool:
        raise TypeError("neg does not accept dtype bool")
    return _operations.__local_op(torch.neg, x, no_cast=True)


def sum(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Sum over ``axis`` (all axes when None); padding counts as 0."""
    return _operations.__reduce_op(
        x, lambda t, dims, keep: torch.sum(t, dim=dims, keepdim=keep), x.comm.psum, 0, axis, keepdims
    )


def _ordered_cumsum(w: torch.Tensor) -> torch.Tensor:
    """The inclusive cumulative sum of the 1-D tensor ``w``, added in the
    same order in every run: row-wise scans of blocks of 4096 (zero-padded
    to at least two rows, so that torch takes its row-wise scan), each
    offset by the sum of the blocks before it, accumulated on the host in
    ``w``'s dtype.  ``torch.cumsum`` of a whole CUDA vector is a decoupled
    look-back scan whose rounding changes from run to run."""
    n = w.shape[0]
    rows = max(2, -(-n // _SCAN_BLOCK))
    scans = torch.cumsum(torch.nn.functional.pad(w, (0, rows * _SCAN_BLOCK - n)).view(rows, _SCAN_BLOCK), 1)
    totals = scans[:, -1].cpu().numpy()
    offsets = np.concatenate([np.zeros(1, totals.dtype), np.cumsum(totals[:-1], dtype=totals.dtype)])
    return (scans + torch.from_numpy(offsets).to(w.device)[:, None]).view(-1)[:n]


# ----------------------------------------------------------------------
# bitwise operations (heat_tpu/core/arithmetics.py:76-100, :187-290)
# ----------------------------------------------------------------------
# the bits of the widened types' values within their holding dtype
_WIDTH_MASK = {types.uint16: 0xFFFF, types.uint32: 0xFFFFFFFF}


def _check_int_or_bool(t1, t2, name: str) -> None:
    """Raise unless both operands, and the type they meet in, are integer
    or bool (uint64 and a python int meet in float64, as in the reference)."""
    for t in (t1, t2):
        if isinstance(t, DNDarray) and not types.heat_type_is_exact(t.dtype):
            raise TypeError(f"{name} is only supported for integer or boolean types, got {t.dtype.__name__}")
        if isinstance(t, float):
            raise TypeError(f"{name} is only supported for integer or boolean types, got float")
    met = types.promote_types(types.heat_type_of(t1), types.heat_type_of(t2))
    if not types.heat_type_is_exact(met):
        raise TypeError(f"{name} is only supported for integer or boolean types, the operands meet in "
                        f"{met.__name__}")


def _held(op):
    """A bitwise operation on holding tensors of a widened type: and, or
    and xor of values that fit give values that fit, on uint64's bits
    too."""
    return lambda a, b, t: op(a, b)


def bitwise_and(t1, t2) -> DNDarray:
    """Element-wise AND of the bits (of the truth values for bool)."""
    _check_int_or_bool(t1, t2, "bitwise_and")
    return _operations.__binary_op(torch.bitwise_and, t1, t2, _held(torch.bitwise_and))


def bitwise_or(t1, t2) -> DNDarray:
    """Element-wise OR of the bits."""
    _check_int_or_bool(t1, t2, "bitwise_or")
    return _operations.__binary_op(torch.bitwise_or, t1, t2, _held(torch.bitwise_or))


def bitwise_xor(t1, t2) -> DNDarray:
    """Element-wise XOR of the bits."""
    _check_int_or_bool(t1, t2, "bitwise_xor")
    return _operations.__binary_op(torch.bitwise_xor, t1, t2, _held(torch.bitwise_xor))


def invert(t) -> DNDarray:
    """Element-wise bit inversion (logical NOT for bool)."""
    if not isinstance(t, DNDarray):
        raise TypeError(f"expected a DNDarray, got {type(t)}")
    if not types.heat_type_is_exact(t.dtype):
        raise TypeError(f"invert is only supported for integer or boolean types, got {t.dtype.__name__}")
    out = torch.bitwise_not(t.larray_padded)
    if t.dtype in _WIDTH_MASK:
        out = out & _WIDTH_MASK[t.dtype]
    return t._like(out, dtype=t.dtype)


bitwise_not = invert


def _shift_left(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    out = torch.bitwise_left_shift(a, b)
    return out & _WIDTH_MASK[t] if t in _WIDTH_MASK else out


def _shift_right(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Logical right shift of unsigned values: the held uint16 and uint32
    values are not negative; uint64's bits shift arithmetically in int64,
    so the sign copies are masked off."""
    out = torch.bitwise_right_shift(a, b)
    if t is not types.uint64:
        return out
    b = torch.as_tensor(b, device=out.device).to(torch.int64)
    keep = torch.where(b > 0, torch.bitwise_left_shift(torch.ones_like(b), 64 - b) - 1, torch.full_like(b, -1))
    return out & keep


def left_shift(t1, t2) -> DNDarray:
    """Element-wise ``t1 << t2``."""
    _check_int_or_bool(t1, t2, "left_shift")
    return _operations.__binary_op(torch.bitwise_left_shift, t1, t2, _shift_left)


def right_shift(t1, t2) -> DNDarray:
    """Element-wise ``t1 >> t2`` (arithmetic for signed, logical for
    unsigned types)."""
    _check_int_or_bool(t1, t2, "right_shift")
    return _operations.__binary_op(torch.bitwise_right_shift, t1, t2, _shift_right)


def _inplace(t1, result: DNDarray) -> DNDarray:
    """Store ``result`` into ``t1`` (same shape; cast back to t1's type where
    the reference's intuitive casting allows it)."""
    if not isinstance(t1, DNDarray):
        raise TypeError(f"in-place operations require a DNDarray target, got {type(t1)}")
    if result.shape != t1.shape:
        raise ValueError(f"non-broadcastable output operand with shape {t1.shape} doesn't match the broadcast shape "
                         f"{result.shape}")
    if result.dtype != t1.dtype and not types.can_cast(result.dtype, t1.dtype):
        raise TypeError(f"cannot cast {result.dtype.__name__} back to {t1.dtype.__name__} for in-place operation")
    if result.split != t1.split:
        result = result.resplit(t1.split)
    t1._replace(types._cast(result.larray_padded, result.dtype, t1.dtype))
    return t1


def bitwise_and_(t1, t2) -> DNDarray:
    """In-place bitwise AND."""
    return _inplace(t1, bitwise_and(t1, t2))


def bitwise_or_(t1, t2) -> DNDarray:
    """In-place bitwise OR."""
    return _inplace(t1, bitwise_or(t1, t2))


def bitwise_xor_(t1, t2) -> DNDarray:
    """In-place bitwise XOR."""
    return _inplace(t1, bitwise_xor(t1, t2))


def invert_(t) -> DNDarray:
    """In-place bit inversion."""
    return _inplace(t, invert(t))


bitwise_not_ = invert_


def left_shift_(t1, t2) -> DNDarray:
    """In-place left shift."""
    return _inplace(t1, left_shift(t1, t2))


def right_shift_(t1, t2) -> DNDarray:
    """In-place right shift."""
    return _inplace(t1, right_shift(t1, t2))
