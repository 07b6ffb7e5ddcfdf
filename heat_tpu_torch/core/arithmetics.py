"""Arithmetic operations (counterpart of heat_tpu/core/arithmetics.py)."""

from __future__ import annotations

import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = ["add", "div", "mul", "neg", "pow", "sub", "sum"]


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
