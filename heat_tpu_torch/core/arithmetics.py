"""Arithmetic operations (counterpart of heat_tpu/core/arithmetics.py)."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["add", "div", "mul", "neg", "pow", "sub", "sum"]


def add(t1, t2) -> DNDarray:
    """Element-wise ``t1 + t2``."""
    return _operations.__binary_op(torch.add, t1, t2)


def sub(t1, t2) -> DNDarray:
    """Element-wise ``t1 - t2``."""
    return _operations.__binary_op(torch.sub, t1, t2)


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


def pow(t1, t2) -> DNDarray:
    """Element-wise ``t1 ** t2``."""
    return _operations.__binary_op(torch.pow, t1, t2)


def neg(x: DNDarray) -> DNDarray:
    """Element-wise ``-x``."""
    return _operations.__local_op(torch.neg, x, no_cast=True)


def sum(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Sum over ``axis`` (all axes when None); padding counts as 0."""
    return _operations.__reduce_op(
        x, lambda t, dims, keep: torch.sum(t, dim=dims, keepdim=keep), x.comm.psum, 0, axis, keepdims
    )
