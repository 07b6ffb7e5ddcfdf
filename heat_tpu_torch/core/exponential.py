"""Exponential and logarithmic operations (counterpart of
heat_tpu/core/exponential.py): each on each rank's padded chunk; integer
input is cast to float32 first, as the reference's wrapper casts it."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, types
from .arithmetics import _inexact, _paired, _to_inexact
from .dndarray import DNDarray

__all__ = [
    "cbrt",
    "exp",
    "expm1",
    "exp2",
    "frexp",
    "ldexp",
    "log",
    "log2",
    "log10",
    "log1p",
    "logaddexp",
    "logaddexp2",
    "nextafter",
    "reciprocal",
    "spacing",
    "sqrt",
    "square",
]


def exp(x, out=None) -> DNDarray:
    """``e ** x``."""
    return _operations.__local_op(torch.exp, x, out)


def expm1(x, out=None) -> DNDarray:
    """``e ** x - 1``."""
    return _operations.__local_op(torch.expm1, x, out)


def exp2(x, out=None) -> DNDarray:
    """``2 ** x``."""
    return _operations.__local_op(torch.exp2, x, out)


def log(x, out=None) -> DNDarray:
    """The natural logarithm."""
    return _operations.__local_op(torch.log, x, out)


def log2(x, out=None) -> DNDarray:
    """The base-2 logarithm."""
    return _operations.__local_op(torch.log2, x, out)


def log10(x, out=None) -> DNDarray:
    """The base-10 logarithm."""
    return _operations.__local_op(torch.log10, x, out)


def log1p(x, out=None) -> DNDarray:
    """``log(1 + x)``."""
    return _operations.__local_op(torch.log1p, x, out)


def logaddexp(t1, t2) -> DNDarray:
    """``log(exp(t1) + exp(t2))``."""
    return _operations.__binary_op(_inexact(torch.logaddexp), t1, t2)


def logaddexp2(t1, t2) -> DNDarray:
    """``log2(2 ** t1 + 2 ** t2)``."""
    return _operations.__binary_op(_inexact(torch.logaddexp2), t1, t2)


def sqrt(x, out=None) -> DNDarray:
    """The square root."""
    return _operations.__local_op(torch.sqrt, x, out)


def _square(a: torch.Tensor) -> torch.Tensor:
    """``a * a``; bools in int32, the reference's type."""
    if a.dtype == torch.bool:
        a = a.to(torch.int32)
    return torch.square(a)


def square(x, out=None) -> DNDarray:
    """``x * x``, in the input's type."""
    return _operations.__local_op(_square, x, out, no_cast=True)


def _cbrt(a: torch.Tensor) -> torch.Tensor:
    """The real cube root (torch has none): the sign times ``|a| ** (1/3)``."""
    return torch.sign(a) * torch.pow(a.abs(), 1.0 / 3.0)


def cbrt(x, out=None) -> DNDarray:
    """The real cube root."""
    _operations._refuse_complex("cbrt", TypeError, x)
    return _operations.__local_op(_cbrt, x, out)


def reciprocal(x, out=None) -> DNDarray:
    """``1 / x``."""
    return _operations.__local_op(torch.reciprocal, x, out)


def frexp(x, out=None):
    """``(mantissa, exponent)`` with ``x == mantissa * 2 ** exponent``, the
    mantissa in [0.5, 1) by magnitude and the exponent int32; both keep
    ``x``'s split."""
    if out is not None:
        raise NotImplementedError("frexp does not support out=")
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    _operations._refuse_complex("frexp", TypeError, x)
    data = x.larray_padded
    if not types.heat_type_is_inexact(x.dtype):
        data = types._cast(data, x.dtype, types.float32)
    mant, expo = torch.frexp(data)
    return x._like(mant)._propagate_layout_from(x), x._like(expo.to(torch.int32))._propagate_layout_from(x)


def _ldexp(a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``a * 2 ** e`` in ``a``'s inexact type, the power in two halves so
    that no intermediate power overflows where the result does not."""
    a, e = _paired(_to_inexact(a), e)
    e = e.to(torch.int64)
    half = torch.div(e, 2, rounding_mode="floor")
    two = torch.tensor(2.0, dtype=a.dtype, device=a.device)
    return a * torch.pow(two, half.to(a.dtype)) * torch.pow(two, (e - half).to(a.dtype))


def ldexp(t1, t2) -> DNDarray:
    """``t1 * 2 ** t2`` in ``t1``'s inexact type (``t2`` integral)."""
    if isinstance(t2, DNDarray) and not types.heat_type_is_exact(t2.dtype):
        raise TypeError(f"ldexp's exponent must be of integer type, got {t2.dtype.__name__}")
    if isinstance(t1, DNDarray) and isinstance(t2, DNDarray):
        # the exponent meets the mantissa in the mantissa's inexact type
        if not types.heat_type_is_inexact(t1.dtype):
            t1 = t1.astype(types.float64 if t1.dtype is types.int64 else types.float32)
        t2 = t2.astype(t1.dtype)
    return _operations.__binary_op(_ldexp, t1, t2)


def nextafter(t1, t2) -> DNDarray:
    """The next representable value after ``t1`` towards ``t2``."""
    return _operations.__binary_op(_inexact(torch.nextafter), t1, t2)


def _spacing(a: torch.Tensor) -> torch.Tensor:
    """The distance to the next value away from zero; at the largest
    magnitudes JAX's rule: the smallest subnormal with the sign of ``a``."""
    if a.is_complex():
        raise ValueError("spacing is not defined for complex inputs.")
    inf = torch.full_like(a, float("inf"))
    res = torch.nextafter(a, torch.copysign(inf, a)) - a
    if a.dtype == torch.float16:
        return torch.nextafter(a, inf) - a
    tiny = float(np.finfo(types.numpy_type(types.canonical_heat_type(a.dtype))).smallest_subnormal)
    return torch.where(res == 0, torch.copysign(torch.full_like(a, tiny), a), res)


def spacing(x, out=None) -> DNDarray:
    """The distance from ``x`` to the next representable value."""
    return _operations.__local_op(_spacing, x, out)
