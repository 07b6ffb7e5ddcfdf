"""Rounding and sign operations (counterpart of heat_tpu/core/rounding.py):
each on each rank's padded chunk."""

from __future__ import annotations

import builtins

import numpy as np
import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = [
    "abs",
    "absolute",
    "around",
    "ceil",
    "clip",
    "fabs",
    "fix",
    "floor",
    "modf",
    "rint",
    "round",
    "sgn",
    "sign",
    "trunc",
]


def _check_dtype(dtype) -> None:
    if dtype is not None and not issubclass(types.canonical_heat_type(dtype), types.number):
        raise TypeError("dtype must be a heat data type")


def _finish(res: DNDarray, out, dtype) -> DNDarray:
    """``res`` cast to ``dtype`` where given, then stored in ``out``."""
    if dtype is not None:
        res = res.astype(dtype)
    if out is not None:
        return _operations.store_out(res, out)
    return res


def _abs(a: torch.Tensor) -> torch.Tensor:
    """``|a|``: an integer's minimum wraps to itself; bools stay bools."""
    return a.clone() if a.dtype == torch.bool else torch.abs(a)


def _unsigned_identity(a: torch.Tensor, t) -> torch.Tensor:
    """``|a|`` of unsigned holding values: a copy (uint64's bits too)."""
    return a.clone()


def _unsigned_sign(a: torch.Tensor, t) -> torch.Tensor:
    """The sign of unsigned holding values: 0 or 1."""
    return (a != 0).to(a.dtype)


def abs(x, out=None, dtype=None) -> DNDarray:
    """The absolute value (the magnitude of complex values); with ``dtype``
    cast to it, with ``out`` stored in it."""
    _check_dtype(dtype)
    return _finish(_operations.__local_op(_abs, x, no_cast=True, widened=_unsigned_identity), out, dtype)


absolute = abs


def ceil(x, out=None) -> DNDarray:
    """The ceiling."""
    _operations._refuse_complex("ceil", TypeError, x)
    return _operations.__local_op(torch.ceil, x, out)


def clip(x, min=None, max=None, out=None) -> DNDarray:
    """Values clamped to [min, max] (NaN stays NaN; where min > max, max),
    in the type JAX's ``clip`` gives: python bounds are weak (a float bound
    on integers gives float64)."""
    if min is None and max is None:
        raise ValueError("either min or max must be set")
    _operations._refuse_complex("clip", ValueError, x, min, max)
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    common = types.result_type(x, *(b for b in (min, max) if b is not None))
    data = types._cast(x.larray_padded, x.dtype, common)

    def bound(b):
        if b is None:
            return b
        if isinstance(b, (builtins.int, builtins.float, builtins.bool)):
            if common not in types._WIDENED:
                return torch.as_tensor(b, dtype=data.dtype, device=data.device)
            b = np.asarray(b).astype(types.numpy_type(common))
            return torch.as_tensor(types._to_holding(b, common), device=data.device)
        if not isinstance(b, DNDarray):
            from . import factories

            b = factories.array(b, device=x.device, comm=x.comm)
        return types._cast(_operations._aligned(b, x.shape, x.split), b.dtype, common).to(data.device)

    # uint64's bits are clamped in the order of their values
    lo, hi, data = (None if v is None else types._order_key(v, common) for v in (bound(min), bound(max), data))
    if lo is not None:
        data = torch.maximum(data, lo)
    if hi is not None:
        data = torch.minimum(data, hi)
    res = x._like(types._order_key(data, common), dtype=common)
    if out is not None:
        return _operations.store_out(res, out)
    return res._propagate_layout_from(x)


def fabs(x, out=None) -> DNDarray:
    """The absolute value as a float."""
    _operations._refuse_complex("fabs", TypeError, x)
    return _operations.__local_op(torch.abs, x, out)


def floor(x, out=None) -> DNDarray:
    """The floor."""
    _operations._refuse_complex("floor", TypeError, x)
    return _operations.__local_op(torch.floor, x, out)


def _modf_parts(a: torch.Tensor):
    """JAX's ``modf``: the whole part rounds toward zero; the fraction is
    ``a`` minus it (NaN for infinities)."""
    whole = torch.where(a < 0, torch.ceil(a), torch.floor(a))
    return a - whole, whole


def modf(x, out=None):
    """``(fractional part, integral part)``, two arrays of ``x``'s split."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    _operations._refuse_complex("modf", TypeError, x)
    if out is not None and (not isinstance(out, tuple) or len(out) != 2):
        raise TypeError("expected out to be None or a tuple of two DNDarrays")
    outs = (None, None) if out is None else out
    frac = _operations.__local_op(lambda a: _modf_parts(a)[0], x, outs[0])
    whole = _operations.__local_op(lambda a: _modf_parts(a)[1], x, outs[1])
    return frac, whole


def _round_float(a: torch.Tensor, decimals: int) -> torch.Tensor:
    """JAX's ``round`` as XLA compiles it: half to even after scaling by
    10**decimals, then a product by the reciprocal of the scale (XLA turns
    the division by the constant into that product)."""
    if decimals == 0:
        return torch.round(a)
    x = a.to(torch.float32) if a.dtype == torch.float16 else a
    factor = torch.tensor(10.0 ** decimals, dtype=x.dtype)
    inverse = torch.tensor(1.0, dtype=x.dtype) / factor
    out = torch.round(x * factor) * inverse
    return out.to(a.dtype)


def _round(decimals: int):
    def op(a: torch.Tensor) -> torch.Tensor:
        real = a.real.dtype if a.is_complex() else a.dtype
        if decimals > np.log10(np.finfo(types.numpy_type(types.canonical_heat_type(real))).max):
            return a.clone()
        if a.is_complex():
            return torch.complex(_round_float(a.real, decimals), _round_float(a.imag, decimals))
        return _round_float(a, decimals)

    return op


def round(x, decimals: int = 0, out=None, dtype=None) -> DNDarray:
    """Round half to even to ``decimals`` decimals, with the reference's
    values (``round(2.675, 2)`` in float32 is 2.6799998); integer input
    is rounded as float32."""
    _check_dtype(dtype)
    return _finish(_operations.__local_op(_round(int(decimals)), x), out, dtype)


around = round


def _rint(a: torch.Tensor) -> torch.Tensor:
    """Round half to even; a complex value's parts each."""
    if a.is_complex():
        return torch.complex(torch.round(a.real), torch.round(a.imag))
    return torch.round(a)


def rint(x, out=None) -> DNDarray:
    """Round half to even to an integral value, in a floating type."""
    return _operations.__local_op(_rint, x, out)


def trunc(x, out=None) -> DNDarray:
    """Round toward zero."""
    _operations._refuse_complex("trunc", TypeError, x)
    return _operations.__local_op(torch.trunc, x, out)


fix = trunc


def _sgn(a: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.bool:
        raise TypeError("sign does not accept dtype bool")
    return torch.sgn(a)


def sgn(x, out=None) -> DNDarray:
    """The sign: -1, 0 or 1, and ``z / |z|`` for complex values."""
    return _operations.__local_op(_sgn, x, out, no_cast=True, widened=_unsigned_sign)


def _sign_real(a: torch.Tensor) -> torch.Tensor:
    if a.is_complex():
        return torch.sign(a.real).to(a.dtype)
    return _sgn(a)


def sign(x, out=None) -> DNDarray:
    """The sign; of complex values the sign of the real part."""
    return _operations.__local_op(_sign_real, x, out, no_cast=True, widened=_unsigned_sign)
